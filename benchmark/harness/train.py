"""The training cell: the system's scan-mode step as
``training/loop.py::_train_scanned`` drives it (``train_loader`` ->
``scan.gather_epoch`` -> ``stack_group`` -> ``make_scanned_train_step`` ->
the dispatches of ``scan.Schedule``, the losses read back at each
dispatch's end), on the configuration's synthetic corpus (written once a
checkout, ``corpus.cached``), from fresh weights drawn on the device from
the seed.

``train()`` offers no hook that opens a window after the last capture, so
the harness composes those calls.  Set-up: the corpus, the stacks, one real
step of each shape group in group order, step g on group g's first batch
(its warm-up and CUDA graph capture), then the weights, the optimizer
state and the BatchNorm statistics put back to the initial ones in place
(the graphs keep their addresses), then the same steps again, now each a
replay of its group's graph, which the reference follows: every graph
the window replays is compared.  The window goes on with the schedule's
dispatches from the step after them.

End-to-end: ``train_frames_per_s`` (the real mel frames of every step
issued in the window / the window's seconds, the device synchronised at
both ends) and ``setup_s``.  A traced run profiles a sample spread over
the window: in every dispatch, the ``trace_steps`` steps from its
``trace_at``-th (the traffic file's), the device synchronised at both ends
of each span (a second of these steps is some 3,500 device events, whose
collection takes longer than the steps); its per-layer metrics are of
the steps issued inside the spans.
"""

import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import corpus, flops, programs, result
from benchmark.harness.trace import Window


def _steps(plan, K, step):
    """(group, batch index, step, place in its dispatch, last of its
    dispatch) for ever, from ``step``."""
    while True:
        gi, idx = plan.draw(K)
        for j, i in enumerate(idx):
            yield gi, int(i), step, j, j == len(idx) - 1
            step += 1


def run(cell, seed, seconds, trace, device, t_start, hooks=None):
    """One run of a training cell -> its result (run.py prints it).
    ``hooks["after_build"](model, optimizer, scanned)``: a test's way to
    break the timed path underneath."""
    work = tempfile.mkdtemp(prefix="fs2bench_train_")
    try:
        return _run(cell, seed, seconds, trace, device, t_start, work,
                    hooks or {})
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, t_start, work, hooks):
    from fastspeech2_tpu_torch.configs.config import (
        FastSpeech2Config, OptimConfig, StepConfig, load_yaml_configs)
    from fastspeech2_tpu_torch.parallel.mesh import SINGLE
    from fastspeech2_tpu_torch.training import loop, scan
    from fastspeech2_tpu_torch.training import step as steps_mod

    from benchmark.reference import fs2

    phases, last = {}, [t_start]

    def mark(name):
        now = time.monotonic()
        phases[name] = now - last[0]
        last[0] = now

    mark("start")
    cfg = cell.config
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg["dtype"]]
    pre_path, model_path, train_path = programs.write_yaml_configs(
        cfg, work, cell.root)
    pp, mc, tc = load_yaml_configs(pre_path, model_path, train_path)
    corpus_dir = pp["path"]["preprocessed_path"]
    audio = cfg["audio"]
    corpus.link(corpus.cached(cell.root, cfg["corpus"], cfg["stats"],
                              cfg["arch"]["n_mel_channels"],
                              audio["sampling_rate"], audio["hop_length"]),
                corpus_dir)
    mark("corpus")

    fcfg = FastSpeech2Config.build(pp, mc)
    ocfg = OptimConfig.build(tc)
    st = StepConfig.build(tc)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    w0 = fs2.init_params(cfg["arch"], g, device)
    state = dict(w0)
    for i in range(cfg["arch"]["postnet_n_convolutions"]):
        state[f"postnet.convolutions.{i}.1.num_batches_tracked"] = \
            torch.zeros((), dtype=torch.long)
    model, optimizer = loop.build_training(fcfg, ocfg, device, dtype=dtype,
                                           state=state)
    model.train()
    mark("build")
    acc = ocfg.grad_acc_step
    mel_bf16 = bool(tc.get("transfer", {}).get("mel_bf16", False))
    budget = int(float(tc["step"].get("scan_hbm_budget_mb", 8192)) * 2 ** 20)
    K = scan.dispatch_steps(int(tc["step"]["scan_step"]),
                            (st.log_step, st.synth_step, st.val_step,
                             st.save_step), st.total_step)
    loader = loop.train_loader(pp, tc, fcfg, ocfg.batch_size)
    groups = scan.gather_epoch(loader.epoch(0), budget, mel_bf16)
    if groups is None or K <= 1:
        raise RuntimeError("the configuration does not run in scan mode")
    mark("gather")
    stacks = [loop.stack_group(b, SINGLE, acc, device, mel_bf16)
              for b in groups]
    mark("stack")
    frames = [np.array([int(b["mel_lens"].sum()) for b in grp])
              for grp in groups]
    arch = cfg["arch"]
    # each batch's model FLOPs (3 x the forward) and K1 + K3 least time,
    # at its rows' real lengths
    work_of = [[(3 * sum(flops.acoustic_flops(int(a), int(t), arch)
                         for a, t in zip(b["src_lens"], b["mel_lens"])),
                 flops.train_attention_bound_s(b["src_lens"], b["mel_lens"],
                                               arch, cfg["dtype"]))
                for b in grp] for grp in groups]
    del groups
    mark("work_of")
    scanned = steps_mod.make_scanned_train_step(model, optimizer, acc)
    if "after_build" in hooks:
        hooks["after_build"](model, optimizer, scanned)
    for gi in range(len(stacks)):
        scanned(gi, stacks[gi], 0, gi)
    capture_s = scanned.capture_seconds
    mark("capture")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w0[name])
        for name, b in model.named_buffers():
            if name in w0:
                b.copy_(w0[name])
    optimizer.load_state_dict({"count": 0,
                               "mu": [torch.zeros_like(m)
                                      for m in optimizer.mu],
                               "nu": [torch.zeros_like(n)
                                      for n in optimizer.nu]})
    names = [n for n, _ in model.named_parameters()]
    n_checked = len(stacks)
    sys_losses, first_moment = [], None
    for gi in range(n_checked):
        losses = scanned(gi, stacks[gi], 0, gi)
        sys_losses.append(float(losses.total))
        if first_moment is None:
            first_moment = {n: m.detach().float().clone()
                            for n, m in zip(names, optimizer.mu)}
    after = {n: p.detach().float().clone()
             for n, p in model.named_parameters()}

    it = _steps(scan.Schedule([len(f) for f in frames], 0), K, n_checked)
    window = Window(device) if trace else None
    trace_at = int(cell.traffic.get("trace_at", 0))
    trace_steps = int(cell.traffic.get("trace_steps", K))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    mark("checked")
    t0 = time.monotonic()
    setup_s = t0 - t_start
    done_frames, done_steps = 0, 0
    traced_flops = traced_bound = 0.0
    while True:
        gi, i, step, j, last = next(it)
        if window is not None and j == trace_at:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            window.start()
        losses = scanned(gi, stacks[gi], i, step)
        done_frames += int(frames[gi][i])
        done_steps += 1
        if window is not None and window.open:
            traced_flops += work_of[gi][i][0]
            traced_bound += work_of[gi][i][1]
            if j == trace_at + trace_steps - 1 or last:
                window.stop()
        if last:
            torch.stack(list(losses)).tolist()
        if time.monotonic() - t0 >= seconds:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.monotonic()
    if window is not None and window.open:
        window.stop()
    device_info = result.device_info(device)
    t_red = time.monotonic()
    trace_out = window.reduce() if trace else None
    trace_s = {"stop": window.stop_s, "reduce": time.monotonic() - t_red} \
        if trace else None

    sys_change = {n: after[n] - w0[n] for n in names}
    sys_grad = {n: first_moment[n] / (1.0 - ocfg.betas[0]) for n in names}
    del model, optimizer, scanned, stacks, after, first_moment
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    checks, correct, compared = check(cell, corpus_dir, w0, sys_losses,
                                      sys_grad, sys_change, device)
    check_s = time.monotonic() - t_check

    ctx = {"cell": cell, "seed": seed, "trace": trace_out,
           "flops": traced_flops, "attn_bound_s": traced_bound,
           "capture_s": capture_s, "steps": done_steps}
    metrics = {}
    for m in cell.metrics(trace):
        if trace:
            value = cell.reader(m["name"])(ctx)
        elif m["name"] == "setup_s":
            value = setup_s
        elif m["name"] == "train_frames_per_s":
            value = done_frames / (t1 - t0)
        else:
            raise KeyError(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        device_info["busy_s"] = trace_out["busy_s"]
        device_info["window_s"] = trace_out["window_s"]
    return dict(correct=correct, attempted=done_steps + n_checked, failed=0,
                metrics=metrics, device=device_info, checks=checks,
                breakdown=trace_out["breakdown"] if trace else None,
                notes={"compared": compared, "capture_s": capture_s,
                       "checked_steps": n_checked, "check_s": check_s,
                       "setup_phases": phases,
                       "trace_s": trace_s,
                       "trace_spans": trace_out["spans"] if trace else None})


def check(cell, corpus_dir, w0, sys_losses, sys_grad, sys_change, device,
          quant=None):
    from benchmark.reference import batches, train_check

    cfg = cell.config
    o = cfg["train"]["optimizer"]
    b = cfg["train"].get("bucket", {})
    loader = {"batch_size": o["batch_size"], "group_size": 4,
              "text_bucket": b.get("text", 32), "mel_bucket": b.get("mel", 160),
              "max_mel_len": cfg["arch"]["max_seq_len"]}
    first = batches.group_firsts(corpus_dir, loader)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref_losses, ref_grad, ref_params = train_check.reference_steps(
            w0, cfg["arch"], o, first, device, quant)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    ref_change = {n: ref_params[n] - w0[n] for n in ref_params}
    return train_check.compare(
        sys_losses, train_check.norms(sys_grad), train_check.norms(sys_change),
        ref_losses, train_check.norms(ref_grad), train_check.norms(ref_change),
        cell.traffic["limits"])
