"""The serving cells: the system's HTTP server (``serve_cli.build_server``
with the configuration's settings, its top shape made warm as the serve
CLI does), driven over 127.0.0.1 by ``clients.py`` in a process of its
own; then the correctness check on a sample of the replies.

End-to-end metrics: ``serve_utt_per_s`` (valid replies that ended inside
the window / its seconds) and ``setup_s`` (process start to the window's
opening)."""

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import programs, result
from benchmark.harness.cell import BENCH_DIR
from benchmark.harness.trace import Window


def build(cell, work, device):
    from fastspeech2_tpu_torch.cli import serve_cli

    cfg = cell.config
    pre, model, train = programs.write_yaml_configs(cfg, work, cell.root)
    s = cfg["serve"]
    argv = ["-p", pre, "-m", model, "-t", train, "--port", "0",
            "--max_batch_size", str(s["max_batch_size"]),
            "--max_wait_ms", str(s["max_wait_ms"]),
            "--max_pending", str(s["max_pending"]),
            "--device", device.type]
    root = cell.root
    w = cfg["weights"]
    if "acoustic_npz" in w:
        argv += ["--weights_npz", os.path.join(root, w["acoustic_npz"]),
                 "--vocoder_ckpt", os.path.join(root, w["vocoder_npz"])]
    else:
        argv += ["--torch_ckpt", os.path.join(work, "acoustic.pth.tar"),
                 "--vocoder_ckpt", os.path.join(work, "vocoder.pth.tar")]
    args = serve_cli.build_parser().parse_args(argv)
    server = serve_cli.build_server(args)
    server.batcher.warmup(grid=s["warmup_grid"], log=lambda *_: None)
    return server


def seeded_weights(cell, seed, device, work):
    """For a configuration whose weights come from the seed: draw them on
    the device, write them where the server's loaders read them, and
    return them for the reference."""
    from benchmark.reference import fs2, vocoder

    cfg = cell.config
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    acoustic = fs2.init_params(cfg["arch"], g, device)
    voc = vocoder.init_params(cfg["vocoder"], cfg["arch"]["n_mel_channels"],
                              g, device)
    sd = {k: v.cpu() for k, v in acoustic.items()}
    for i in range(cfg["arch"]["postnet_n_convolutions"]):
        sd[f"postnet.convolutions.{i}.1.num_batches_tracked"] = \
            torch.zeros((), dtype=torch.long)
    torch.save({"model": sd}, os.path.join(work, "acoustic.pth.tar"))
    gen_cfg = dict(cfg["vocoder"], num_mels=cfg["arch"]["n_mel_channels"])
    torch.save({"generator": {k: v.cpu() for k, v in voc.items()},
                "generator_config": gen_cfg},
               os.path.join(work, "vocoder.pth.tar"))
    return acoustic, voc


def run(cell, seed, seconds, trace, device, t_start, hooks=None):
    """One run of a serving cell -> its result (run.py prints it).
    ``hooks["after_build"](server)``: a test's way to break the timed path
    underneath."""
    work = tempfile.mkdtemp(prefix="fs2bench_serve_")
    try:
        return _run(cell, seed, seconds, trace, device, t_start, work,
                    hooks or {})
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, t_start, work, hooks):
    cfg, traffic = cell.config, cell.traffic
    seeded = None
    if "acoustic_npz" not in cfg["weights"]:
        seeded = seeded_weights(cell, seed, device, work)
    server = build(cell, work, device)
    syn = server.batcher.synthesizer
    rec = programs.DispatchRecorder(syn)
    if "after_build" in hooks:
        hooks["after_build"](server)
    server.start()
    lexicon = os.path.join(cell.root, cfg["preprocess"]["path"][
        "lexicon_path"])
    spec = {"port": server.port, "seed": int(seed), "seconds": seconds,
            "load": traffic["load"], "texts": traffic["texts"],
            "lexicon": lexicon, "n_texts": traffic["n_texts"],
            "sample_share": traffic["sample_share"],
            "out_dir": os.path.join(work, "clients")}
    with open(os.path.join(work, "clients.json"), "w") as f:
        json.dump(spec, f)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(BENCH_DIR, "harness", "clients.py"),
         os.path.join(work, "clients.json")], stdout=subprocess.PIPE,
        stdin=subprocess.PIPE, text=True, cwd=cell.root)
    window = Window(device) if trace else None
    stats = {}
    setup_s = None
    try:
        for line in proc.stdout:
            word = line.split()[0] if line.strip() else ""
            if word == "READY":
                if trace:
                    window.start()
                proc.stdin.write("GO\n")
                proc.stdin.flush()
            elif word == "WINDOW":
                setup_s = time.monotonic() - t_start
                stats["before"] = server.batcher.stats()
            elif word == "END":
                if trace:
                    window.stop()
                stats["after"] = server.batcher.stats()
                stats["t_end"] = time.monotonic()
            elif word == "DONE":
                break
        proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0 or setup_s is None:
        raise RuntimeError(f"the load generator exited with "
                           f"{proc.returncode}")
    with open(os.path.join(spec["out_dir"], "records.json")) as f:
        summary = json.load(f)
    with np.load(os.path.join(spec["out_dir"], "sample.npz")) as z:
        kept = {int(k): z[k] for k in z.files}
    device_info = result.device_info(device)
    trace_out = window.reduce() if trace else None
    rec.restore()
    server.stop()
    records, dispatches = rec.records, rec.dispatches
    del server, syn, rec
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()

    t0, t1 = summary["t0"], summary["t1"]
    reqs = summary["records"]
    attempted = len(reqs)
    done = [r for r in reqs if r["ok"] and r["t_done"] <= t1]
    failed = sum(1 for r in reqs if not r["ok"])

    checks, correct = check(cell, seed, reqs, kept, summary["longest"],
                            records, failed, device, seeded)

    ctx = {"cell": cell, "seed": seed, "t0": t0, "t1": t1, "stats": stats,
           "done": done, "reqs": reqs, "dispatches": dispatches,
           "trace": trace_out}
    metrics = {}
    for m in cell.metrics(trace):
        if not trace:
            value = end_to_end(m["name"], ctx, setup_s)
        else:
            value = cell.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        device_info["busy_s"] = trace_out["busy_s"]
        device_info["window_s"] = trace_out["window_s"]
    return dict(correct=correct, attempted=attempted, failed=failed,
                metrics=metrics, device=device_info, checks=checks,
                breakdown=trace_out["breakdown"] if trace else None)


def end_to_end(name, ctx, setup_s):
    if name == "setup_s":
        return setup_s
    if name == "serve_utt_per_s":
        return len(ctx["done"]) / (ctx["t1"] - ctx["t0"])
    raise KeyError(name)


def check(cell, seed, reqs, kept, longest, records, failed, device,
          seeded):
    """Draw the sample from the seed (the longest reply always in it) and
    compare it with the reference."""
    from benchmark.reference import frontend, weights
    from benchmark.reference.serve_check import Checker, summarise
    from benchmark.harness.texts import TextGen

    cfg, traffic = cell.config, cell.traffic
    ok = {r["id"]: r for r in reqs if r["ok"] and r["id"] in kept}
    ids = sorted(ok)
    rng = np.random.default_rng([int(seed), 9])
    n = min(traffic["sample"], len(ids))
    chosen = set(int(i) for i in rng.choice(ids, size=n, replace=False)) \
        if ids else set()
    if longest is not None and longest in ok:
        chosen.add(int(longest))
    gen = TextGen(traffic["texts"], os.path.join(
        cell.root, cfg["preprocess"]["path"]["lexicon_path"]), seed)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        if seeded is not None:
            acoustic, voc = seeded
        else:
            acoustic = weights.acoustic(os.path.join(
                cell.root, cfg["weights"]["acoustic_npz"]), cfg["arch"],
                device)
            voc = weights.vocoder(os.path.join(
                cell.root, cfg["weights"]["vocoder_npz"]), cfg["vocoder"],
                device)
        lex = frontend.read_lexicon(os.path.join(
            cell.root, cfg["preprocess"]["path"]["lexicon_path"]))
        checker = Checker(acoustic, cfg["arch"], voc, cfg["vocoder"], lex,
                          cfg["audio"])
        results = [checker.request(gen.text(i), kept[i],
                                   records, device) for i in sorted(chosen)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return summarise(results, failed, traffic["limits"])
