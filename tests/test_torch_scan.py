"""PyTorch port, acoustic scan mode (train.yaml ``step.scan_step`` > 1)
against the JAX package's scanned path
(``fastspeech2_tpu/training/loop.py::_train_scanned``), on the CPU.

One module-scoped fixture runs the JAX ``train()`` on a tiny synthetic
corpus whose buckets give two shape groups (5 and 2 batches of 4), with
its compiled steps replaced by recorders through the loop module's
``cached_jit`` (nothing in ``fastspeech2_tpu/`` changes): the scan records
the batch each scanned step indexes, the per-step path's step and the
validation step return zero losses, and the synth duty records the batch
it is given.  The port trains for real, with dropout on, and records the
batch of each ``train_step``.  The schedule must match step for step, a
resume at step 4 included, and so must the duty lines and the duties'
batches; both fallbacks log the JAX package's lines.  A scan-mode run
must equal ``train_step`` over its schedule bit for bit (the per-step
tests hold ``train_step`` against JAX).
"""

import os

import numpy as np
import pytest
import torch
import yaml

import fastspeech2_tpu.training.loop as jax_loop
from fastspeech2_tpu.configs.config import StepConfig as JaxStepConfig
from fastspeech2_tpu.data import dataset as jax_dataset
from fastspeech2_tpu.training.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from fastspeech2_tpu.utils.jit_cache import cached_jit
from fastspeech2_tpu_torch.configs.config import FastSpeech2Config
from fastspeech2_tpu_torch.data.synthetic import (
    generate_corpus,
    synthetic_preprocess_config,
)
from fastspeech2_tpu_torch.training import loop, scan
from fastspeech2_tpu_torch.training.checkpoint import latest_step
from fastspeech2_tpu_torch.training.step import BATCH_KEYS, batch_to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "LJSpeech10")

# K = gcd(scan 4, log 4, synth 2, val 6) = 2 (save 12 is not below total
# 12): 6 dispatches, the 2-batch group passed over twice
SCAN = dict(scan_step=4, total_step=12, log_step=4, synth_step=2,
            val_step=6, save_step=12)
K = 2
DUTY_PREFIXES = ("Step ", "Validation Step ", "Saved checkpoint at step ",
                 "scan mode: ", "scan mode disabled", "scan_step ")


def _configs(root, **step):
    """(preprocess, model, train) dicts: a tiny model from
    config/LJSpeech10 and 28 training utterances at batch 4 in buckets of
    (text 8, mel 32) -> groups of 5 and 2 batches."""
    corpus = os.path.join(root, "corpus")
    if not os.path.isdir(corpus):
        generate_corpus(corpus, n_utterances=32, seed=3, val_size=4,
                        n_mels=8)
    with open(f"{CONFIG}/model.yaml") as f:
        model_cfg = yaml.safe_load(f)
    model_cfg["transformer"].update(encoder_layer=1, decoder_layer=1,
                                    encoder_hidden=16, decoder_hidden=16,
                                    conv_filter_size=32)
    model_cfg["variance_predictor"]["filter_size"] = 16
    model_cfg["variance_embedding"]["n_bins"] = 16
    model_cfg["max_seq_len"] = 64
    model_cfg["postnet"] = {"embedding_dim": 16, "kernel_size": 5,
                            "n_convolutions": 3}
    model_cfg["vocoder"]["model"] = "none"
    with open(f"{CONFIG}/train.yaml") as f:
        train_cfg = yaml.safe_load(f)
    train_cfg["path"] = {k: os.path.join(root, k) for k in
                         ("ckpt_path", "log_path", "result_path")}
    train_cfg["optimizer"]["batch_size"] = 4
    train_cfg["step"].update(step)
    train_cfg["bucket"] = {"text": 8, "mel": 32}
    return synthetic_preprocess_config(corpus, n_mels=8), model_cfg, train_cfg


def _duty_lines(lines):
    return [ln.split(",")[0] for ln in lines if ln.startswith(DUTY_PREFIXES)]


def _host(batch):
    return {k: np.array(batch[k]) for k in BATCH_KEYS}


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in BATCH_KEYS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i} {k}")


def _jax_run(configs, restore_step=0):
    """The JAX train() with recorders for its compiled steps -> {"batches":
    each scanned step's batch, "synth": the synth duty's batches' ids,
    "log": its lines}."""
    rec = {"batches": [], "synth": [], "log": []}

    def scanned(state, stacked, idx, rng):
        host = {k: np.asarray(v) for k, v in stacked.items()}
        rec["batches"] += [{k: host[k][int(i)] for k in BATCH_KEYS}
                           for i in np.asarray(idx)]
        return state, tuple(np.zeros(len(idx), np.float32)
                            for _ in range(6))

    def fake_jit(key, make):
        if key[0] == "scanned_train_step":
            return scanned
        if key[0] == "train_step":
            return lambda state, batch, rng: (state, (0.0,) * 6)
        if key[0] == "eval_step":
            return lambda state, batch, n: (0.0,) * 6
        return cached_jit(key, make)

    def synth(model, cfg, state, batch, *a, **k):
        rec["synth"].append(list(batch["ids"]))
        raise RuntimeError("recorded")

    pre, model_cfg, train_cfg = configs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "cached_jit", fake_jit)
        mp.setattr(jax_loop, "synth_one_sample", synth)
        if restore_step:
            state = jax_loop.init_training(pre, model_cfg, train_cfg)[3]
            jax_save_checkpoint(train_cfg["path"]["ckpt_path"], state,
                                restore_step)
        jax_loop.train(pre, model_cfg, train_cfg, restore_step=restore_step,
                       log=rec["log"].append)
    return rec


def _port_run(configs, restore_step=0):
    """The port's train() on the CPU -> {"batches": each train_step's batch,
    "steps": its step argument, "losses", "synth": the synth duty's
    batches' ids, "log", "model", "optimizer", "step"}."""
    rec = {"batches": [], "steps": [], "losses": [], "synth": [], "log": []}
    inner = loop.train_step

    def recorded(model, optimizer, batch, step, grad_acc_step=1):
        rec["batches"].append({k: v.numpy().copy() for k, v in batch.items()})
        rec["steps"].append(step)
        losses = inner(model, optimizer, batch, step, grad_acc_step)
        rec["losses"].append(torch.stack(list(losses)))
        return losses

    def synth(model, batch, *a, **k):
        rec["synth"].append(list(batch["ids"]))
        return None, None, None

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "train_step", recorded)
        mp.setattr(loop, "synth_one_sample", synth)
        model, opt, step = loop.train(*configs, restore_step=restore_step,
                                      device="cpu", log=rec["log"].append)
    rec.update(model=model, optimizer=opt, step=step)
    return rec


def _jax_fallback_line(configs):
    """The line the JAX package's _train_scanned logs before it hands the
    run back to the per-step path (it returns before its first jit)."""
    pre, _, train_cfg = configs
    steps = JaxStepConfig.build(train_cfg)
    loader = jax_dataset.BucketedLoader(
        jax_dataset.FeatureDataset("train.txt", pre), batch_size=4,
        group_size=4, shuffle=True, drop_last=True, max_mel_len=64,
        text_bucket=8, mel_bucket=32)
    budget = int(float(train_cfg["step"]["scan_hbm_budget_mb"]) * 2 ** 20)
    lines = []
    _, step = jax_loop._train_scanned(
        train_cfg["step"]["scan_step"], None, 0, steps.total_step, steps,
        loader, jax_loop._model_batch, 1, None, None, None, None, None, None,
        None, None, None, None, lines.append, hbm_budget_bytes=budget)
    assert step == 0 and len(lines) == 1
    return lines[0]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread, as tests/test_torch_parallel.py runs: the tiny
    model's ops run faster without a pool beside JAX's and orbax's
    threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages on the scan schedule from step 0 and from step 4; the
    port on both fallbacks beside the JAX package's line."""
    root = tmp_path_factory.mktemp("scan")

    def configs(name, **step):
        pre, model_cfg, train_cfg = _configs(str(root), **step)
        train_cfg["path"] = {k: str(root / name / k) for k in
                             ("ckpt_path", "log_path", "result_path")}
        return pre, model_cfg, train_cfg

    out = {}
    for name, start in (("scan", 0), ("resume", 4)):
        port_cfgs = configs("port_" + name, **SCAN)
        if start:
            # the schedule depends on the step alone, not the weights
            loop.save_training_state(port_cfgs[2]["path"]["ckpt_path"],
                                     out["scan"]["port"]["model"],
                                     out["scan"]["port"]["optimizer"], start)
        out[name] = {"jax": _jax_run(configs("jax_" + name, **SCAN), start),
                     "port": _port_run(port_cfgs, start),
                     "configs": port_cfgs}
    fallbacks = {
        # log_step 1: K = 1
        "incompatible": dict(SCAN, total_step=4, log_step=1, val_step=2,
                             save_step=2, synth_step=1000,
                             scan_hbm_budget_mb=8192),
        # K = 2, the epoch over a budget of ~1 KiB
        "budget": dict(SCAN, total_step=4, log_step=2, val_step=4,
                       save_step=4, synth_step=1000,
                       scan_hbm_budget_mb=0.001)}
    for name, step in fallbacks.items():
        port_cfgs = configs("port_" + name, **step)
        out[name] = {"jax_line": _jax_fallback_line(port_cfgs),
                     "port": _port_run(port_cfgs), "configs": port_cfgs}
    return out


@pytest.mark.parametrize("case", ["scan", "resume"])
def test_schedule_matches_jax_step_for_step(runs, case):
    """Every step trains on the batch the JAX scan indexes, the step
    arguments run on from the start, and the duties come at the same
    steps with the same batches (the group's first batch, g["raw0"], at
    each synth duty, and the validation sample)."""
    jax_rec, port = runs[case]["jax"], runs[case]["port"]
    start = 4 if case == "resume" else 0
    assert len(jax_rec["batches"]) == 12 - start
    _assert_batches_equal(port["batches"], jax_rec["batches"])
    assert port["steps"] == list(range(start, 12))
    assert port["step"] == 12
    assert _duty_lines(port["log"]) == _duty_lines(jax_rec["log"])
    assert port["synth"] == jax_rec["synth"]
    # a synth duty a dispatch, and the validation samples at 6 and 12
    assert len(port["synth"]) == (12 - start) // K + 2
    assert f"{K} steps/dispatch" in " ".join(port["log"])


def test_schedule_groups_and_reshuffles(runs):
    """The corpus gives two shape groups, one of 5 batches and one of 2,
    and each group's stream is passed over more than once, so the credit
    schedule and the reshuffles are both exercised; the schedule of the
    port's plain function is the run's."""
    pre, model_cfg, train_cfg = runs["scan"]["configs"]
    cfg = FastSpeech2Config.build(pre, model_cfg)
    groups = scan.gather_epoch(loop.train_loader(pre, train_cfg, cfg, 4)
                               .epoch(0), 1 << 40)
    assert [len(g) for g in groups] == [5, 2]
    plan = scan.schedule([5, 2], K, 0, 12)
    want = [groups[gi][int(i)] for gi, idx in plan for i in idx]
    _assert_batches_equal(runs["scan"]["port"]["batches"],
                          [_host(b) for b in want])
    drawn = np.bincount([gi for gi, _ in plan]) * K
    assert drawn[0] > 5 and drawn[1] > 2
    assert scan.dispatch_steps(500, (500, 10 ** 6, 10 ** 6, 10000),
                               100000) == 500   # config/LJSpeech10
    assert scan.dispatch_steps(4, (1, 4, 4, 4), 12) == 1


def test_scan_loop_end_to_end(runs):
    """tests/test_e2e.py::test_training_loop_scan_mode on the port: 12
    steps, the checkpoint of step 12, the last loss line in log.txt, the
    validation at step 6, the scan line and the stacks' bytes."""
    run = runs["scan"]["port"]
    train_cfg = runs["scan"]["configs"][2]
    assert run["step"] == 12
    assert os.path.exists(os.path.join(train_cfg["path"]["ckpt_path"],
                                       "12.pth.tar"))
    content = open(os.path.join(train_cfg["path"]["log_path"], "train",
                                "log.txt")).read()
    assert "Step 12/12" in content
    assert any(ln.startswith("Validation Step 6") for ln in run["log"])
    assert "scan mode: 7 batches in 2 shape group(s) device-resident, " \
        "2 steps/dispatch" in run["log"]
    # the stacks are the 7 batches as batch_to_device puts them
    pre, model_cfg, train_cfg = runs["scan"]["configs"]
    cfg = FastSpeech2Config.build(pre, model_cfg)
    nbytes = sum(t.numel() * t.element_size()
                 for b in loop.train_loader(pre, train_cfg, cfg, 4).epoch(0)
                 for t in batch_to_device(b, "cpu").values())
    assert f"scan mode stacks: {nbytes} bytes on cpu" in run["log"]


@pytest.mark.parametrize("case", ["incompatible", "budget"])
def test_fallbacks_log_the_jax_line_and_step(runs, case):
    """K <= 1 and an epoch over step.scan_hbm_budget_mb: the JAX package's
    line, then the per-step path to total_step with its duties and
    checkpoints."""
    port = runs[case]["port"]
    assert runs[case]["jax_line"] in port["log"]
    assert runs[case]["jax_line"] == (
        scan.INCOMPATIBLE_LINE if case == "incompatible"
        else scan.budget_line(int(0.001 * 2 ** 20)))
    assert not any(ln.startswith("scan mode: ") for ln in port["log"])
    steps = (1, 2, 3, 4) if case == "incompatible" else (2, 4)
    assert [ln.split(",")[0] for ln in port["log"]
            if ln.startswith("Step ")] == [f"Step {i}/4" for i in steps]
    assert port["step"] == 4 and port["steps"] == [0, 1, 2, 3]
    ckpt = runs[case]["configs"][2]["path"]["ckpt_path"]
    assert latest_step(ckpt) == 4
    assert sorted(os.listdir(ckpt)) == (
        ["2.pth.tar", "4.pth.tar"] if case == "incompatible"
        else ["4.pth.tar"])


def test_scan_equals_train_step_over_its_schedule(runs):
    """From the same seed, train_step on the schedule's batches, each
    copied from the host, with the same step values: every step's losses
    and every parameter and buffer bit for bit (dropout on)."""
    pre, model_cfg, train_cfg = runs["scan"]["configs"]
    run = runs["scan"]["port"]
    model, cfg, optim_cfg, opt = loop.init_training(pre, model_cfg,
                                                    train_cfg, device="cpu")
    model.train()
    groups = scan.gather_epoch(loop.train_loader(
        pre, train_cfg, cfg, optim_cfg.batch_size).epoch(0), 1 << 40)
    step = 0
    for gi, idx in scan.schedule([len(g) for g in groups], K, 0, 12):
        for i in idx:
            losses = loop.train_step(
                model, opt, batch_to_device(groups[gi][int(i)], "cpu"), step)
            assert torch.equal(torch.stack(list(losses)),
                               run["losses"][step]), step
            step += 1
    assert step == 12
    got = run["model"].state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k
    assert opt.count == run["optimizer"].count == 12


def test_scan_stacks_take_the_per_step_dtypes(runs):
    """The device stacks hold batch_to_device's dtypes, with mel_bf16 the
    mels as bfloat16, and this rank's rows of each batch."""
    from fastspeech2_tpu_torch.parallel.mesh import Mesh

    pre, model_cfg, train_cfg = runs["scan"]["configs"]
    cfg = FastSpeech2Config.build(pre, model_cfg)
    group = scan.gather_epoch(loop.train_loader(pre, train_cfg, cfg, 4)
                              .epoch(0), 1 << 40)[1]
    for mel_bf16 in (False, True):
        stack = loop.stack_group(group, Mesh(1, 1), 1, "cpu", mel_bf16)
        for i, batch in enumerate(group):
            want = batch_to_device(batch, "cpu", mel_bf16)
            for k in BATCH_KEYS:
                assert stack[k][i].dtype == want[k].dtype
                assert torch.equal(stack[k][i], want[k]), k
    rows = loop.stack_group(group, Mesh(2, 1, data_rank=1), 2, "cpu")
    assert rows["texts"].shape[:2] == (2, 2)
    np.testing.assert_array_equal(rows["texts"][0].numpy(),
                                  group[0]["texts"][[1, 3]])
    budget = sum(scan.host_bytes(b) for b in group)
    assert scan.gather_epoch(iter(group), budget) is not None
    assert scan.gather_epoch(iter(group), budget - 1) is None
    assert scan.host_bytes(group[0], True) == scan.host_bytes(group[0]) - \
        group[0]["mels"].size * 2
