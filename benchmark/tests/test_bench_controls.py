"""The controls of the correctness checks, on the card at the cells' own
sizes (marker ``cuda``; they skip without a card):

- serving: the system's own bfloat16 path (the acoustic model at
  ``dtype=bfloat16``, as ``--dtype bfloat16`` builds it) on the cell's
  texts in dispatches of 16, judged by the cell's comparison and limits,
  has to come out not correct;
- training: the reference computed as FP8 training computes, every
  product's operands rounded to float8 e4m3 and their gradients to e5m2
  (per-tensor scales), in the system's place, has to come out not correct;
- training faults at the cell's size: half of each batch left out (the
  mean taken over the rest) has to come out not correct.

Each prints the numbers it compared, on three seeds:

    python -m pytest benchmark/tests/test_bench_controls.py -q -s -m cuda
"""

import os
import tempfile

import pytest
import torch

SEEDS = (5100000001, 5100000002, 5100000003)


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _round(t, dtype, top):
    """``t`` rounded to ``dtype`` at a per-tensor scale that puts its
    largest |value| at ``top``, back in float32."""
    amax = t.abs().max()
    if not torch.isfinite(amax) or amax == 0:
        return t
    scale = amax / top
    return (t / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """FP8 training's rounding of a product's operand: e4m3 forward, its
    gradient e5m2 backward, each at a per-tensor scale."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8(t):
    return _Fp8.apply(t)


def serve_control(seed, device, cell_name, n_texts=64):
    from fastspeech2_tpu_torch.cli.synthesize_cli import (
        load_model_for_inference)
    from fastspeech2_tpu_torch.configs.config import load_yaml_configs
    from fastspeech2_tpu_torch.synthesis.pipeline import Synthesizer
    from fastspeech2_tpu_torch.synthesis.vocoder import get_vocoder

    from benchmark.harness import programs
    from benchmark.harness.cell import Cell
    from benchmark.harness.texts import TextGen
    from benchmark.reference import frontend, weights
    from benchmark.reference.serve_check import Checker, summarise

    cell = Cell.load(cell_name)
    cfg, root = cell.config, cell.root
    work = tempfile.mkdtemp(prefix="fs2bench_control_")
    pre, model_yaml, train = programs.write_yaml_configs(cfg, work, root)
    pp, mc, tc = load_yaml_configs(pre, model_yaml, train)
    model, fcfg = load_model_for_inference(
        pp, mc, os.path.join(root, cfg["weights"]["acoustic_npz"]), device,
        dtype=torch.bfloat16)
    vocoder = get_vocoder(mc, pp, os.path.join(
        root, cfg["weights"]["vocoder_npz"]), device)
    syn = Synthesizer(model, fcfg, pp, device, vocoder=vocoder)
    rec = programs.DispatchRecorder(syn)
    lex_path = os.path.join(root, cfg["preprocess"]["path"]["lexicon_path"])
    texts = TextGen(cell.traffic["texts"], lex_path, seed).texts(n_texts)
    served = {}
    for i in range(0, len(texts), 16):
        for t, w in zip(texts[i:i + 16], syn.synthesize(texts[i:i + 16])[0]):
            served[t] = w
    del syn, model, vocoder
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checker = Checker(
        weights.acoustic(os.path.join(root, cfg["weights"]["acoustic_npz"]),
                         cfg["arch"], device),
        cfg["arch"],
        weights.vocoder(os.path.join(root, cfg["weights"]["vocoder_npz"]),
                        cfg["vocoder"], device),
        cfg["vocoder"], frontend.read_lexicon(lex_path), cfg["audio"])
    results = [checker.request(t, served[t], rec.records, device)
               for t in texts]
    return summarise(results, 0, cell.traffic["limits"])


def train_control(seed, device):
    from benchmark.harness import corpus
    from benchmark.harness.cell import Cell
    from benchmark.reference import batches, fs2, train_check

    cell = Cell.load("train_lj_scan_bf16")
    cfg = cell.config
    work = corpus.cached(cell.root, cfg["corpus"], cfg["stats"],
                         cfg["arch"]["n_mel_channels"],
                         cfg["audio"]["sampling_rate"],
                         cfg["audio"]["hop_length"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    w0 = fs2.init_params(cfg["arch"], g, device)
    o = cfg["train"]["optimizer"]
    loader = {"batch_size": o["batch_size"], "group_size": 4,
              "text_bucket": 32, "mel_bucket": 160,
              "max_mel_len": cfg["arch"]["max_seq_len"]}
    first = batches.group_firsts(work, loader)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = train_check.reference_steps(w0, cfg["arch"], o, first, device)
    low = train_check.reference_steps(w0, cfg["arch"], o, first, device,
                                      quant=fp8)
    change = lambda p: {n: p[n] - w0[n] for n in p}  # noqa: E731
    return train_check.compare(
        low[0], train_check.norms(low[1]), train_check.norms(change(low[2])),
        ref[0], train_check.norms(ref[1]), train_check.norms(change(ref[2])),
        cell.traffic["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["serve_short_closed64"])
@pytest.mark.parametrize("seed", SEEDS)
def test_serving_control_is_not_correct(seed, cell):
    checks, correct = serve_control(seed, _device(), cell)
    print("serving control", cell, seed, {n: v for n, v, _ in checks})
    assert not correct


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_is_not_correct(seed):
    checks, correct, notes = train_control(seed, _device())
    print("training control", seed, notes["numbers"], notes["grad"])
    assert not correct


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_training_on_half_the_batch_is_not_correct(seed, monkeypatch):
    import time

    from fastspeech2_tpu_torch.training import step as steps_mod

    from benchmark.harness import train
    from benchmark.harness.cell import Cell

    device = _device()
    apply_model = steps_mod.apply_model

    def half(model, cfg, batch, *args, **kwargs):
        b = batch["texts"].shape[0] // 2
        return apply_model(model, cfg, {k: v[:b] for k, v in batch.items()},
                           *args, **kwargs)

    monkeypatch.setattr(steps_mod, "apply_model", half)
    out = train.run(Cell.load("train_lj_scan_bf16"), seed, 1.0, False,
                    device, time.monotonic())
    print("training half batch", seed, out["notes"]["compared"]["numbers"])
    assert not out["correct"]
