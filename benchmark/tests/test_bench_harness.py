"""The benchmark on the CPU: its generators, its arithmetic, how it finds
its files, its import rule, and whole runs of test-only tiny cells, sound
and with the timed path broken."""

import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import flops, result, serve, train
from benchmark.harness.cell import BENCH_DIR, ROOT, Cell
from benchmark.harness.texts import TextGen
from benchmark.reference import frontend
from benchmark.tests import tiny

LEXICON = os.path.join(ROOT, "lexicon", "ljspeech-mined.txt")
SEED = 2 ** 33 + 12345


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _traffic(name):
    with open(os.path.join(BENCH_DIR, "traffic", name + ".json")) as f:
        return json.load(f)


# -- traffic ---------------------------------------------------------------

# LJSpeech 1.1's published counts: 225,715 words in 1,308,678 characters
LJ_WORDS_PER_CHAR = 225715 / 1308678


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]
                                  if _traffic(w["traffic"])["driver"]
                                  == "serve"])
def test_texts_are_deterministic_and_keep_their_statistics(cell):
    from scipy.stats import truncnorm

    p = _traffic(cell)["texts"]
    a = TextGen(p, LEXICON, SEED).texts(2000)
    assert a == TextGen(p, LEXICON, SEED).texts(2000)
    assert a != TextGen(p, LEXICON, SEED + 1).texts(2000)
    c = p["chars"]
    lens = np.array([len(t) for t in a])
    assert lens.min() >= c["min"] and lens.max() <= c["max"]
    # a text stops at the first word that reaches its drawn length
    drawn = truncnorm.mean((c["min"] - c["mean"]) / c["sd"],
                           (c["max"] - c["mean"]) / c["sd"], c["mean"],
                           c["sd"])
    assert drawn - 1 <= lens.mean() <= drawn + 6
    lex = frontend.read_lexicon(LEXICON)
    words = [w.lower() for t in a for w in re.findall(r"[A-Za-z]+", t)]
    assert all(w in lex for w in words)
    per_char = len(words) / lens.sum()
    assert abs(per_char / LJ_WORDS_PER_CHAR - 1) < 0.07
    assert sum(t.count(",") for t in a) / len(words) == pytest.approx(
        p["comma"], rel=0.15)


def test_word_ranks_are_the_same_for_every_seed():
    p = _traffic("serve_short_closed64")["texts"]
    g1, g2 = TextGen(p, LEXICON, SEED), TextGen(p, LEXICON, SEED + 1)
    assert g1.words == g2.words
    assert g1.words[:len(p["head"])] == p["head"]
    tail = g1.words[len(p["head"]):]
    assert [len(w) for w in tail] == sorted(len(w) for w in tail)


def test_text_i_depends_on_the_seed_and_i_alone():
    p = _traffic("serve_short_closed64")["texts"]
    g = TextGen(p, LEXICON, SEED)
    assert g.text(77) == TextGen(p, LEXICON, SEED).texts(80)[77]


def test_corpus_keeps_its_statistics(tmp_path):
    from benchmark.harness import corpus

    cfg = Cell.load("train_lj_scan_bf16").config
    c = dict(cfg["corpus"], n_utterances=300)
    corpus.write(str(tmp_path), c, cfg["stats"], 80, 22050, 256, SEED)
    rows = open(tmp_path / "train.txt").read().split("\n")[:-1]
    frames = []
    for row in rows:
        base = row.split("|")[0]
        d = np.load(tmp_path / "duration" / f"S-duration-{base}.npy")
        mel = np.load(tmp_path / "mel" / f"S-mel-{base}.npy")
        assert d.min() >= 1 and d.sum() == mel.shape[0]
        assert len(row.split("|")[2].strip("{}").split()) == len(d)
        frames.append(mel.shape[0])
    sec = np.array(frames) * 256 / 22050
    s = c["seconds"]
    assert sec.min() >= s["min"] - 0.02 and sec.max() <= s["max"] + 0.02
    assert abs(sec.mean() - s["mean"]) < 0.3
    other = tmp_path / "other"
    corpus.write(str(other), c, cfg["stats"], 80, 22050, 256, SEED + 1)
    for row, row2 in zip(rows, open(other / "train.txt").read().split("\n")):
        base = row.split("|")[0]
        assert row != row2
        assert len(row.split("|")[2].split()) == len(row2.split("|")[2].split())
        assert np.load(tmp_path / "mel" / f"S-mel-{base}.npy").shape == \
            np.load(other / "mel" / f"S-mel-{base}.npy").shape


def test_the_corpus_is_written_once_a_checkout(tmp_path):
    from benchmark.harness import corpus

    cfg = Cell.load("train_lj_scan_bf16").config
    c = dict(cfg["corpus"], n_utterances=40)
    path = corpus.cached(str(tmp_path), c, cfg["stats"], 80, 22050, 256)
    mel = os.path.join(path, "mel", "S-mel-syn00007.npy")
    stamp = os.stat(mel).st_mtime_ns
    assert corpus.cached(str(tmp_path), c, cfg["stats"], 80, 22050,
                         256) == path
    assert os.stat(mel).st_mtime_ns == stamp
    assert os.listdir(os.path.dirname(path)) == [os.path.basename(path)]
    direct = tmp_path / "direct"
    corpus.write(str(direct), c, cfg["stats"], 80, 22050, 256, c["seed"])
    assert (direct / "train.txt").read_text() == \
        open(os.path.join(path, "train.txt")).read()
    assert np.array_equal(np.load(mel),
                          np.load(direct / "mel" / "S-mel-syn00007.npy"))
    other = corpus.cached(str(tmp_path), dict(c, seed=c["seed"] + 1),
                          cfg["stats"], 80, 22050, 256)
    assert other != path
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    corpus.link(path, str(run_dir))
    assert np.array_equal(np.load(run_dir / "mel" / "S-mel-syn00007.npy"),
                          np.load(mel))


# -- arithmetic ------------------------------------------------------------

def test_rates_count_the_whole_window():
    done = [{"ok": True, "t_done": t} for t in (0.5, 1.0, 9.9)]
    ctx = {"done": done, "t0": 0.0, "t1": 10.0}
    assert serve.end_to_end("serve_utt_per_s", ctx, 1.0) == 0.3


def test_flops_match_hand_counts():
    cfg = Cell.load("serve_short_closed64").config
    a = cfg["arch"]
    P, T = 40, 300
    block = lambda L: (4 * 2 * L * 256 * 256 + 4 * L * L * 256  # noqa: E731
                       + 2 * L * 256 * 1024 * 9 + 2 * L * 1024 * 256)
    hand = (4 * block(P) + 3 * (2 * 2 * P * 256 * 256 * 3 + 2 * P * 256)
            + 6 * block(T) + 2 * T * 256 * 80
            + 2 * T * 5 * (80 * 512 + 3 * 512 * 512 + 512 * 80))
    assert math.isclose(flops.acoustic_flops(P, T, a), hand, rel_tol=1e-12)
    v = cfg["vocoder"]
    res = lambda L, C: 2 * 3 * 2 * L * C * C * (3 + 7 + 11)  # noqa: E731
    hand_v = (2 * T * 80 * 512 * 7 + 2 * T * 512 * 256 * 16
              + res(8 * T, 256) + 2 * 8 * T * 256 * 128 * 16
              + res(64 * T, 128) + 2 * 64 * T * 128 * 18 * 7
              + 2 * 2 * 64 * T * 9 * 16)
    assert math.isclose(flops.vocoder_flops(T, v, 80), hand_v, rel_tol=1e-12)


@pytest.mark.parametrize("B,C,L,k", [(16, 256, 8000, 3), (1, 32, 256000, 11),
                                     (16, 128, 64000, 7)])
def test_k4_counts_match_the_program_tool(B, C, L, k):
    from fastspeech2_tpu_torch.tools import kernel_bounds

    _, _, _, ops, nbytes = kernel_bounds.resblock_bound_ms(B, L, C, k)
    assert flops.resblock_ops_bytes(B * L, C, k) == (ops, nbytes)


@pytest.mark.parametrize("B,L,backward,dtype", [
    (10, 1000, False, "float32"), (16, 128, True, "float32"),
    (10, 768, True, "bfloat16"), (1, 32, False, "bfloat16")])
def test_attention_counts_match_the_program_tool(B, L, backward, dtype):
    from fastspeech2_tpu_torch.tools import kernel_bounds

    _, _, _, ops, nbytes = kernel_bounds.attention_bound_ms(
        B, 2, L, backward, dtype=dtype)
    assert flops.attention_ops_bytes([L] * B, 2, 128, backward, dtype) == \
        (ops, nbytes)


def test_bounds_count_each_operation_once_at_the_dtype_peak():
    ops, nbytes = flops.attention_ops_bytes([1000] * 10, 2, 128, False,
                                            "float32")
    assert flops._bound_s(ops, nbytes, "float32") == ops / 495e12
    ops, nbytes = flops.attention_ops_bytes([1000] * 10, 2, 128, True,
                                            "bfloat16")
    assert flops._bound_s(ops, nbytes, "bfloat16") == ops / 989e12


# -- finding files by name -------------------------------------------------

@pytest.mark.parametrize("name", [w["name"] for w in _bench()["workloads"]])
def test_each_cell_finds_its_files_by_name(name):
    cell = Cell.load(name)
    assert cell.traffic["driver"] in ("serve", "train")
    assert cell.config["name"] == cell.workload["config"]
    names = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in names and len(names) >= 2
    layer = cell.per_layer()
    assert layer
    for m in layer:
        assert callable(cell.reader(m["name"]))
        assert m["moves"] in names


def test_every_metric_and_config_has_its_file():
    b = _bench()
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                           m["name"] + ".py"))
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_a_test_only_cell_is_files_and_entries_alone():
    cell = tiny.cell("tiny.closed")
    assert cell.traffic_path().startswith(tiny.DATA)
    assert {m["name"] for m in cell.per_layer()} == {
        "server.mean_batch.closed", "dispatch.ms.closed", "test.dispatches"}
    assert cell.reader("test.dispatches")({"dispatches": [1, 2]}) == 2


def test_configs_agree_with_the_program_builders(tmp_path):
    import yaml

    from fastspeech2_tpu_torch.configs.config import FastSpeech2Config
    from fastspeech2_tpu_torch.synthesis import vocoder as program_vocoder

    from benchmark.harness import programs

    for name in ("serve_short_closed64", "train_lj_scan_bf16"):
        cfg = Cell.load(name).config
        pre, model, _ = programs.write_yaml_configs(cfg, str(tmp_path / name),
                                                    ROOT)
        built = FastSpeech2Config.build(yaml.safe_load(open(pre)),
                                        yaml.safe_load(open(model)))
        for k, v in cfg["arch"].items():
            want = tuple(v) if isinstance(v, list) else v
            assert getattr(built, k) == want, k
    cfg = Cell.load("serve_short_closed64").config
    with open(os.path.join(os.path.dirname(program_vocoder.__file__), "..",
                           "configs", "hifigan", "config_istft.json")) as f:
        shipped = json.load(f)
    for k, v in cfg["vocoder"].items():
        assert shipped[k] == v, k


# -- the import rule -------------------------------------------------------

def test_forbidden_names_compare_whole_top_level_names():
    names = ["fastspeech2_tpu_torch", "fastspeech2_tpu_torch.models",
             "jaxtyping", "flaxen.x", "jax.numpy", "fastspeech2_tpu.text",
             "flax", "jaxlib.xla"]
    assert result.forbidden_modules(names) == [
        "fastspeech2_tpu.text", "flax", "jax.numpy", "jaxlib.xla"]


def test_a_run_imports_nothing_forbidden():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run\n"
            "from benchmark.harness import serve, train, clients\n"
            "from fastspeech2_tpu_torch.cli import serve_cli\n"
            "from fastspeech2_tpu_torch.training import loop, scan, step\n"
            "from benchmark.reference import fs2, vocoder, weights\n"
            "from benchmark.harness.result import forbidden_modules\n"
            "print(forbidden_modules())\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_the_cards():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "serve_short_closed64", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


# -- whole runs at tiny widths ---------------------------------------------

def _serve(hooks=None, trace=False, seed=SEED, name="tiny.closed"):
    torch.set_num_threads(4)
    import time

    return serve.run(tiny.cell(name), seed, 2.0, trace,
                     torch.device("cpu"), time.monotonic(), hooks)


def _train(hooks=None, seed=SEED, trace=False):
    torch.set_num_threads(4)
    import time

    cell = tiny.cell("tiny.train")
    cell.config["dtype"] = "float32"
    return train.run(cell, seed, 1.0, trace, torch.device("cpu"),
                     time.monotonic(), hooks)


def test_tiny_serving_run_is_correct():
    out = _serve()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"serve_utt_per_s", "setup_s"}


def test_tiny_serving_traced_run_reads_its_layers():
    out = _serve(trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["server.mean_batch.closed"]["value"] > 1
    assert out["metrics"]["test.dispatches"]["value"] > 0
    assert "window_s" in out["device"]


def test_tiny_serving_with_altered_answers_is_not_correct():
    def alter(server):
        syn = server.batcher.synthesizer
        forward = syn.fused_forward

        def altered(*args, **kwargs):
            wav, out = forward(*args, **kwargs)
            return wav * 1.05, out

        syn.fused_forward = altered

    out = _serve({"after_build": alter})
    assert not out["correct"]
    checks = {n: (v, lim) for n, v, lim in out["checks"]}
    assert checks["wav_rel_rms"][0] > checks["wav_rel_rms"][1]


def test_tiny_training_run_is_correct():
    out = _train()
    assert out["correct"], out["checks"]
    assert out["metrics"]["train_frames_per_s"]["value"] > 0


def test_tiny_training_traced_run_reads_its_layers():
    out = _train(trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["train.mfu"]["value"] > 0
    assert 0 < out["device"]["window_s"] < 1.0


def test_tiny_training_with_its_state_unchanged_is_not_correct():
    def freeze(model, optimizer, scanned):
        optimizer.update = lambda grads, norm=None: optimizer.lr

    out = _train({"after_build": freeze})
    assert not out["correct"]
    checks = {n: v for n, v, _ in out["checks"]}
    assert checks["change_gap"] == pytest.approx(1.0)


def test_tiny_training_on_half_the_batch_is_not_correct(monkeypatch):
    from fastspeech2_tpu_torch.training import step as steps_mod

    apply_model = steps_mod.apply_model

    def half(model, cfg, batch, *args, **kwargs):
        b = batch["texts"].shape[0] // 2
        return apply_model(model, cfg, {k: v[:b] for k, v in batch.items()},
                           *args, **kwargs)

    monkeypatch.setattr(steps_mod, "apply_model", half)
    out = _train()
    assert not out["correct"]
