"""PyTorch port, the last scripts as tools: ``tools/leave_one_out.py``
(the fold builder's leakage guards of tests/test_leave_one_out.py, the
copy-synthesis rows matched by their "file" field, a truncated summary)
and ``tools/score_vocoder_ladder.py`` (one vocoder, each checkpoint
loaded into it, scored as ``evaluation/vocoder_eval`` scores each one
alone: the same metrics exactly), on the CPU; and the import guard's
view of the new modules.
"""

import json
import os

import numpy as np
import pytest
import torch

from fastspeech2_tpu_torch.tools import leave_one_out as loo

NAMES = ["UTT-0001", "UTT-0002", "UTT-0003"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the suite runs beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def base_corpus(tmp_path, monkeypatch):
    base = tmp_path / "base_pre"
    for d in ("mel", "pitch", "energy", "duration", "wav"):
        (base / d).mkdir(parents=True)
    for f in ("stats.json", "speakers.json"):
        (base / f).write_text("{}")
    lines = [f"{n}|LJSpeech|{{AH0}}|text {i}\n" for i, n in enumerate(NAMES)]
    (base / "train.txt").write_text("".join(lines))
    monkeypatch.setattr(loo, "BASE_PRE", base)
    return base


def test_build_fold_excludes_heldout_from_train(base_corpus, tmp_path):
    fold_pre = loo.build_fold("UTT-0002", tmp_path / "fold")
    train = (fold_pre / "train.txt").read_text()
    val = (fold_pre / "val.txt").read_text()
    assert "UTT-0002" not in train
    assert val.startswith("UTT-0002|") and len(val.splitlines()) == 1
    assert [ln.split("|")[0] for ln in train.splitlines()] == [
        "UTT-0001", "UTT-0003"]


def test_build_fold_links_features_not_copies(base_corpus, tmp_path):
    fold_pre = loo.build_fold("UTT-0001", tmp_path / "fold")
    for d in ("mel", "pitch", "energy", "duration", "wav",
              "stats.json", "speakers.json"):
        assert (fold_pre / d).is_symlink(), d


def test_build_fold_rejects_unknown_clip(base_corpus, tmp_path):
    with pytest.raises(SystemExit):
        loo.build_fold("UTT-9999", tmp_path / "fold")


def test_build_fold_is_idempotent(base_corpus, tmp_path):
    out_root = tmp_path / "fold"
    loo.build_fold("UTT-0003", out_root)
    fold_pre = loo.build_fold("UTT-0003", out_root)   # re-run: no crash
    assert "UTT-0003" not in (fold_pre / "train.txt").read_text()


def test_copysyn_rows_are_matched_by_file(tmp_path):
    """The held-out and anchor rows are found by their "file" field in
    whatever order vocoder_eval printed them, other JSON lines skipped;
    fewer than two rows fail with the log's path."""
    held, anchor = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    log = tmp_path / "copysyn.json"
    log.write_text("$ python -m ...\n"
                   '{"mean": {"mcd_db": 1.0}, "n_files": 2}\n'
                   + json.dumps({"file": anchor, "mcd_db": 7.0}) + "\n"
                   + json.dumps({"file": held, "mcd_db": 9.0}) + "\n")
    rows = loo.copysyn_rows(log, held, anchor)
    assert rows["heldout"]["mcd_db"] == 9.0
    assert rows["train_anchor"]["mcd_db"] == 7.0
    log.write_text(json.dumps({"file": held, "mcd_db": 9.0}) + "\n")
    with pytest.raises(SystemExit, match="copysyn.json"):
        loo.copysyn_rows(log, held, anchor)


def test_truncated_summary_starts_fresh(tmp_path):
    path = tmp_path / "summary.json"
    assert loo.read_summary(path) == {"folds": {}}
    path.write_text('{"folds": {"UTT-0001:vocoder": {"heldout"')
    assert loo.read_summary(path) == {"folds": {}}
    path.write_text(json.dumps({"folds": {"x": 1}, "args": {}}))
    assert loo.read_summary(path)["folds"] == {"x": 1}


TINY_ISTFT = dict(upsample_rates=[8, 8], upsample_kernel_sizes=[16, 16],
                  upsample_initial_channel=32, resblock_kernel_sizes=[3],
                  resblock_dilation_sizes=[[1, 3]], gen_istft_n_fft=16,
                  gen_istft_hop_size=4, num_mels=80)


def test_ladder_scores_each_checkpoint_as_vocoder_eval_does(tmp_path):
    """Two tiny iSTFT checkpoints (the port's lean layout with their
    config) through the ladder, built once: each row is what
    vocoder_eval gives that checkpoint alone, exactly."""
    from fastspeech2_tpu_torch.audio.wav import save_wav
    from fastspeech2_tpu_torch.evaluation.vocoder_eval import (
        evaluate_vocoder,
    )
    from fastspeech2_tpu_torch.synthesis.vocoder import (
        build_generator,
        get_vocoder,
    )
    from fastspeech2_tpu_torch.tools.score_vocoder_ladder import (
        score_ladder,
    )

    ckpts = []
    for seed in (1, 2):
        torch.manual_seed(seed)
        gen = build_generator(TINY_ISTFT, fused=False)
        path = str(tmp_path / f"{seed}.pth.tar")
        torch.save({"generator": gen.state_dict(),
                    "generator_config": TINY_ISTFT}, path)
        ckpts.append(path)
    t = np.arange(int(0.4 * 22050)) / 22050.0
    wavs = []
    for i, f0 in enumerate((180.0, 240.0)):
        path = str(tmp_path / f"clip{i}.wav")
        save_wav(path, (0.4 * np.sin(2 * np.pi * f0 * t)).astype(np.float32),
                 22050)
        wavs.append(path)
    rows = score_ladder("HiFi-GAN-iSTFT", ckpts, wavs, device="cpu",
                        log=lambda *_: None)
    model_config = {"vocoder": {"model": "HiFi-GAN-iSTFT",
                                "speaker": "LJSpeech"}}
    for ckpt, row in zip(ckpts, rows):
        alone = get_vocoder(model_config, None, ckpt, "cpu")
        _, mean = evaluate_vocoder(alone, wavs, 22050, device="cpu")
        assert row == {"ckpt": ckpt, "mean": mean, "n_files": 2}
    assert rows[0]["mean"] != rows[1]["mean"]
    other = dict(TINY_ISTFT, upsample_initial_channel=16)
    torch.save({"generator": build_generator(other).state_dict(),
                "generator_config": other}, str(tmp_path / "other.pth.tar"))
    with pytest.raises(ValueError, match="ladder"):
        score_ladder("HiFi-GAN-iSTFT", [ckpts[0],
                                        str(tmp_path / "other.pth.tar")],
                     wavs, device="cpu", log=lambda *_: None)


def test_tools_keep_the_scripts_arguments():
    """The tools take the scripts' arguments (plus --device)."""
    from fastspeech2_tpu_torch.tools import g2p_ensemble
    from fastspeech2_tpu_torch.tools import score_vocoder_ladder

    assert os.path.basename(loo.REPO) == os.path.basename(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for module in (loo, g2p_ensemble, score_vocoder_ladder):
        with pytest.raises(SystemExit):
            module.main(["--help"])
