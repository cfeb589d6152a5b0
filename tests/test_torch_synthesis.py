"""PyTorch port, the synthesize CLI's options, against the JAX package's CLI
on the CPU: batch mode (``--mode batch --source``), ``--long``,
``--torch_ckpt``, the MelGAN and Griffin-Lim vocoders through
model.yaml's ``vocoder.model``, a ``language: zh`` config with
tone-numbered pinyin, and the result png (which needs matplotlib).

Both CLIs get the tiny acoustic model of ``test_torch_port._tiny_setup``
(random weights from the JAX initialiser as an npz snapshot) and, unless
said otherwise, the tracked HiFi-GAN-iSTFT snapshot.  Sentences use
lexicon words only, so no neural G2P runs.  Wavs are compared to 1e-3 of
full scale, as in test_torch_port.py: the mels agree to ~1e-5, and int16
rounding plus the vocoder's gain turn that into a few LSB.  Griffin-Lim is
handed JAX's initial phase (torch cannot draw JAX's random numbers).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from fastspeech2_tpu.cli.common import load_model_for_inference
from fastspeech2_tpu.cli.synthesize_cli import main as jax_main
from fastspeech2_tpu.configs.config import load_yaml_configs
from fastspeech2_tpu.convert.to_torch import save_torch_checkpoint
from fastspeech2_tpu_torch.audio import stft
from fastspeech2_tpu_torch.cli import synthesize_cli
from test_torch_port import CONFIG, REPO, VOCODER, _tiny_setup

SENTENCE = "They bought their offices from one another."
FULL_SCALE = 32768
MELGAN_NPZ = os.path.join(REPO, "weights", "vocoder_melgan_30k.npz")


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """(model.yaml, train.yaml, acoustic npz) of the tiny model, run from
    the repository root (the configs name corpus files from there)."""
    monkeypatch.chdir(REPO)
    return _tiny_setup(tmp_path)


def _with_vocoder(tmp_path, model_path, name):
    with open(model_path) as f:
        cfg = yaml.safe_load(f)
    cfg["vocoder"]["model"] = name
    path = tmp_path / f"model_{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _run_both(tmp_path, argv):
    """The JAX CLI (results under train.yaml's result path, tmp/jax_result)
    and the port's CLI on the CPU (tmp/torch_result) -> the port's
    return value."""
    jax_main(argv)
    return synthesize_cli.main(argv + ["--device", "cpu", "--result_path",
                                       str(tmp_path / "torch_result")])


def _assert_same_wav(got_path, ref_path, n_samples=None):
    sr, got = wavfile.read(got_path)
    sr_ref, ref = wavfile.read(ref_path)
    assert sr == sr_ref == 22050 and got.dtype == ref.dtype == np.int16
    assert got.shape == ref.shape
    if n_samples is not None:
        assert got.shape == (n_samples,)
    assert np.abs(ref.astype(np.int32)).max() > 0
    np.testing.assert_allclose(got.astype(np.float64), ref.astype(np.float64),
                               atol=1e-3 * FULL_SCALE, rtol=0)
    return got


def _single(model_path, train_path, npz, text=SENTENCE, pre=None):
    return ["--mode", "single", "--text", text,
            "-p", pre or f"{CONFIG}/preprocess.yaml", "-m", model_path,
            "-t", train_path, "--weights_npz", npz]


def test_batch_mode_matches_jax_cli(tmp_path, tiny):
    """Three rows of phone strings pad to a batch of 4 with copies of row
    0; each row gets <basename>.wav and .png."""
    model_path, train_path, npz = tiny
    source = tmp_path / "rows.txt"
    source.write_text(
        "utt_a|LJSpeech|{DH EY1 B AO1 T DH EH1 R AO1 F AH0 S AH0 Z}|they "
        "bought their offices\n"
        "utt_b|LJSpeech|{DH AH0 S OW1 V IY0 EH2 T sp AO2 TH AO1 R AH0 T IY0 "
        "Z}|the soviet authorities\n"
        "utt_c|LJSpeech|{W AH1 N}|one\n")
    wavs, outs, paths = _run_both(tmp_path, [
        "--mode", "batch", "--source", str(source),
        "-p", f"{CONFIG}/preprocess.yaml", "-m", model_path,
        "-t", train_path, "--weights_npz", npz, "--vocoder_ckpt", VOCODER])
    assert len(outs) == 1 and outs[0].postnet_mel.shape[0] == 4
    assert [os.path.basename(p) for p in paths] == [
        "utt_a.wav", "utt_b.wav", "utt_c.wav"]
    assert sorted(os.listdir(tmp_path / "jax_result")) == sorted(
        os.listdir(tmp_path / "torch_result"))
    for i, name in enumerate(("utt_a", "utt_b", "utt_c")):
        got = _assert_same_wav(paths[i], tmp_path / "jax_result" /
                               f"{name}.wav",
                               int(outs[0].mel_len[i]) * 256)
        np.testing.assert_array_equal(got, wavs[i])
        assert (tmp_path / "torch_result" / f"{name}.png").exists()


def test_long_matches_jax_cli(tmp_path, tiny, capsys):
    model_path, train_path, npz = tiny
    text = "They bought their offices. The soviet authorities denied it!"
    wavs, chunks, paths = _run_both(
        tmp_path, _single(model_path, train_path, npz, text)
        + ["--long", "--vocoder_ckpt", VOCODER])
    assert chunks == ["They bought their offices.",
                      "The soviet authorities denied it!"]
    assert os.path.basename(paths[0]) == f"{text[:40]}.wav"
    got = _assert_same_wav(paths[0], tmp_path / "jax_result" /
                           f"{text[:40]}.wav")
    np.testing.assert_array_equal(got, wavs[0])
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("Synthesized 2 chunks -> ") for ln in lines) == 2


def test_torch_ckpt_matches_jax_cli(tmp_path, tiny):
    """A reference-format .pth.tar written by the JAX package's exporter
    (its position tables and pitch/energy bins included) gives the JAX
    CLI's wav, and the port's own --weights_npz wav bit for bit."""
    model_path, train_path, npz = tiny
    configs = load_yaml_configs(f"{CONFIG}/preprocess.yaml", model_path,
                                train_path)
    _, variables, cfg = load_model_for_inference(configs, weights_npz=npz)
    ckpt = str(tmp_path / "reference.pth.tar")
    save_torch_checkpoint(ckpt, jax.tree_util.tree_map(np.asarray,
                                                       variables), cfg)
    argv = _single(model_path, train_path, npz)
    argv[argv.index("--weights_npz"):] = ["--torch_ckpt", ckpt,
                                          "--vocoder_ckpt", VOCODER]
    wavs, out, paths = _run_both(tmp_path, argv)
    _assert_same_wav(paths[0], tmp_path / "jax_result" / f"{SENTENCE}.wav",
                     int(out.mel_len[0]) * 256)
    npz_wavs, _, _ = synthesize_cli.main(
        _single(model_path, train_path, npz)
        + ["--vocoder_ckpt", VOCODER, "--device", "cpu", "--result_path",
           str(tmp_path / "npz_result")])
    np.testing.assert_array_equal(wavs[0], npz_wavs[0])
    with pytest.raises(SystemExit):
        synthesize_cli.main(argv + ["--weights_npz", npz, "--device", "cpu"])


def _jax_phase(shape, seed, device):
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(seed), tuple(shape), minval=-np.pi,
        maxval=np.pi))).to(device)


@pytest.mark.parametrize("name,ckpt", [("MelGAN", MELGAN_NPZ),
                                       ("none", None)])
def test_vocoder_model_matches_jax_cli(tmp_path, tiny, monkeypatch, name,
                                       ckpt):
    """vocoder.model MelGAN (on its tracked snapshot) and none
    (Griffin-Lim, 30 iterations from JAX's initial phase)."""
    model_path, train_path, npz = tiny
    monkeypatch.setattr(stft, "random_phase", _jax_phase)
    argv = _single(_with_vocoder(tmp_path, model_path, name), train_path,
                   npz)
    if ckpt:
        argv += ["--vocoder_ckpt", ckpt]
    wavs, out, paths = _run_both(tmp_path, argv)
    got = _assert_same_wav(paths[0], tmp_path / "jax_result" /
                           f"{SENTENCE}.wav", int(out.mel_len[0]) * 256)
    np.testing.assert_array_equal(got, wavs[0])


def test_zh_config_matches_jax_cli(tmp_path, tiny, capsys):
    """language: zh with tone-numbered pinyin: the same phones (printed by
    both CLIs) and wav."""
    model_path, train_path, npz = tiny
    with open(f"{CONFIG}/preprocess.yaml") as f:
        pre = yaml.safe_load(f)
    pre["preprocessing"]["text"] = {"text_cleaners": [], "language": "zh"}
    pre_path = tmp_path / "preprocess_zh.yaml"
    pre_path.write_text(yaml.safe_dump(pre))
    text = "ni3 hao3 shi4 jie4"
    wavs, out, paths = _run_both(
        tmp_path, _single(model_path, train_path, npz, text, str(pre_path))
        + ["--vocoder_ckpt", VOCODER])
    phones = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("Phoneme Sequence: ")]
    assert phones == ["Phoneme Sequence: {n i3 h ao3 sh iii4 j ie4}"] * 2
    _assert_same_wav(paths[0], tmp_path / "jax_result" / f"{text}.wav",
                     int(out.mel_len[0]) * 256)


@pytest.mark.parametrize("matplotlib", ["installed", "blocked"])
def test_result_png_needs_matplotlib(tmp_path, tiny, monkeypatch, capsys,
                                     matplotlib):
    """<id>.png beside <id>.wav; without matplotlib the wav alone, and one
    line saying the png was not drawn."""
    model_path, train_path, npz = tiny
    if matplotlib == "blocked":
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    result = tmp_path / "result"
    wavs, _, paths = synthesize_cli.main(
        _single(model_path, train_path, npz)
        + ["--vocoder_ckpt", VOCODER, "--device", "cpu", "--result_path",
           str(result)])
    assert paths == [str(result / f"{SENTENCE}.wav")]
    np.testing.assert_array_equal(wavfile.read(paths[0])[1], wavs[0])
    said = [ln for ln in capsys.readouterr().out.splitlines()
            if "matplotlib" in ln]
    if matplotlib == "installed":
        assert sorted(os.listdir(result)) == [f"{SENTENCE}.png",
                                              f"{SENTENCE}.wav"]
        assert said == []
    else:
        assert os.listdir(result) == [f"{SENTENCE}.wav"]
        assert said == [f"matplotlib is not installed: 1 png(s) not drawn "
                        f"in {result}"]
