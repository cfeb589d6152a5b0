"""PyTorch port, objective evaluation: the metrics (mel cepstra, the DTW
path, MCD, F0 RMSE and voicing), copy-synthesis vocoder scoring, the
prosody sweep's gates and page, the alignment validation on the tracked
clips and TextGrids, the demo pages and ``evaluate --objective``, each
held against the JAX package's function on the same wavs, on the CPU.

Tolerances:
- the DTW path exactly and MCD within 1e-5 relative (the log-mels differ
  by the FFT libraries' rounding only);
- the voicing metrics exactly where both DIOs voice the same frames (these
  signals), and the F0 RMSE within F0_RTOL of the largest F0: the two
  packages' F0 tracks agree to F0_RTOL relative
  (tests/test_torch_preprocessing.py), and an RMSE of track differences
  moves by at most the largest of them;
- the alignment metrics computed from the wav alone exactly, those from
  DIO's voicing within 1 - F0_VOICING_SHARE;
- wavs written by both to 1e-3 of full scale, as test_torch_port.py holds
  the CLIs;
- the html pages byte for byte.

JAX's DIO runs at three lengths here (3 s, the alignment test's padded
length and 2048 samples), so that JAX compiles few shapes.
"""

import argparse
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from fastspeech2_tpu.cli.common import load_model_for_inference as jax_load
from fastspeech2_tpu.cli.evaluate_cli import _objective_eval
from fastspeech2_tpu.configs.config import load_yaml_configs
from fastspeech2_tpu.evaluation import align_validation as jax_align
from fastspeech2_tpu.evaluation import demo_page as jax_demo
from fastspeech2_tpu.evaluation import metrics as jax_metrics
from fastspeech2_tpu.evaluation import prosody_sweep as jax_sweep
from fastspeech2_tpu.evaluation.vocoder_eval import (
    evaluate_vocoder as jax_evaluate_vocoder,
)
from fastspeech2_tpu.synthesis import HiFiGANVocoder as JaxHiFiGAN
from fastspeech2_tpu_torch.cli import evaluate_cli
from fastspeech2_tpu_torch.cli.synthesize_cli import load_model_for_inference
from fastspeech2_tpu_torch.evaluation import align_validation, demo_page
from fastspeech2_tpu_torch.evaluation import metrics, prosody_sweep
from fastspeech2_tpu_torch.evaluation.vocoder_eval import evaluate_vocoder
from fastspeech2_tpu_torch.synthesis.pipeline import Synthesizer
from fastspeech2_tpu_torch.synthesis.vocoder import (
    build_generator,
    generator_from_jax_params,
)
from test_torch_port import CONFIG, REPO, VOCODER, _tiny_setup

RAW = os.path.join(REPO, "raw_data", "LJSpeech10", "LJSpeech")
TEXTGRIDS = os.path.join(REPO, "preprocessed_data", "LJSpeech10",
                         "TextGrid", "LJSpeech")
SR = 22050
T3 = 3 * SR
F0_RTOL = 1e-4
F0_VOICING_SHARE = 0.99
FULL_SCALE = 32768
# the tiny iSTFT generator of tests/test_metrics.py (8 * 4 * 8 = hop 256)
TINY_ISTFT = {"upsample_rates": [8, 4], "upsample_kernel_sizes": [16, 8],
              "upsample_initial_channel": 32, "resblock_kernel_sizes": [3],
              "resblock_dilation_sizes": [[1, 3]], "num_mels": 80,
              "gen_istft_n_fft": 16, "gen_istft_hop_size": 8}
VOICING = ("voicing_precision", "voicing_recall", "voicing_f1",
           "voiced_ref_frac", "voiced_syn_frac")


def _clip(name, n=T3, start=0):
    sr, y = wavfile.read(os.path.join(RAW, f"{name}.wav"))
    assert sr == SR
    return (y[start:start + n].astype(np.float64) / 32768.0).astype(
        np.float32)


@pytest.fixture(scope="module")
def pairs():
    a, b = _clip("LJ001-0012"), _clip("LJ011-0202")
    noisy = (0.8 * a + 0.003 * np.random.RandomState(0).randn(T3)).astype(
        np.float32)
    return {"same-noisy": (a, noisy), "different": (a, b)}


def _cost(cr, cs):
    cost = np.empty((len(cr), len(cs)), np.float32)
    for i in range(len(cr)):
        d = cs - cr[i]
        cost[i] = np.sqrt(np.einsum("bc,bc->b", d, d))
    return cost


def _assert_f0_metrics(got, ref, f0_max):
    assert set(got) == set(ref)
    for k in VOICING:
        assert got[k] == ref[k], k
    if np.isnan(ref["f0_rmse_hz"]):
        assert np.isnan(got["f0_rmse_hz"])
    else:
        assert abs(got["f0_rmse_hz"] - ref["f0_rmse_hz"]) <= F0_RTOL * f0_max


@pytest.mark.parametrize("name", ["same-noisy", "different"])
def test_mcd_and_dtw_path_match_jax(pairs, name):
    ref_wav, syn_wav = pairs[name]
    x = np.random.RandomState(1).randn(5, 80)
    np.testing.assert_array_equal(metrics._dct_ortho(x, 13),
                                  jax_metrics._dct_ortho(x, 13))
    cep = {}
    for pkg, fn in (("port", partial_cpu(metrics.mel_cepstra)),
                    ("jax", jax_metrics.mel_cepstra)):
        cep[pkg] = [fn(w)[:, 1:] for w in (ref_wav, syn_wav)]
    costs = {k: _cost(*v) for k, v in cep.items()}
    band = max(64, int(0.1 * max(map(len, cep["jax"]))))
    path = metrics._dtw_path(costs["port"], band)
    assert path == jax_metrics._dtw_path(costs["jax"], band)
    assert path == jax_metrics._dtw_path(costs["port"], band)
    got = metrics.mcd(ref_wav, syn_wav, SR, device="cpu")
    ref = jax_metrics.mcd(ref_wav, syn_wav, SR)
    assert got > 0 and abs(got - ref) <= 1e-5 * ref
    assert metrics.mcd(ref_wav, ref_wav, SR, device="cpu") == 0.0


def partial_cpu(fn):
    return lambda *args, **kwargs: fn(*args, device="cpu", **kwargs)


@pytest.mark.parametrize("name", ["same-noisy", "different"])
def test_f0_metrics_match_jax(pairs, name):
    ref_wav, syn_wav = pairs[name]
    got = metrics.f0_metrics(ref_wav, syn_wav, SR, device="cpu")
    ref = jax_metrics.f0_metrics(ref_wav, syn_wav, SR)
    assert 0 < ref["voicing_f1"] < 1
    _assert_f0_metrics(got, ref, 800.0)


def test_metrics_cli(tmp_path, capsys):
    a = _clip("LJ001-0012")
    for name in ("ref", "syn"):
        wavfile.write(tmp_path / f"{name}.wav", SR,
                      (a * 32767).astype(np.int16))
    out = metrics.main([str(tmp_path / "ref.wav"), str(tmp_path / "syn.wav"),
                        "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == out
    assert out["mcd_db"] == 0.0 and out["voicing_f1"] == 1.0


@pytest.fixture(scope="module")
def tiny_istft():
    """The tiny iSTFT generator in both packages on JAX's PRNGKey(0)
    parameters."""
    jax_voc = JaxHiFiGAN(config=TINY_ISTFT)
    gen = build_generator(TINY_ISTFT)
    gen.load_state_dict(generator_from_jax_params(jax_voc.params, TINY_ISTFT))
    return jax_voc, gen.eval()


def test_vocoder_eval_matches_jax(tmp_path, tiny_istft):
    jax_voc, gen = tiny_istft
    gt = tmp_path / "LJ001-0012.wav"
    wavfile.write(gt, SR, (_clip("LJ001-0012") * 32768).astype(np.int16))
    got_rows, got_mean = evaluate_vocoder(gen, [str(gt)], SR,
                                          save_dir=str(tmp_path / "port"),
                                          device="cpu")
    ref_rows, ref_mean = jax_evaluate_vocoder(jax_voc, [str(gt)], SR,
                                              save_dir=str(tmp_path / "jax"))
    assert set(got_mean) == set(ref_mean)
    (got,), (ref,) = got_rows, ref_rows
    assert got["file"] == ref["file"]
    assert abs(got["mcd_db"] - ref["mcd_db"]) <= max(1e-5 * ref["mcd_db"],
                                                     1e-3)   # rounded to 3
    _assert_f0_metrics(got, ref, 800.0)
    name = "LJ001-0012_copysyn.wav"
    w_got = wavfile.read(tmp_path / "port" / name)[1].astype(np.float64)
    w_ref = wavfile.read(tmp_path / "jax" / name)[1].astype(np.float64)
    assert w_got.shape == w_ref.shape == (259 * 256,)
    assert np.abs(w_ref).max() > 0
    np.testing.assert_allclose(w_got, w_ref, atol=1e-3 * FULL_SCALE, rtol=0)


def test_prosody_sweep_verify_and_page_match_jax(tmp_path, tiny_istft):
    """A sweep on the tiny acoustic model and the tiny generator in both
    control modes through the port; the JAX package's verify and page on
    those results give the port's, and its helpers the port's values."""
    _, gen = tiny_istft
    model_path, train_path, npz = _tiny_setup(tmp_path)
    with open(f"{CONFIG}/preprocess.yaml") as f:
        pre = yaml.safe_load(f)
    for key in ("lexicon_path", "raw_path", "preprocessed_path"):
        pre["path"][key] = f"{REPO}/{pre['path'][key]}"
    with open(model_path) as f:
        model_config = yaml.safe_load(f)
    model, cfg = load_model_for_inference(pre, model_config, npz, "cpu")
    out = {"text": "They bought their offices.", "modes": {}}
    for mode in ("reference", "absolute"):
        syn = Synthesizer(model, cfg, pre, "cpu", vocoder=gen,
                          control_mode=mode)
        results = prosody_sweep.sweep(syn, gen, pre, out["text"],
                                      save_dir=str(tmp_path / mode))
        ok, checks = prosody_sweep.verify(results, mode=mode)
        assert (ok, checks) == jax_sweep.verify(results, mode=mode)
        frames = [results["duration"][f"{r:.1f}"]["mel_frames"]
                  for r in prosody_sweep.RATIOS]
        assert frames == sorted(frames) and frames[0] > 0
        assert sorted(os.listdir(tmp_path / mode)) == sorted(
            f"{c}_{r:.1f}.wav" for c in ("pitch", "energy", "duration")
            for r in prosody_sweep.RATIOS)
        out["modes"][mode] = {"results": results, "checks": checks,
                              "ok": ok}
    html = {}
    for name, fn in (("port", prosody_sweep.write_sweep_page),
                     ("jax", jax_sweep.write_sweep_page)):
        (tmp_path / name).mkdir()
        with open(fn(out, str(tmp_path / name))) as f:
            html[name] = f.read()
    assert html["port"] == html["jax"]
    rng = np.random.RandomState(2)
    base, test = rng.rand(2, 50) * 200 + 50
    base[::7] = 0
    assert prosody_sweep.paired_f0_ratio(base, test) == \
        jax_sweep.paired_f0_ratio(base, test)
    wav = rng.randn(4000).astype(np.float32)
    rms = prosody_sweep.frame_rms(wav, 256)
    np.testing.assert_array_equal(rms, jax_sweep.frame_rms(wav, 256))
    assert prosody_sweep.paired_rms_ratio(rms, 1.1 * rms) == \
        jax_sweep.paired_rms_ratio(rms, 1.1 * rms)


@pytest.mark.parametrize("null,clip", [("aligned", "LJ011-0202"),
                                       ("uniform", "LJ042-0094")])
def test_align_validation_matches_jax(null, clip):
    """The two shortest tracked clips against their tracked TextGrids (one
    scored as aligned, one as the uniform null), DIO at one padded
    length."""
    args = (os.path.join(RAW, f"{clip}.wav"),
            os.path.join(TEXTGRIDS, f"{clip}.TextGrid"))
    got = align_validation.validate_utterance(*args, pad_to=98304,
                                              null=null, device="cpu")
    ref = jax_align.validate_utterance(*args, pad_to=98304, null=null)
    assert set(got) == set(ref)
    for k in ("sil_to_speech_rms", "boundary_contrast_median",
              "n_boundaries", "n_vowel_frames", "n_unvoiced_frames"):
        assert got[k] == ref[k] or (np.isnan(got[k])
                                    and np.isnan(ref[k])), k
    for k in ("vowel_voiced_frac", "unvoiced_voiced_frac"):
        assert abs(got[k] - ref[k]) <= 1 - F0_VOICING_SHARE, k
    assert ref["n_vowel_frames"] > 0 and ref["vowel_voiced_frac"] > 0


def test_demo_pages_match_jax(tmp_path):
    wavs = []
    for i in range(3):
        path = tmp_path / f"utt{i}.wav"
        wavfile.write(path, SR, np.full(100, i, np.int16))
        wavs.append(str(path))
    pairs = [(wavs[0], wavs[1]), (wavs[1], wavs[2])]
    entries = [{"name": "utt<0>", "text": "a & b", "ref": wavs[0],
                "syn": wavs[1], "metrics": {"mcd_db": 30.1}}]
    for fn_port, fn_jax, args in (
            (demo_page.write_demo_page, jax_demo.write_demo_page,
             (pairs,)),
            (demo_page.write_tts_demo_page, jax_demo.write_tts_demo_page,
             (entries,))):
        pages = []
        for name, fn in (("port", fn_port), ("jax", fn_jax)):
            out = tmp_path / f"{fn.__name__}_{name}"
            path = fn(*args, str(out), title="T <x>", subtitle="s")
            pages.append((open(path).read(), sorted(os.listdir(out))))
        assert pages[0] == pages[1]


def test_evaluate_objective_rows_match_jax(tmp_path):
    """--objective 2 over a val split of two short phone strings whose
    ground-truth wavs are 2048 samples (shorter than either synthesized
    wav, so DIO runs at one length) from one second into two tracked
    clips, through the tiny acoustic model and the tracked iSTFT snapshot:
    the port's rows, written wavs and metrics.json against the JAX
    package's."""
    model_path, train_path, npz = _tiny_setup(tmp_path)
    pre_dir = tmp_path / "pre"
    (pre_dir / "wav").mkdir(parents=True)
    rows = [("LJ001-0012", "{DH EY1 B AO1 T}", "they bought"),
            ("LJ011-0202", "{W AH1 N sp AH0 N AH1 DH ER0}", "one another")]
    with open(pre_dir / "val.txt", "w") as f:
        for name, phones, raw in rows:
            f.write(f"{name}|LJSpeech|{phones}|{raw}\n")
            np.save(pre_dir / "wav" / f"LJSpeech-wav-{name}.npy",
                    _clip(name, 2048, start=SR))
    (pre_dir / "speakers.json").write_text('{"LJSpeech": 0}')
    shutil.copy(os.path.join(REPO, "preprocessed_data", "LJSpeech10",
                             "stats.json"), pre_dir)
    with open(f"{CONFIG}/preprocess.yaml") as f:
        pre = yaml.safe_load(f)
    pre["path"]["lexicon_path"] = f"{REPO}/{pre['path']['lexicon_path']}"
    pre["path"]["preprocessed_path"] = str(pre_dir)
    pre_path = tmp_path / "preprocess.yaml"
    pre_path.write_text(yaml.safe_dump(pre))
    configs = load_yaml_configs(str(pre_path), model_path, train_path)

    def args(name):
        return argparse.Namespace(objective=2, split="val",
                                  save_dir=str(tmp_path / name),
                                  vocoder_ckpt=VOCODER)

    model, cfg = load_model_for_inference(configs[0], configs[1], npz, "cpu")
    got = evaluate_cli.objective_eval(args("port"), configs[0], configs[1],
                                      model, cfg, torch.device("cpu"))
    jax_model, variables, jax_cfg = jax_load(configs, weights_npz=npz)
    ref = _objective_eval(args("jax"), configs, jax_model, variables,
                          jax_cfg)
    assert [r["name"] for r in got] == [r["name"] for r in ref] == [
        n for n, _, _ in rows]
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        assert g["raw_text"] == r["raw_text"]
        assert g["duration_ratio"] == r["duration_ratio"]
        assert g["mcd_db"] > 0
        assert abs(g["mcd_db"] - r["mcd_db"]) <= max(1e-5 * r["mcd_db"],
                                                     1e-3)
        _assert_f0_metrics(g, r, 800.0)
        w_got, w_ref = (wavfile.read(tmp_path / d / f"{g['name']}_tts.wav")
                        [1].astype(np.float64) for d in ("port", "jax"))
        assert w_got.shape == w_ref.shape
        np.testing.assert_allclose(w_got, w_ref, atol=1e-3 * FULL_SCALE,
                                   rtol=0)
    with open(tmp_path / "port" / "metrics.json") as f:
        saved = json.load(f)
    assert json.dumps(saved["rows"]) == json.dumps(got)   # NaN included
    assert saved["objective_mean"]["n"] == 2
