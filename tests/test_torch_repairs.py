"""PyTorch port, two faults held against the JAX package on the CPU.

1. MelGAN and Griffin-Lim at ``--dtype bfloat16``: the JAX vocoders divide
   the bfloat16 mel by ln 10 or apply exp to it in bfloat16
   (fastspeech2_tpu/synthesis/vocoder.py:124-125,155; ``jnp.log(10.0)`` is
   weakly typed, so it is rounded to bfloat16 too) before their first
   float32 operation.  Both synthesize CLIs run the tiny model of
   test_torch_port.py at bfloat16, the JAX one with XLA rounding at every
   bfloat16 value (test_torch_bf16.STRICT).
2. The README sentence on the tracked full-size acoustic weights: the
   acoustic forward alone, through both packages, at float32 and at
   bfloat16.  JAX's float32 result is committed as
   fastspeech2_tpu_torch/reference_data/readme_sentence_jax.npz, which
   chip_smoke.py holds the card against; a test here makes it anew from
   JAX and requires it to be equal, so it cannot go stale.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from fastspeech2_tpu_torch.audio import stft
from fastspeech2_tpu_torch.cli import synthesize_cli
from fastspeech2_tpu_torch.tools import readme_reference
from test_torch_bf16 import (
    PALLAS_INTERPRET,
    STRICT,
    _assert_calibrated,
    _strict_jax_cli,
)
from test_torch_port import CONFIG, REPO, README_SENTENCE, _tiny_setup
from test_torch_synthesis import MELGAN_NPZ, _jax_phase, _with_vocoder

FULL_SCALE = 32768
ACOUSTIC_NPZ = os.path.join(REPO, "weights", "acoustic_LJSpeech10_100k.npz")
# MelGAN's and Griffin-Lim's int16 wav at bfloat16, port against the JAX
# CLI with STRICT rounding: both feed the same bfloat16 mel (durations
# equal) through the same bfloat16 division or exp, so what is left is
# float32 convolution or FFT order and the rare bfloat16 flip of the tiny
# model's mel (test_torch_bf16.py): 2e-3 of full scale (measured: 1 LSB
# for both).  Dividing or applying exp in float32 instead gives 8.0e-3
# (MelGAN) and 0.18 (Griffin-Lim) of full scale on this model.
BF16_VOCODER_ATOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test suite runs several workers on the CPU at once; torch's own
    thread pool on top of them oversubscribes the cores, and the many small
    ops here (DIO's bands, the aligner's frame loop, a tiny model's steps)
    then wait on each other for tens of seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- 1. MelGAN and Griffin-Lim at bfloat16 ---------------------------------

@pytest.mark.parametrize("name,ckpt", [("MelGAN", MELGAN_NPZ),
                                       ("none", None)])
def test_vocoder_bf16_matches_strict_jax_cli(tmp_path, monkeypatch, name,
                                             ckpt):
    monkeypatch.chdir(REPO)
    model_path, train_path, npz = _tiny_setup(tmp_path)
    model_path = _with_vocoder(tmp_path, model_path, name)
    import yaml

    with open(model_path) as f:
        cfg = yaml.safe_load(f)
    with open(model_path, "w") as f:
        yaml.safe_dump(dict(cfg, **PALLAS_INTERPRET), f)
    argv = ["--mode", "single", "--text", README_SENTENCE,
            "-p", f"{CONFIG}/preprocess.yaml", "-m", model_path,
            "-t", train_path, "--weights_npz", npz, "--dtype", "bfloat16"]
    if ckpt:
        argv += ["--vocoder_ckpt", ckpt]
    name_wav = README_SENTENCE[:100] + ".wav"
    if ckpt is None:
        # Griffin-Lim's initial phase in the JAX CLI is PRNGKey(0)'s; the
        # port is handed the same numbers
        monkeypatch.setattr(stft, "random_phase", _jax_phase)
    _strict_jax_cli("synthesize_cli", argv)
    ref = wavfile.read(tmp_path / "jax_result" / name_wav)[1]
    wavs, out, paths = synthesize_cli.main(
        argv + ["--device", "cpu", "--result_path",
                str(tmp_path / "torch_result")])
    assert out.postnet_mel.dtype == torch.bfloat16
    got = wavfile.read(paths[0])[1]
    assert got.shape == ref.shape == (int(out.mel_len[0]) * 256,)
    assert np.abs(ref.astype(np.int32)).max() > 0
    err = np.abs(got.astype(np.float64) - ref.astype(np.float64)).max()
    assert err <= BF16_VOCODER_ATOL * FULL_SCALE, err / FULL_SCALE


# ---- 2. the README sentence on the tracked full-size weights ---------------

# the mel after the PostNet, port on the CPU against JAX on the CPU at
# float32, over the 253 spoken frames of O(1)-O(10) log-mel values: the same
# float32 sums in another order through 10 FFT blocks and the PostNet
# (5.7e-06 when this was written)
README_MEL_ATOL = 1e-4
# the fixture made anew against the committed one: the same JAX code on the
# same weights, so integers equal and floats within the few ulps another
# CPU's XLA code generation may move them
FIXTURE_RTOL, FIXTURE_ATOL = 1e-5, 1e-5


def _jax_readme(dtype):
    """The JAX package's forward of the README sentence -> (model,
    variables, cfg, ids, inference output as numpy, bins)."""
    from fastspeech2_tpu.cli.common import load_model_for_inference
    from fastspeech2_tpu.configs.config import load_yaml_configs
    from fastspeech2_tpu.models.variance import _make_bins
    from fastspeech2_tpu.synthesis import Synthesizer as JaxSynthesizer

    configs = load_yaml_configs(f"{CONFIG}/preprocess.yaml",
                                f"{CONFIG}/model.yaml",
                                f"{CONFIG}/train.yaml")
    model, variables, cfg = load_model_for_inference(
        configs, dtype=dtype, weights_npz=ACOUSTIC_NPZ)
    ids, _ = JaxSynthesizer(model, variables, cfg, configs[0]).text_to_ids(
        README_SENTENCE)
    bins = (np.asarray(_make_bins(cfg.pitch_min, cfg.pitch_max, cfg.n_bins,
                                  cfg.pitch_quantization)),
            np.asarray(_make_bins(cfg.energy_min, cfg.energy_max,
                                  cfg.n_bins, cfg.energy_quantization)))
    return model, variables, cfg, np.asarray(ids), bins


def _padded(ids, values=None, dtype=np.int32):
    """[1, P] with P the Synthesizer's text bucket (16) over len(ids)."""
    P = -(-len(ids) // 16) * 16
    out = np.zeros((1, P), dtype)
    out[0, : len(ids)] = ids if values is None else values
    return out


def _jax_apply(model, variables, cfg, ids, targets=None):
    """model.apply in eval mode at cfg.max_seq_len frames, compiled with
    XLA rounding at every bfloat16 value (STRICT); ``targets``: (pitch,
    energy, durations) per phone to teacher-force."""
    args = [jnp.zeros((1,), jnp.int32), jnp.asarray(_padded(ids)),
            jnp.asarray([len(ids)], jnp.int32)]
    if targets is not None:
        p, e, d = targets
        args += [jnp.asarray([int(np.sum(d))], jnp.int32),
                 jnp.asarray(_padded(ids, p, np.float32)),
                 jnp.asarray(_padded(ids, e, np.float32)),
                 jnp.asarray(_padded(ids, d))]

    def fn(variables, spk, texts, src_lens, *tg):
        kwargs = {}
        if tg:
            kwargs = dict(mel_lens=tg[0], p_targets=tg[1], e_targets=tg[2],
                          d_targets=tg[3])
        return model.apply(variables, spk, texts, src_lens,
                           max_mel_len=cfg.max_seq_len, train=False,
                           **kwargs)

    out = jax.jit(fn).lower(variables, *args).compile(
        compiler_options=STRICT)(variables, *args)
    return out


def _as_arrays(out):
    f = lambda x: np.asarray(jax.device_get(x)).astype(np.float32)  # noqa
    return dict(durations=np.asarray(out.duration_rounded),
                mel_len=np.asarray(out.mel_len), postnet_mel=f(
                    out.postnet_mel), pitch_prediction=f(out.pitch_prediction),
                energy_prediction=f(out.energy_prediction))


def _port_model(dtype):
    from fastspeech2_tpu_torch.cli.synthesize_cli import (
        load_model_for_inference,
    )
    from fastspeech2_tpu_torch.configs.config import load_yaml_configs

    pre, model_cfg, _ = load_yaml_configs(
        f"{CONFIG}/preprocess.yaml", f"{CONFIG}/model.yaml",
        f"{CONFIG}/train.yaml")
    return load_model_for_inference(pre, model_cfg, ACOUSTIC_NPZ, "cpu",
                                    dtype=dtype)[0]


def _port_apply(model, ids, targets=None):
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    kwargs = {}
    if targets is not None:
        p, e, d = targets
        kwargs = dict(mel_lens=t([int(np.sum(d))]).long(),
                      p_targets=t(_padded(ids, p, np.float32)),
                      e_targets=t(_padded(ids, e, np.float32)),
                      d_targets=t(_padded(ids, d)).long())
    with torch.inference_mode():
        return model(torch.zeros(1, dtype=torch.long),
                     t(_padded(ids)).long(), t([len(ids)]).long(),
                     max_mel_len=model.cfg.max_seq_len, **kwargs)


def _duration_margins(log_d):
    """|exp(log_d) - 1 - nearest rounding edge k + 0.5| per phone."""
    raw = np.exp(np.asarray(log_d, np.float64)) - 1.0
    return np.abs(raw - (np.floor(raw) + 0.5))


@pytest.fixture(scope="module")
def jax_f32():
    model, variables, cfg, ids, bins = _jax_readme(jnp.float32)
    out = _jax_apply(model, variables, cfg, ids)
    return ids, readme_reference.record(ids, _as_arrays(out), *bins), bins


def test_readme_fixture_is_jax_float32(jax_f32):
    """The committed npz is what the JAX package computes now."""
    _, rec, _ = jax_f32
    committed = readme_reference.load_fixture()
    assert os.path.getsize(readme_reference.FIXTURE) < 200 * 1024
    for name in readme_reference.FIELDS:
        if committed[name].dtype.kind == "i":
            np.testing.assert_array_equal(rec[name], committed[name], name)
        else:
            np.testing.assert_allclose(rec[name], committed[name],
                                       rtol=FIXTURE_RTOL, atol=FIXTURE_ATOL,
                                       err_msg=name)


def test_readme_float32_matches_jax(jax_f32):
    """The port's forward on the CPU at float32, through its Synthesizer:
    the IDs, durations and bucket ids exactly, the mel to README_MEL_ATOL."""
    ids, ref, bins = jax_f32
    got, port_bins = readme_reference.port_forward("cpu")
    for a, b in zip(bins, port_bins):
        np.testing.assert_array_equal(a, b)
    report = readme_reference.compare(got, ref, bins)
    assert report["ids_equal"] and report["durations_equal"], report
    assert report["bucket_flips"] == {"pitch": [], "energy": []}, report
    assert report["mel_frames"][0] == report["mel_frames"][1] > 0
    assert report["mel_max_abs_diff"] <= README_MEL_ATOL, report


def test_readme_bf16_matches_jax_with_pinned_variances(jax_f32, capsys):
    """At bfloat16: the inference forwards' durations and buckets that
    differ are reported with their margins (printed); then both packages
    are teacher-forced on JAX's bfloat16 durations and predictions, which
    pins every bucket, and the mel is held to test_torch_bf16.py's
    calibrated bound (the port at bfloat16 no further from JAX at bfloat16
    than JAX at bfloat16 lies from JAX at float32 on the same pinned
    forward)."""
    ids, _, bins = jax_f32
    model, variables, cfg, _, _ = _jax_readme(jnp.bfloat16)
    ref = _jax_apply(model, variables, cfg, ids)
    port = _port_model(torch.bfloat16)
    got = _port_apply(port, ids)
    n = len(ids)
    ref_d = np.asarray(ref.duration_rounded)[0, :n]
    got_d = got.duration_rounded.numpy()[0, :n]
    d_margin = _duration_margins(np.asarray(
        ref.log_duration_prediction, np.float32)[0, :n])
    report = {"durations": [(int(i), float(d_margin[i]))
                            for i in np.nonzero(got_d != ref_d)[0]]}
    for name, edges in zip(("pitch", "energy"), bins):
        r = np.asarray(getattr(ref, f"{name}_prediction"),
                       np.float32)[0, :n]
        g = getattr(got, f"{name}_prediction").float().numpy()[0, :n]
        flip = np.nonzero(np.searchsorted(edges, r, side="left")
                          != np.searchsorted(edges, g, side="left"))[0]
        m = readme_reference.margins(r, edges)
        report[name] = [(int(i), float(m[i])) for i in flip]
    with capsys.disabled():
        print(f"\n[readme bf16] phones differing from JAX (index, margin "
              f"of JAX's value to the rounding or bin edge): {report}")

    targets = (np.asarray(ref.pitch_prediction, np.float32)[0, :n],
               np.asarray(ref.energy_prediction, np.float32)[0, :n], ref_d)
    pinned = _port_apply(port, ids, targets)
    pinned_ref = _jax_apply(model, variables, cfg, ids, targets)
    model32, variables32, cfg32, _, _ = _jax_readme(jnp.float32)
    pinned_ref32 = _jax_apply(model32, variables32, cfg32, ids, targets)
    pinned32 = _port_apply(_port_model(torch.float32), ids, targets)
    _assert_calibrated(pinned, pinned_ref, pinned_ref32, pinned32,
                       ("mel", "postnet_mel"))


def write_fixture(path=readme_reference.FIXTURE):
    """Make the committed npz: ``JAX_PLATFORMS=cpu python
    tests/test_torch_repairs.py`` from the repository root."""
    model, variables, cfg, ids, bins = _jax_readme(jnp.float32)
    rec = readme_reference.record(
        ids, _as_arrays(_jax_apply(model, variables, cfg, ids)), *bins)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **rec)
    return rec


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print({k: v.shape for k, v in write_fixture().items()})
