"""PyTorch port, the train loop's duties and ``evaluate --synth``, held
against the JAX package on the CPU: ``synth_one_sample``'s figure and
wavs, the TensorBoard logger (with and without tensorboardX and
matplotlib), the synth_step duty through the train CLI with its
``--profile_dir`` trace, and the evaluate CLI's ``--synth`` files.

Both packages get the tiny acoustic model of ``test_torch_port._tiny_setup``
(or the synthetic corpus of ``test_torch_train._tiny_workspace``) and the
tracked HiFi-GAN-iSTFT snapshot.  Tolerances: the figure's mel to 1e-4 of
its largest |value| (the forwards agree to ~1e-5, test_torch_port.py), its
pitch and energy curves exactly (they are the batch's own values); the
wavs to 1e-3 of full scale, as test_torch_port.py holds the CLI's wav.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from fastspeech2_tpu.synthesis.vocoder import get_vocoder as jax_get_vocoder
from fastspeech2_tpu.training.loop import (
    synth_one_sample as jax_synth_one_sample,
)
from fastspeech2_tpu_torch.cli import evaluate_cli, train_cli
from fastspeech2_tpu_torch.synthesis.vocoder import get_vocoder
from fastspeech2_tpu_torch.training import loop
from fastspeech2_tpu_torch.utils.logging import TrainLogger
from helpers import synthetic_batch, tiny_config
from test_torch_port import CONFIG, REPO, VOCODER, _tiny_setup
from test_torch_synthesis import MELGAN_NPZ
from test_torch_train import _tiny_workspace

FULL_SCALE = 32768
# the bfloat16 duty's mel, port against strict JAX: both round at the same
# points, a float32 sum in another order may land one bfloat16 ulp (at the
# largest |value|) away; and its MelGAN wav, as test_torch_repairs.py holds
# the bfloat16 CLI's
BF16_ULPS = 2
BF16_DUTY_WAV_ATOL = 2e-3


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


def _figure_data(fig):
    """Every image array and line of a figure, in axis order."""
    out = []
    for ax in fig.axes:
        out += [np.asarray(im.get_array(), np.float64) for im in ax.images]
        out += [np.asarray(ln.get_ydata(), np.float64) for ln in ax.lines]
    return out


class _State:
    """What JAX's synth_one_sample reads of a TrainState."""

    def __init__(self, variables):
        self._variables = variables

    def variables(self):
        return self._variables


def _both_samples(tmp_path, dtype="float32", vocoder=None, ckpt=VOCODER):
    """synth_one_sample of both packages on the tiny model and one row of a
    synthetic batch, at ``dtype`` (bfloat16: JAX compiled to round at every
    bfloat16 value, with the Pallas kernels the port's K1 and K2 follow),
    with ``vocoder`` (model.yaml's name; the tiny setup's iSTFT by
    default) from ``ckpt`` -> (the port's, JAX's, the batch)."""
    import functools

    import jax
    import jax.numpy as jnp

    from fastspeech2_tpu.cli.common import load_model_for_inference
    from fastspeech2_tpu.configs.config import load_yaml_configs
    from fastspeech2_tpu_torch.cli.synthesize_cli import (
        load_model_for_inference as port_load,
    )
    from fastspeech2_tpu_torch.configs.config import (
        load_yaml_configs as port_yaml,
    )
    from test_torch_bf16 import PALLAS_INTERPRET, STRICT

    model_path, train_path, npz = _tiny_setup(tmp_path)
    with open(model_path) as f:
        model_yaml = yaml.safe_load(f)
    if vocoder is not None:
        model_yaml["vocoder"]["model"] = vocoder
    if dtype == "bfloat16":
        model_yaml.update(PALLAS_INTERPRET)
    with open(model_path, "w") as f:
        yaml.safe_dump(model_yaml, f)
    pre_path = f"{CONFIG}/preprocess.yaml"
    configs = load_yaml_configs(pre_path, model_path, train_path)
    jax_model, variables, jax_cfg = load_model_for_inference(
        configs, dtype=getattr(jnp, dtype), weights_npz=npz)
    batch = synthetic_batch(tiny_config(encoder_layer=1, decoder_layer=2,
                                        n_mel_channels=80, max_seq_len=64,
                                        postnet_n_convolutions=3),
                            B=2, P=12, T=48, seed=8)
    batch["ids"] = ["a", "b"]

    def strict_apply(variables, *args, max_mel_len, train, **kwargs):
        fn = jax.jit(functools.partial(jax_model.apply,
                                       max_mel_len=max_mel_len, train=train))
        return fn.lower(variables, *args, **kwargs).compile(
            compiler_options=STRICT)(variables, *args, **kwargs)

    ref = jax_synth_one_sample(
        jax_model, jax_cfg, _State(variables), batch, configs[0],
        jax_get_vocoder(configs[1], configs[0], ckpt),
        infer_fn=strict_apply if dtype == "bfloat16" else None)

    pre, model_cfg, _ = port_yaml(pre_path, model_path, train_path)
    model, _ = port_load(pre, model_cfg, npz, "cpu",
                         dtype=getattr(torch, dtype))
    model.train()
    got = loop.synth_one_sample(model, batch, pre,
                                get_vocoder(model_cfg, pre, ckpt, "cpu"))
    assert model.training     # the caller's mode comes back
    return got, ref, batch


def _assert_wavs(got, ref, batch, atol):
    for a, b in zip(got[1:], ref[1:]):
        assert a.dtype == b.dtype == np.int16
        assert a.shape == b.shape == (int(batch["mel_lens"][0]) * 256,)
        assert np.abs(b.astype(np.int32)).max() > 0
        np.testing.assert_allclose(a.astype(np.float64),
                                   b.astype(np.float64),
                                   atol=atol * FULL_SCALE, rtol=0)


def test_synth_one_sample_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)    # stats.json is named from the repo root
    got, ref, batch = _both_samples(tmp_path)
    got_data, ref_data = _figure_data(got[0]), _figure_data(ref[0])
    assert [a.shape for a in got_data] == [a.shape for a in ref_data]
    assert got_data[0].shape == (80, int(batch["mel_lens"][0]))
    for i, (a, b) in enumerate(zip(got_data, ref_data)):
        if b.ndim == 2:     # the synthesized and ground-truth mels
            np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max(),
                                       rtol=0, err_msg=str(i))
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(i))
    _assert_wavs(got, ref, batch, 1e-3)


def test_synth_one_sample_bf16_melgan_matches_strict_jax(tmp_path,
                                                         monkeypatch):
    """At bfloat16 the JAX duty hands the vocoder its mel upcast to
    float32 (fastspeech2_tpu/training/loop.py:164-166), so MelGAN divides
    by ln 10 in float32; dividing the bfloat16 mel instead moves the wav
    by BF16_DUTY_WAV_ATOL or more."""
    monkeypatch.chdir(REPO)
    got, ref, batch = _both_samples(tmp_path, "bfloat16", "MelGAN",
                                    MELGAN_NPZ)
    mel, ref_mel = _figure_data(got[0])[0], _figure_data(ref[0])[0]
    unit = 2.0 ** (np.floor(np.log2(np.abs(ref_mel).max())) - 7)
    assert np.abs(mel - ref_mel).max() <= BF16_ULPS * unit
    _assert_wavs(got, ref, batch, BF16_DUTY_WAV_ATOL)


def _block(monkeypatch, *modules):
    """Make ``import m`` raise ImportError for each module named."""
    for name in modules:
        monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.parametrize("tensorboard", [True, False])
def test_train_logger(tmp_path, monkeypatch, tensorboard):
    """With tensorboardX: an event file holds the scalars and the figure,
    and the audio too where soundfile is installed (else one line says so
    and it goes to a .wav file).  Without tensorboardX: one line says so,
    and the figure and the audio go to .png and .wav files."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    if not tensorboard:
        _block(monkeypatch, "tensorboardX")
    lines = []
    logger = TrainLogger(str(tmp_path / "log"), lines.append)
    logger.scalars(3, [1.0, 2, 3, 4, 5, 6])
    fig = plt.figure()
    logger.figure("Training/step_3_x", fig)
    plt.close(fig)
    logger.audio("Training/step_3_x_synthesized",
                 np.linspace(-2000, 2000, 512).astype(np.int16), 22050)
    logger.message("a line")
    logger.close()
    files = sorted(os.listdir(tmp_path / "log"))
    assert open(tmp_path / "log" / "log.txt").read() == "a line\n"
    if tensorboard:
        assert any(f.startswith("events.out.tfevents") for f in files)
        try:
            import soundfile  # noqa: F401
        except ImportError:
            assert len(lines) == 1 and "cannot write audio" in lines[0]
            assert "Training_step_3_x_synthesized.wav" in files
        else:
            assert lines == []
    else:
        assert len(lines) == 1 and "tensorboardX is not installed" in lines[0]
        assert files == ["Training_step_3_x.png",
                         "Training_step_3_x_synthesized.wav", "log.txt"]
        sr, wav = wavfile.read(tmp_path / "log" / files[1])
        assert sr == 22050 and np.abs(wav).max() == pytest.approx(1.0)


def _duty_workspace(tmp_path, **step):
    args, train_cfg = _tiny_workspace(tmp_path, n_mels=80, total_step=20)
    train_cfg["step"].update(step)
    with open(args[5], "w") as f:
        yaml.safe_dump(train_cfg, f)
    return args, train_cfg


@pytest.mark.parametrize("installed", [True, False])
def test_train_cli_synth_duty_and_profile(tmp_path, monkeypatch, capsys,
                                          installed):
    """20 steps through the train CLI on the CPU with synth_step 10,
    --vocoder_ckpt and --profile_dir: two samples (figure + both wavs),
    one trace of steps 11-20.  Without tensorboardX and matplotlib the
    wavs still come, and two lines say what is missing."""
    monkeypatch.chdir(REPO)
    if not installed:
        _block(monkeypatch, "tensorboardX", "matplotlib",
               "matplotlib.pyplot")
    args, train_cfg = _duty_workspace(tmp_path, synth_step=10, val_step=20,
                                      save_step=20)
    profile = tmp_path / "profile"
    samples = []
    inner = loop.synth_one_sample

    def spy(*a, **k):
        out = inner(*a, **k)
        samples.append(out)
        return out

    monkeypatch.setattr(loop, "synth_one_sample", spy)
    _, _, step = train_cli.main(args + [
        "--device", "cpu", "--dtype", "float32", "--vocoder_ckpt", VOCODER,
        "--profile_dir", str(profile)])
    out = capsys.readouterr().out
    assert step == 20
    # two synth_step samples and the validation pass's figure
    assert len(samples) == 3
    for fig, wav_rec, wav_pred in samples[:2]:
        assert (fig is not None) == installed
        assert wav_rec.dtype == np.int16 and wav_rec.shape == wav_pred.shape
        assert wav_rec.shape[0] % 256 == 0 and np.abs(wav_pred).max() > 0
    assert samples[2][1] is None
    assert [f for f in os.listdir(profile)] == ["trace_steps_11-20.json"]
    with open(profile / "trace_steps_11-20.json") as f:
        trace = json.load(f)
    assert any(e.get("name", "").startswith("aten::")
               for e in trace["traceEvents"])
    log_dir = os.path.join(train_cfg["path"]["log_path"], "train")
    written = os.listdir(log_dir)
    if installed:
        assert any(f.startswith("events.out.tfevents") for f in written)
    else:
        assert "tensorboardX is not installed" in out
        assert out.count("matplotlib is not installed") == 3
        wavs = sorted(f for f in written if f.endswith(".wav"))
        assert [w.split("_")[2] for w in wavs] == ["10", "10", "20", "20"]
        assert all(w.endswith(("_reconstructed.wav", "_synthesized.wav"))
                   for w in wavs)


def test_synth_duty_fault_raises(tmp_path, monkeypatch):
    """A failing vocoder launch in the duty stops training: only a missing
    matplotlib or tensorboardX is absorbed."""
    monkeypatch.chdir(REPO)
    args, _ = _duty_workspace(tmp_path, synth_step=1, val_step=20,
                              save_step=20)

    class Broken(torch.nn.Module):
        def forward(self, mels):
            raise RuntimeError("vocoder launch failed")

    monkeypatch.setattr(train_cli, "train", lambda *a, **k: loop.train(
        *a, **dict(k, vocoder=Broken())))
    with pytest.raises(RuntimeError, match="vocoder launch failed"):
        train_cli.main(args + ["--device", "cpu", "--max_steps", "1"])


def test_evaluate_cli_synth_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """Both evaluate CLIs with --synth on the same npz weights, synthetic
    val set and iSTFT snapshot: the two wavs."""
    from fastspeech2_tpu.cli.evaluate_cli import main as jax_main
    from test_torch_bf16 import _jax_npz

    monkeypatch.chdir(REPO)
    args, train_cfg = _tiny_workspace(tmp_path, n_mels=80)
    npz = _jax_npz(tmp_path, args, seed=6)
    common = args + ["--weights_npz", npz, "--synth", "--vocoder_ckpt",
                     VOCODER]
    result = train_cfg["path"]["result_path"]
    jax_main(common)
    names = ("val_step_0_reconstructed.wav", "val_step_0_synthesized.wav")
    refs = [wavfile.read(os.path.join(result, n))[1] for n in names]
    os.remove(os.path.join(result, "val_step_0.png"))
    evaluate_cli.main(common + ["--device", "cpu"])
    assert "Synth sample written to " in capsys.readouterr().out
    assert os.path.exists(os.path.join(result, "val_step_0.png"))
    for name, ref in zip(names, refs):
        sr, got = wavfile.read(os.path.join(result, name))
        assert sr == 22050 and got.dtype == ref.dtype == np.int16
        assert got.shape == ref.shape and got.shape[0] % 256 == 0
        np.testing.assert_allclose(got.astype(np.float64),
                                   ref.astype(np.float64),
                                   atol=1e-3 * FULL_SCALE, rtol=0)
