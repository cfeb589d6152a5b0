"""PyTorch port, the export side of vocoder training, against the JAX
package on the CPU: ``export_mels_cli`` against the JAX CLI on the same
tiny features and weights (``--teacher_force d`` and ``pde``), the
acoustic and the vocoder export of ``export_cli`` against
``fastspeech2_tpu/convert/to_torch.py`` on the same weights, key by key,
and the port's vocoder checkpoints through ``get_vocoder``.

The acoustic model is ``test_torch_port._tiny_setup``'s (JAX initialiser,
npz snapshot) on a synthetic corpus (``data/synthetic.py``); the
vocoders are tiny or, where ``get_vocoder`` builds the shipped topology,
the full-width C8C8I generator on an 8-frame mel.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fastspeech2_tpu.cli.export_mels_cli import main as jax_export_mels
from fastspeech2_tpu.configs.config import (
    FastSpeech2Config as JaxFastSpeech2Config,
)
from fastspeech2_tpu.convert.to_torch import (
    save_torch_checkpoint,
    save_torch_vocoder_checkpoint,
)
from fastspeech2_tpu.models.hifigan import HiFiGANGenerator as JaxHiFiGAN
from fastspeech2_tpu.models.hifigan_istft import (
    HiFiGANiSTFTGenerator as JaxHiFiGANiSTFT,
)
from fastspeech2_tpu.utils.params_io import (
    load_variables_npz as jax_load_variables_npz,
)
from fastspeech2_tpu_torch.cli import (
    export_cli,
    export_mels_cli,
    synthesize_cli,
)
from fastspeech2_tpu_torch.configs.config import (
    FastSpeech2Config,
    load_yaml_configs,
)
from fastspeech2_tpu_torch.data.synthetic import (
    generate_corpus,
    synthetic_preprocess_config,
)
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_tpu_torch.models.hifigan_disc import HiFiGANDiscriminators
from fastspeech2_tpu_torch.synthesis.vocoder import (
    MelGANVocoder,
    build_generator,
    get_vocoder,
)
from fastspeech2_tpu_torch.training.checkpoint import (
    save_checkpoint,
    save_vocoder_checkpoint,
)
from fastspeech2_tpu_torch.training.vocoder import (
    VocoderAdamW,
    VocoderTrainState,
)
from fastspeech2_tpu_torch.utils.params_io import (
    from_jax_params,
    hifigan_from_jax_params,
    load_variables_npz,
)
from test_torch_port import _tiny_setup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_DISC = dict(periods=(2, 3), n_scales=2, period_channels=(4, 8),
                 scale_layers=((8, 15, 1, 1), (16, 41, 4, 4), (16, 5, 1, 1)))


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A synthetic 80-mel corpus, the tiny acoustic model's yamls and npz
    -> (preprocess yaml, model yaml, train yaml, npz, preprocess dict)."""
    tmp = tmp_path_factory.mktemp("export")
    corpus = str(tmp / "corpus")
    generate_corpus(corpus, n_utterances=7, seed=3, val_size=2, n_mels=80)
    pre = synthetic_preprocess_config(corpus, n_mels=80)
    pre_path = tmp / "preprocess.yaml"
    pre_path.write_text(yaml.safe_dump(pre))
    model_path, train_path, npz = _tiny_setup(tmp, max_seq_len=256)
    with open(train_path) as f:
        train_cfg = yaml.safe_load(f)
    train_cfg["path"]["ckpt_path"] = str(tmp / "ckpt")
    train_cfg["bucket"] = {"text": 8, "mel": 32}
    with open(train_path, "w") as f:
        yaml.safe_dump(train_cfg, f)
    return str(pre_path), model_path, train_path, npz, pre


def _mel_preds(pre):
    out = os.path.join(pre["path"]["preprocessed_path"], "mel_pred")
    return {n: np.load(os.path.join(out, n)) for n in sorted(os.listdir(out))}


@pytest.mark.parametrize("force", ["d", "pde"])
def test_export_mels_matches_jax_cli(workspace, force):
    """Both CLIs over train.txt (5 utterances, batches of 4 and 1): the
    same files, each [mel_len, 80] with the ground-truth frame count, the
    port's within 1e-4 of the JAX CLI's (float32).  Measured: d 5.7e-07,
    pde 6.0e-07."""
    pre_path, model_path, train_path, npz, pre = workspace
    argv = ["-p", pre_path, "-m", model_path, "-t", train_path,
            "--weights_npz", npz, "--batch_size", "4",
            "--teacher_force", force]
    assert jax_export_mels(argv) == 5
    ref = _mel_preds(pre)
    assert export_mels_cli.main(argv + ["--device", "cpu"]) == 5
    got = _mel_preds(pre)
    assert sorted(got) == sorted(ref) and len(got) == 5
    mel_dir = os.path.join(pre["path"]["preprocessed_path"], "mel")
    worst = 0.0
    for name, r in ref.items():
        gt = np.load(os.path.join(mel_dir, name))
        assert got[name].shape == r.shape == gt.shape
        assert got[name].dtype == np.float32
        worst = max(worst, float(np.abs(got[name] - r).max()))
    assert worst <= 1e-4, worst


def test_acoustic_export_matches_to_torch(workspace, tmp_path):
    """export_cli --restore_step on a port checkpoint of the tiny weights
    against to_torch.save_torch_checkpoint on the same npz: the same keys
    and every tensor equal; the export loads through the synthesize CLI's
    --torch_ckpt and gives the npz's forward bit for bit."""
    pre_path, model_path, train_path, npz, _ = workspace
    configs = load_yaml_configs(pre_path, model_path, train_path)
    cfg = FastSpeech2Config.build(configs[0], configs[1])
    model = FastSpeech2(cfg)
    model.load_state_dict(from_jax_params(load_variables_npz(npz), cfg))
    save_checkpoint(configs[2]["path"]["ckpt_path"], model, None, 7)
    out = str(tmp_path / "acoustic.pth.tar")
    export_cli.main(["--restore_step", "7", "-p", pre_path, "-m",
                     model_path, "-t", train_path, "-o", out])
    ref_path = str(tmp_path / "ref.pth.tar")
    save_torch_checkpoint(ref_path, jax_load_variables_npz(npz),
                          JaxFastSpeech2Config.build(configs[0], configs[1]))
    got = torch.load(out, weights_only=True)
    ref = torch.load(ref_path, weights_only=True)
    assert got["optimizer"] == ref["optimizer"] == {}
    assert sorted(got["model"]) == sorted(ref["model"])
    for k, v in ref["model"].items():
        assert got["model"][k].dtype == v.dtype, k
        assert torch.equal(got["model"][k], v), k

    loaded, _ = synthesize_cli.load_model_for_inference(
        configs[0], configs[1], None, "cpu", torch_ckpt=out)
    texts = torch.tensor([[3, 4, 5, 6, 7, 0, 0, 0]])
    with torch.inference_mode():
        a = loaded(torch.zeros(1, dtype=torch.long), texts,
                   torch.tensor([5]))
        b = model.eval()(torch.zeros(1, dtype=torch.long), texts,
                         torch.tensor([5]))
    assert torch.equal(a.postnet_mel, b.postnet_mel)


VOCODERS = {
    "parity": (JaxHiFiGAN, dict(
        upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
        upsample_initial_channel=16, resblock_kernel_sizes=(3, 7),
        resblock_dilation_sizes=((1, 3), (1, 3)))),
    "istft": (JaxHiFiGANiSTFT, dict(
        upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
        upsample_initial_channel=16, resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3),), gen_istft_n_fft=16,
        gen_istft_hop_size=4)),
}


def _train_state(gen, config):
    disc = HiFiGANDiscriminators(**TINY_DISC)
    return VocoderTrainState(gen, disc, VocoderAdamW(gen.parameters()),
                             VocoderAdamW(disc.parameters()), config, 3)


@pytest.mark.parametrize("kind", sorted(VOCODERS))
def test_vocoder_export_matches_to_torch(kind, tmp_path, capsys):
    """A port vocoder checkpoint whose generator holds the JAX
    initialiser's parameters -> export_cli --vocoder_ckpt against
    to_torch.save_torch_vocoder_checkpoint on those parameters: the same
    keys, every tensor equal; the iSTFT topology note as the JAX CLI
    prints it."""
    cls, kw = VOCODERS[kind]
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        cls(**kw, n_mel_channels=80).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 8, 80)))["params"])
    n_ups, n_k = len(kw["upsample_rates"]), len(kw["resblock_kernel_sizes"])
    config = dict(kw, num_mels=80)
    gen = build_generator(config, fused=False)
    gen.load_state_dict(hifigan_from_jax_params(params, n_ups, n_k))
    ckpt = save_vocoder_checkpoint(str(tmp_path / "voc"),
                                   _train_state(gen, config), 3)
    out = str(tmp_path / "lean.pth.tar")
    export_cli.main(["--vocoder_ckpt", ckpt, "-o", out])
    printed = capsys.readouterr().out
    ref_path = str(tmp_path / "ref.pth.tar")
    save_torch_vocoder_checkpoint(ref_path, {"params": params},
                                  upsample_rates=(1,) * n_ups,
                                  n_resblock_kernels=n_k)
    got = torch.load(out, weights_only=True)
    ref = torch.load(ref_path, weights_only=True)
    assert list(got) == list(ref) == ["generator"]
    assert sorted(got["generator"]) == sorted(ref["generator"])
    for k, v in ref["generator"].items():
        assert torch.equal(got["generator"][k], v), k
    assert ("iSTFT-variant topology" in printed) == (kind == "istft")


def test_vocoder_checkpoints_through_get_vocoder(tmp_path, capsys):
    """The full-width C8C8I generator (seeded init) in a train-state
    checkpoint, and its lean export, through get_vocoder with vocoder.model
    HiFi-GAN-iSTFT: the same wav as the generator in memory, bit for bit.
    A tiny MelGAN train state rebuilds its own topology from the
    checkpoint's generator_config."""
    import json

    with open(os.path.join(REPO, "fastspeech2_tpu_torch", "configs",
                           "hifigan", "config_istft.json")) as f:
        config = json.load(f)
    torch.manual_seed(11)
    gen = build_generator(config, fused=False).eval()
    ckpt = save_vocoder_checkpoint(str(tmp_path / "voc"),
                                   _train_state(gen, config), 5)
    lean = str(tmp_path / "lean.pth.tar")
    export_cli.main(["--vocoder_ckpt", ckpt, "-o", lean])
    mel = torch.from_numpy(np.random.default_rng(0).uniform(
        -8, 0, (1, 8, 80)).astype(np.float32))
    with torch.inference_mode():
        want = gen(mel)
        for path in (ckpt, lean):
            voc = get_vocoder({"vocoder": {"model": "HiFi-GAN-iSTFT"}},
                              None, path, "cpu")
            assert torch.equal(voc(mel), want), path
    with pytest.raises(ValueError, match="not one for vocoder.model"):
        get_vocoder({"vocoder": {"model": "MelGAN"}}, None, ckpt, "cpu")

    melgan_cfg = {"arch": "melgan", "upsample_rates": (8, 8, 2, 2),
                  "ngf": 4, "n_residual_layers": 1, "num_mels": 80}
    mg = build_generator(melgan_cfg).eval()
    mckpt = save_vocoder_checkpoint(str(tmp_path / "melgan"),
                                    _train_state(mg, melgan_cfg), 2)
    export_cli.main(["--vocoder_ckpt", mckpt, "-o",
                     str(tmp_path / "melgan_lean.pth.tar")])
    assert "MelGAN topology" in capsys.readouterr().out
    voc = get_vocoder({"vocoder": {"model": "MelGAN"}}, None, mckpt, "cpu")
    assert isinstance(voc, MelGANVocoder)
    with torch.inference_mode():
        assert torch.equal(voc(mel), MelGANVocoder(mg)(mel))


def test_entry_points_run_on_the_card_unless_told(workspace, tmp_path,
                                                  monkeypatch):
    """Without --device cpu the new entry points ask for CUDA and raise
    where there is none; --data_parallel 2 raises outside a world of 2
    ranks."""
    from fastspeech2_tpu_torch.cli import train_vocoder_cli

    pre_path, model_path, train_path, npz, _ = workspace
    with pytest.raises(ValueError, match="world of 2 ranks"):
        train_vocoder_cli.main(["--wav_dir", str(tmp_path), "--out_dir",
                                str(tmp_path / "o"), "--data_parallel", "2",
                                "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_mels_cli.main(["-p", pre_path, "-m", model_path, "-t",
                              train_path, "--weights_npz", npz])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_vocoder_cli.main(["--wav_dir", str(tmp_path), "--out_dir",
                                str(tmp_path / "o")])
