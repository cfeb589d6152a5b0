"""PyTorch port, models: the acoustic model and the iSTFT vocoder held
against the JAX package on the same weights and inputs, plus the weight
map on the tracked npz snapshots.

The JAX model is initialised at a tiny size (tests/helpers.py); its
parameters go through ``from_jax_params`` into the port.  Every
FastSpeech2Output field is compared: teacher-forced to 1e-4 (float32, ten
layers of sums in another order), and in inference mode after checking
that the rounded durations are identical.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_tpu.convert.to_torch import (
    fastspeech2_state_dict_to_torch,
    hifigan_state_dict_to_torch,
)
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JaxFastSpeech2
from fastspeech2_tpu.models.hifigan_istft import (
    HiFiGANiSTFTGenerator as JaxISTFTGenerator,
)
from fastspeech2_tpu.models.hifigan_istft import (
    overlap_add_istft as jax_overlap_add_istft,
)
from fastspeech2_tpu_torch.configs.config import (
    FastSpeech2Config,
    load_yaml_configs,
)
from fastspeech2_tpu_torch.models.common import Dropout
from fastspeech2_tpu_torch.models.fastspeech2 import (
    FastSpeech2,
    FastSpeech2Output,
)
from fastspeech2_tpu_torch.models.hifigan_istft import (
    HiFiGANiSTFTGenerator,
    overlap_add_istft,
)
from fastspeech2_tpu_torch.synthesis.vocoder import get_vocoder
from fastspeech2_tpu_torch.utils.params_io import (
    from_jax_params,
    hifigan_from_jax_params,
    load_variables_npz,
)
from helpers import init_variables, synthetic_batch, tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "LJSpeech10")


@pytest.fixture
def in_repo(monkeypatch):
    # the dataset configs name their corpus files relative to the repo root
    monkeypatch.chdir(REPO)


def _numpy_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(jax.device_get(tree))


def _perturb_vectors(tree, rng, path=""):
    """Give every 1-D parameter (LayerNorm/BatchNorm scales, biases, running
    stats) random values so that the weight map is tested on them too."""
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}"
        if isinstance(v, dict):
            out[k] = _perturb_vectors(v, rng, p)
        elif v.ndim == 1:
            if k in ("scale", "var"):
                out[k] = (1.0 + 0.2 * rng.uniform(-1, 1, v.shape)).astype(
                    np.float32)
            else:
                out[k] = (0.2 * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


def _port_config(jax_cfg):
    fields = FastSpeech2Config.__dataclass_fields__
    return FastSpeech2Config(**{f: getattr(jax_cfg, f) for f in fields})


# the LJSpeech layout (phoneme-level pitch/energy, one speaker), and the
# frame-level variance branches with a speaker embedding
VARIANTS = {
    "phoneme_level": dict(max_seq_len=48),
    "frame_level_multispeaker": dict(
        max_seq_len=48, pitch_feature_level="frame_level",
        energy_feature_level="frame_level", multi_speaker=True, n_speaker=3),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    jax_cfg = tiny_config(**VARIANTS[request.param])
    jax_model = JaxFastSpeech2(jax_cfg)
    batch = synthetic_batch(jax_cfg, B=3, P=10, T=40, seed=1)
    batch["speakers"] = np.arange(3, dtype=np.int32) % jax_cfg.n_speaker
    variables = _perturb_vectors(
        _numpy_tree(init_variables(jax_model, batch)),
        np.random.RandomState(0))
    # durations of a few frames per phone, so inference mode has frames
    variables["params"]["variance_adaptor"]["duration_predictor"][
        "linear_layer"]["Dense_0"]["bias"] = np.asarray([1.3], np.float32)
    cfg = _port_config(jax_cfg)
    model = FastSpeech2(cfg)
    model.load_state_dict(from_jax_params(variables, cfg))
    model.eval()
    return jax_model, variables, model, batch


def _compare_outputs(ref, got, atol):
    for name in FastSpeech2Output._fields:
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        assert r.shape == g.shape, name
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, atol=atol, rtol=0, err_msg=name)


def test_teacher_forced_outputs_match_jax(models):
    jax_model, variables, model, batch = models
    T = batch["mels"].shape[1]
    ref = jax_model.apply(
        variables, jnp.asarray(batch["speakers"]), jnp.asarray(batch["texts"]),
        jnp.asarray(batch["src_lens"]), mel_lens=jnp.asarray(batch["mel_lens"]),
        max_mel_len=T, p_targets=jnp.asarray(batch["pitches"]),
        e_targets=jnp.asarray(batch["energies"]),
        d_targets=jnp.asarray(batch["durations"]), train=False)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.inference_mode():
        got = model(t["speakers"], t["texts"], t["src_lens"],
                    mel_lens=t["mel_lens"], max_mel_len=T,
                    p_targets=t["pitches"], e_targets=t["energies"],
                    d_targets=t["durations"])
    _compare_outputs(ref, got, atol=1e-4)


@pytest.mark.parametrize("controls,max_mel_len,truncate", [
    ((1.0, 1.0, 1.0), 64, True),
    ((1.1, 0.9, 1.3), 96, False),   # past max_seq_len, decoder untruncated
    ((1.0, 1.0, 1.2), 96, True),    # past max_seq_len, decoder cut to 48
])
def test_inference_outputs_match_jax(models, controls, max_mel_len, truncate):
    jax_model, variables, model, batch = models
    p, e, d = controls
    ref = jax_model.apply(
        variables, jnp.asarray(batch["speakers"]), jnp.asarray(batch["texts"]),
        jnp.asarray(batch["src_lens"]), max_mel_len=max_mel_len,
        p_control=p, e_control=e, d_control=d, p_offset=0.05, e_offset=-0.05,
        train=False, truncate_decoder=truncate)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.inference_mode():
        got = model(t["speakers"], t["texts"], t["src_lens"],
                    max_mel_len=max_mel_len, p_control=p, e_control=e,
                    d_control=d, p_offset=0.05, e_offset=-0.05,
                    truncate_decoder=truncate)
    # the durations decide every frame: they must agree exactly first
    np.testing.assert_array_equal(got.duration_rounded.numpy(),
                                  np.asarray(ref.duration_rounded))
    assert got.mel_len.min() > 0
    _compare_outputs(ref, got, atol=1e-4)


def test_train_mode_outputs_and_batch_stats_match_jax(models):
    """Train mode against the JAX package's train=True where it is
    deterministic.  With the encoder, decoder and predictor dropout rates
    at 0 the pre-PostNet mel and the predictions are dropout-free, and the
    first PostNet BatchNorm's masked batch statistics (it sees the mel
    before any PostNet dropout) update the running mean and var as JAX
    does."""
    jax_model, variables, model, batch = models
    T = batch["mels"].shape[1]
    no_dropout = dataclasses.replace(jax_model.config, encoder_dropout=0.0,
                                     decoder_dropout=0.0, vp_dropout=0.0)
    ref, mutated = JaxFastSpeech2(no_dropout).apply(
        variables, jnp.asarray(batch["speakers"]),
        jnp.asarray(batch["texts"]), jnp.asarray(batch["src_lens"]),
        mel_lens=jnp.asarray(batch["mel_lens"]), max_mel_len=T,
        p_targets=jnp.asarray(batch["pitches"]),
        e_targets=jnp.asarray(batch["energies"]),
        d_targets=jnp.asarray(batch["durations"]), train=True,
        rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    state = {k: v.clone() for k, v in model.state_dict().items()}
    rates = {}
    for name, m in model.named_modules():
        if isinstance(m, Dropout) and not name.startswith("postnet"):
            rates[name], m.rate = m.rate, 0.0
    model.train()
    try:
        with torch.no_grad():
            got = model(t["speakers"], t["texts"], t["src_lens"],
                        mel_lens=t["mel_lens"], max_mel_len=T,
                        p_targets=t["pitches"], e_targets=t["energies"],
                        d_targets=t["durations"])
        bn = model.postnet.convolutions[0][1]
        stats = (bn.running_mean.clone(), bn.running_var.clone())
    finally:
        model.eval()
        for name, m in model.named_modules():
            if name in rates:
                m.rate = rates[name]
        model.load_state_dict(state)
    for name in ("mel", "pitch_prediction", "energy_prediction",
                 "log_duration_prediction"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-4,
                                   rtol=0, err_msg=name)
    ref_bn = mutated["batch_stats"]["postnet"]["bn_0"]
    np.testing.assert_allclose(stats[0].numpy(), np.asarray(ref_bn["mean"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(stats[1].numpy(), np.asarray(ref_bn["var"]),
                               atol=1e-5, rtol=0)


# ---- vocoder ---------------------------------------------------------------

TINY_ISTFT = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                  upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
                  resblock_dilation_sizes=((1, 3), (1, 3)),
                  gen_istft_n_fft=8, gen_istft_hop_size=2, n_mel_channels=8)


def test_istft_vocoder_matches_jax():
    rng = np.random.RandomState(2)
    mel = rng.randn(2, 13, 8).astype(np.float32)
    jax_gen = JaxISTFTGenerator(**TINY_ISTFT)
    params = _numpy_tree(jax_gen.init(jax.random.PRNGKey(1), jnp.asarray(mel)))
    ref = np.asarray(jax_gen.apply(params, jnp.asarray(mel)))

    gen = HiFiGANiSTFTGenerator(**TINY_ISTFT)
    gen.load_state_dict(hifigan_from_jax_params(params, n_upsamples=2,
                                                n_resblock_kernels=2))
    with torch.inference_mode():
        got = gen(torch.from_numpy(mel)).numpy()
    assert got.shape == (2, 13 * 4 * 2 * 2)
    np.testing.assert_allclose(got, ref, atol=1e-4 * max(1.0, np.abs(ref).max()),
                               rtol=0)


def test_overlap_add_istft_matches_jax():
    rng = np.random.RandomState(0)
    real, imag = (rng.randn(2, 20, 9).astype(np.float32) for _ in range(2))
    ref = np.asarray(jax_overlap_add_istft(jnp.asarray(real),
                                           jnp.asarray(imag), 16, 4))
    got = overlap_add_istft(torch.from_numpy(real), torch.from_numpy(imag),
                            16, 4).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


# ---- the tracked weights ---------------------------------------------------

def _ljspeech10_configs():
    return load_yaml_configs(f"{CONFIG}/preprocess.yaml",
                             f"{CONFIG}/model.yaml", f"{CONFIG}/train.yaml")


def test_config_build_matches_jax(in_repo):
    from fastspeech2_tpu.configs.config import (
        FastSpeech2Config as JaxFastSpeech2Config,
    )

    pre, model_cfg, _ = _ljspeech10_configs()
    cfg = FastSpeech2Config.build(pre, model_cfg)
    assert cfg == _port_config(JaxFastSpeech2Config.build(pre, model_cfg))
    assert (cfg.encoder_hidden, cfg.conv_filter_size, cfg.max_seq_len) == (
        256, 1024, 1000)


def test_acoustic_npz_maps_every_array(in_repo):
    pre, model_cfg, _ = _ljspeech10_configs()
    cfg = FastSpeech2Config.build(pre, model_cfg)
    variables = load_variables_npz("weights/acoustic_LJSpeech10_100k.npz")
    sd = from_jax_params(variables, cfg)   # raises on an unmapped array
    result = FastSpeech2(cfg).load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    # names and transposes agree with the JAX package's torch exporter
    ref = fastspeech2_state_dict_to_torch(variables, cfg)
    extra = set(ref) - set(sd)
    assert extra == {"encoder.position_enc", "decoder.position_enc",
                     "variance_adaptor.pitch_bins",
                     "variance_adaptor.energy_bins"}
    for k, v in sd.items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0, msg=k)


def test_vocoder_npz_maps_every_array(in_repo):
    _, model_cfg, _ = _ljspeech10_configs()
    path = "weights/vocoder_gen_mixed60k.npz"
    gen = get_vocoder(model_cfg, None, path, "cpu")   # strict load inside
    with open("fastspeech2_tpu_torch/configs/hifigan/config_istft.json") as f:
        config = json.load(f)
    params = load_variables_npz(path)
    sd = hifigan_from_jax_params(params, len(config["upsample_rates"]))
    ref = hifigan_state_dict_to_torch(params, tuple(config["upsample_rates"]))
    assert set(sd) == set(ref) == set(gen.state_dict())
    for k, v in sd.items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0, msg=k)


def test_unmapped_array_raises():
    variables = {"params": {"conv_pre": {"kernel": np.zeros((7, 8, 16)),
                                         "bias": np.zeros(16)},
                            "conv_post": {"kernel": np.zeros((7, 16, 2)),
                                          "bias": np.zeros(2)},
                            "stray": {"kernel": np.zeros(3)}}}
    with pytest.raises(ValueError, match="stray"):
        hifigan_from_jax_params(variables, n_upsamples=0)
