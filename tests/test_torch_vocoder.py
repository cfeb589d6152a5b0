"""PyTorch port, the vocoders, against the JAX package on the CPU: K4's
plain version against the Pallas kernel in interpret mode and against
``xla_resblock``; the full-width parity generator on one random init; the
C8C2I generator on its tracked weights; a reference ``.pth.tar`` with
weight norm loaded into both packages; MelGAN on its tracked weights and
from a melgan-neurips ``.pth.tar``; and ``get_vocoder``'s dispatch.

Inputs come from numpy seeds.  Tolerances, absolute in float32: 1e-4 on
ResBlock outputs of O(1) (the same sums of up to 2816 terms in another
order, through six convs) and 1e-4 on waveforms in [-1, 1].
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_tpu.convert.from_torch import melgan_params_from_torch
from fastspeech2_tpu.convert.to_torch import hifigan_state_dict_to_torch
from fastspeech2_tpu.models.hifigan import (
    HiFiGANGenerator as JaxHiFiGANGenerator,
)
from fastspeech2_tpu.ops.pallas_resblock import (
    _halo,
    fused_resblock as jax_fused_resblock,
    xla_resblock,
)
from fastspeech2_tpu.synthesis.vocoder import get_vocoder as jax_get_vocoder
from fastspeech2_tpu_torch.models.hifigan import HiFiGANGenerator, ResBlock
from fastspeech2_tpu_torch.models.hifigan_istft import HiFiGANiSTFTGenerator
from fastspeech2_tpu_torch.models.melgan import MelGANGenerator
from fastspeech2_tpu_torch.ops.cuda_resblock import (
    fused_resblock,
    pack_resblock_weights,
    plain_resblock,
)
from fastspeech2_tpu_torch.ops.tf32_pack import tf32_round, unpack_fragments
from fastspeech2_tpu_torch.synthesis import vocoder as vocoder_mod
from fastspeech2_tpu_torch.synthesis.vocoder import (
    GriffinLimVocoder,
    MelGANVocoder,
    get_vocoder,
)
from fastspeech2_tpu_torch.tools.kernel_bounds import (
    parity_resblock_shapes,
    resblock_bound_ms,
)
from fastspeech2_tpu_torch.utils.params_io import (
    hifigan_from_jax_params,
    load_variables_npz,
    melgan_from_jax_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DILS = (1, 3, 5)
ATOL = 1e-4


def _resblock_inputs(C, k, L, B=1, bias=0.5, seed=0):
    """JAX-layout x [B, L, C], w [3, k, C, C], b [3, C] (numpy), weights
    scaled to keep the output O(1); biases of size ``bias`` show a leak at
    the sequence edges."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, C), dtype=np.float32)
    scale = (C * k) ** -0.5
    w1, w2 = (rng.standard_normal((3, k, C, C), dtype=np.float32) * scale
              for _ in range(2))
    b1, b2 = (rng.standard_normal((3, C), dtype=np.float32) * bias
              for _ in range(2))
    return x, w1, b1, w2, b2


def _to_port(x, w1, b1, w2, b2):
    """JAX layouts -> x [B, C, L] and per-dilation Conv1d weights
    [C_out, C_in, k]."""
    def conv(w):
        return [torch.from_numpy(np.ascontiguousarray(w[u].transpose(2, 1, 0)))
                for u in range(w.shape[0])]

    return (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))),
            conv(w1), [torch.from_numpy(b) for b in b1],
            conv(w2), [torch.from_numpy(b) for b in b2])


def _port_resblock(args):
    out = plain_resblock(*_to_port(*args), DILS)
    return out.numpy().transpose(0, 2, 1)


# C = 32 and 64 are the tap-packed cases (G = 4 and 2); L = 512 is two 256
# tiles with the halo exchanged between them
@pytest.mark.parametrize("C", [32, 64])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_plain_resblock_matches_pallas_interpret(C, k):
    args = _resblock_inputs(C, k, 512, seed=C + k)
    ref = np.asarray(jax_fused_resblock(*map(jnp.asarray, args), DILS, True))
    np.testing.assert_allclose(_port_resblock(args), ref, atol=ATOL, rtol=0)


def test_plain_resblock_matches_pallas_wrapper_below_the_halo():
    """L = 40 <= the halo (60 at k = 11): the JAX wrapper takes
    xla_resblock there; K4 takes every L."""
    assert 40 <= _halo(11, DILS)
    args = _resblock_inputs(32, 11, 40, B=2, bias=2.0, seed=1)
    ref = np.asarray(jax_fused_resblock(*map(jnp.asarray, args), DILS, True))
    np.testing.assert_allclose(_port_resblock(args), ref, atol=ATOL, rtol=0)


# the parity generator's wide stages, at short L: a 1-frame mel gives L = 8
# at C = 256; L = 37 is ragged against everything
@pytest.mark.parametrize("C,L", [(256, 8), (256, 37), (128, 64), (128, 37)])
@pytest.mark.parametrize("k", [3, 11])
def test_plain_resblock_matches_xla_resblock(C, L, k):
    args = _resblock_inputs(C, k, L, B=2, bias=2.0, seed=L + k)
    ref = np.asarray(xla_resblock(*map(jnp.asarray, args), DILS))
    np.testing.assert_allclose(_port_resblock(args), ref, atol=ATOL, rtol=0)


def test_fused_resblock_on_cpu_is_the_plain_version():
    x, w1, b1, w2, b2 = _to_port(*_resblock_inputs(32, 7, 100))
    got = fused_resblock(x, w1, b1, w2, b2, DILS)
    assert torch.equal(got, plain_resblock(x, w1, b1, w2, b2, DILS))


def test_resblock_weight_pack_is_made_once_per_weight_change():
    block = ResBlock(32, 3, fused=True)
    weights = block._weights()
    first = block._packed(weights)
    assert block._packed(block._weights()) is first
    w1p, b1p, w2p, b2p = first
    # [U, C/16, k, C/8, 32 lanes, 8]: the TF32 planes in fragment order
    assert w1p.shape == (3, 2, 3, 4, 32, 8) and b2p.shape == (3, 32)

    def assert_planes_rebuild(packed, weight):
        """big = tf32(w) exactly, and big + small is w to ~2^-22."""
        big, small = unpack_fragments(packed)
        w = weight.detach().permute(2, 0, 1)     # [k, C_out, C_in]
        assert torch.equal(big, tf32_round(w))
        torch.testing.assert_close(big + small, w, rtol=2 ** -21, atol=0)

    assert_planes_rebuild(w1p[1], block.convs1[1].weight)
    with torch.no_grad():
        block.convs2[2].weight.mul_(2.0)
    second = block._packed(block._weights())
    assert second is not first
    assert_planes_rebuild(second[2][2], block.convs2[2].weight)
    block.to(torch.float64).to(torch.float32)
    assert block._pack is None


def test_only_the_parity_generator_runs_k4():
    """The route the generators fix: the parity generator's 12 ResBlocks
    and, since the H100 measurement put K4 ahead of cuDNN at the iSTFT's
    shapes, the iSTFT generator's 6 too; the ResBlocks of a generator
    built by hand keep their plain default."""
    parity = HiFiGANGenerator()
    istft = HiFiGANiSTFTGenerator()
    assert sum(isinstance(m, ResBlock) and m.fused
               for m in parity.modules()) == 12
    assert sum(isinstance(m, ResBlock) and m.fused
               for m in istft.modules()) == 6
    assert not ResBlock(32).fused


@pytest.fixture(scope="module")
def jax_parity():
    """The JAX parity generator (full width: 512 initial channels, 4 stages)
    and its PRNGKey(0) init, as the JAX vocoder makes it without weights."""
    gen = JaxHiFiGANGenerator()
    variables = jax.jit(gen.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8, 80)))
    return gen, jax.tree_util.tree_map(np.asarray, variables)


def _mel(frames, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, frames, 80), dtype=np.float32) - 4.0


@pytest.mark.parametrize("frames", [8, 1000])
def test_parity_generator_matches_jax(jax_parity, frames):
    gen, variables = jax_parity
    port = HiFiGANGenerator()
    port.load_state_dict(hifigan_from_jax_params(variables, 4, 3))
    mel = _mel(frames, frames)
    ref = np.asarray(jax.jit(gen.apply)(variables, jnp.asarray(mel)))
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == (1, frames * 256)
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_c8c2i_vocoder_matches_jax():
    path = os.path.join(REPO, "weights", "vocoder_c8c2i_50k.npz")
    model_config = {"vocoder": {"model": "HiFi-GAN-iSTFT-C8C2I"}}
    mel = _mel(40, 2)
    ref = np.asarray(jax_get_vocoder(model_config, None, path)(
        jnp.asarray(mel)))
    with torch.inference_mode():
        got = get_vocoder(model_config, None, path, "cpu")(
            torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == (1, 40 * 256)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def _weight_norm_split(sd, rng, plain=("conv_post",)):
    """Every conv weight w -> (weight_g, weight_v) with v = w * s for a
    random positive s per slice of axis 0 and g = ||w||, so that
    g * v / ||v|| = w; weights whose names start with one of ``plain``
    keep a plain .weight."""
    out = {}
    for key, value in sd.items():
        w = value.numpy()
        if key.endswith(".weight") and not key.startswith(plain):
            axes = tuple(range(1, w.ndim))
            s = rng.uniform(0.5, 2.0, (w.shape[0],) + (1,) * (w.ndim - 1))
            prefix = key[:-len(".weight")]
            out[prefix + ".weight_g"] = torch.from_numpy(
                np.sqrt((w * w).sum(axis=axes, keepdims=True)))
            out[prefix + ".weight_v"] = torch.from_numpy(
                (w * s).astype(np.float32))
        else:
            out[key] = value
    return out


def test_torch_checkpoint_with_weight_norm_loads_into_both(jax_parity,
                                                           tmp_path):
    _, variables = jax_parity
    sd = _weight_norm_split(hifigan_state_dict_to_torch(variables),
                            np.random.default_rng(0))
    assert "ups.3.weight_g" in sd and "conv_post.weight" in sd
    path = str(tmp_path / "generator_test.pth.tar")
    torch.save({"generator": sd}, path)
    model_config = {"vocoder": {"model": "HiFi-GAN"}}
    mel = _mel(8, 3)
    ref = np.asarray(jax_get_vocoder(model_config, None, path)(
        jnp.asarray(mel)))
    with torch.inference_mode():
        got = get_vocoder(model_config, None, path, "cpu")(
            torch.from_numpy(mel)).numpy()
        # the same weights as a bare state dict
        torch.save(sd, path)
        bare = get_vocoder(model_config, None, path, "cpu")(
            torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(bare, got)


def test_get_vocoder_without_weights(tmp_path, monkeypatch):
    model_config = {"vocoder": {"model": "HiFi-GAN", "speaker": "test"}}
    a, b = (get_vocoder(model_config, None, None, "cpu").state_dict()
            for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)   # a seeded init
    # generator_<speaker>.pth.tar beside the port's config is taken first
    for name in ("config.json", "config_istft.json"):
        os.symlink(os.path.join(vocoder_mod._HIFIGAN_DIR, name),
                   tmp_path / name)
    scaled = {k: v * 0.5 for k, v in a.items()}
    torch.save({"generator": scaled}, tmp_path / "generator_test.pth.tar")
    monkeypatch.setattr(vocoder_mod, "_HIFIGAN_DIR", str(tmp_path))
    got = get_vocoder(model_config, None, None, "cpu").state_dict()
    assert all(torch.equal(got[k], scaled[k]) for k in got)
    # the iSTFT generators never take the parity speaker's weights
    istft = get_vocoder({"vocoder": {"model": "HiFi-GAN-iSTFT",
                                     "speaker": "test"}}, None, None, "cpu")
    assert isinstance(istft, HiFiGANiSTFTGenerator)


def test_get_vocoder_refuses_what_is_not_ported(tmp_path):
    """Only the JAX vocoder trainer's orbax directories are refused (the
    port reads its own vocoder checkpoints), for HiFi-GAN and MelGAN
    alike; MelGAN and every other name (the tracked configs' ``none``:
    Griffin-Lim) are built."""
    for name in ("HiFi-GAN", "MelGAN"):
        with pytest.raises(NotImplementedError, match="orbax"):
            get_vocoder({"vocoder": {"model": name}}, None, str(tmp_path),
                        "cpu")
    pre = {"preprocessing": {
        "audio": {"sampling_rate": 22050},
        "stft": {"filter_length": 1024, "hop_length": 256,
                 "win_length": 1024},
        "mel": {"n_mel_channels": 80, "mel_fmin": 0, "mel_fmax": 8000}}}
    melgan = get_vocoder({"vocoder": {"model": "MelGAN"}}, pre, None, "cpu")
    assert isinstance(melgan, MelGANVocoder)
    assert not melgan.training
    for name in ("none", "Griffin-Lim"):
        gl = get_vocoder({"vocoder": {"model": name}}, pre, None, "cpu")
        assert isinstance(gl, GriffinLimVocoder)
        assert (gl.n_fft, gl.hop, gl.win, gl.n_iters) == (1024, 256, 1024,
                                                          30)


def test_kernel_bounds_count_all_twelve_resblocks():
    shapes = parity_resblock_shapes(1000)
    assert len(shapes) == 12
    assert {(C, L) for C, L, _ in shapes} == {
        (256, 8000), (128, 64000), (64, 128000), (32, 256000)}
    # the SIMT float32 bound; the 3xTF32 one is pinned in
    # tests/test_torch_conv_tiles.py
    total = sum(resblock_bound_ms(1, L, C, k)[2] for C, L, k in shapes)
    flops = sum(resblock_bound_ms(1, L, C, k)[3] for C, L, k in shapes)
    assert abs(total - 8.8738) < 1e-3
    assert abs(flops - 594.5e9) < 0.1e9


# ---- MelGAN ----------------------------------------------------------------

MELGAN_NPZ = os.path.join(REPO, "weights", "vocoder_melgan_30k.npz")
MELGAN = {"vocoder": {"model": "MelGAN"}}


@pytest.fixture(scope="module")
def jax_melgan():
    """The JAX package's MelGAN vocoder on the tracked snapshot (ngf 32,
    rates 8, 8, 2, 2: full width)."""
    return jax_get_vocoder(MELGAN, None, MELGAN_NPZ)


@pytest.mark.parametrize("frames", [8, 200])
def test_melgan_generator_matches_jax(jax_melgan, frames):
    mel = _mel(frames, frames + 1) / np.float32(np.log(10.0))
    ref = np.asarray(jax.jit(jax_melgan.generator.apply)(
        jax_melgan.params, jnp.asarray(mel)))
    gen = MelGANGenerator()
    gen.load_state_dict(melgan_from_jax_params(load_variables_npz(
        MELGAN_NPZ)))
    with torch.inference_mode():
        got = gen.eval()(torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == (1, frames * 256)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_melgan_vocoder_takes_log10_mels(jax_melgan):
    """MelGANVocoder divides the log-e mel by ln 10 before the generator,
    as the JAX package's does."""
    mel = _mel(16, 5)
    ref = np.asarray(jax_melgan(jnp.asarray(mel)))
    vocoder = get_vocoder(MELGAN, None, MELGAN_NPZ, "cpu")
    assert isinstance(vocoder, MelGANVocoder)
    with torch.inference_mode():
        got = vocoder(torch.from_numpy(mel)).numpy()
        direct = vocoder.generator(torch.from_numpy(mel) / np.log(10.0))
        undivided = vocoder.generator(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got, direct.numpy())
    assert np.abs(undivided - ref).max() > 100 * ATOL


def test_melgan_npz_maps_every_array():
    """Every array of the snapshot is mapped (an array left over raises,
    the strict load catches a missing one), and the JAX package's
    melgan-neurips importer reads the port's state dict back into the
    snapshot's tree: the names and the flipped transposed-conv kernels
    agree."""
    variables = load_variables_npz(MELGAN_NPZ)
    sd = melgan_from_jax_params(variables)
    result = MelGANGenerator().load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert sd["model.3.weight"].shape == (512, 256, 16)   # [in, out, 2r]
    back = melgan_params_from_torch(sd)["params"]

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {prefix + k: np.asarray(v)})
        return out

    ref, got = flat(variables["params"]), flat(back)
    assert set(got) == set(ref) and len(ref) == 84
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("layout", ["model_g", "mel2wav"])
def test_melgan_torch_checkpoint_loads_into_both(tmp_path, layout):
    """A melgan-neurips generator with weight norm on every conv (as
    tests/test_melgan.py builds it), saved as a training checkpoint's
    ``model_g`` or as a bare state dict with the hub model's ``mel2wav.``
    prefix, gives the same wav in both packages."""
    sd = _weight_norm_split(
        melgan_from_jax_params(load_variables_npz(MELGAN_NPZ)),
        np.random.default_rng(1), plain=())
    assert "model.3.weight_g" in sd and "model.24.weight_v" in sd
    ckpt = ({"model_g": sd, "optimizer_g": {}} if layout == "model_g"
            else {"mel2wav." + k: v for k, v in sd.items()})
    path = str(tmp_path / "melgan.pth.tar")
    torch.save(ckpt, path)
    mel = _mel(8, 7)
    ref = np.asarray(jax_get_vocoder(MELGAN, None, path)(jnp.asarray(mel)))
    with torch.inference_mode():
        got = get_vocoder(MELGAN, None, path, "cpu")(
            torch.from_numpy(mel)).numpy()
        npz = get_vocoder(MELGAN, None, MELGAN_NPZ, "cpu")(
            torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, npz, atol=ATOL, rtol=0)
