"""Vocoder loading and waveform inference (port of
``fastspeech2_tpu/synthesis/vocoder.py``).

``get_vocoder`` builds the vocoder that model.yaml names
(``vocoder.model``), as the JAX package's does (``:170-246``):

- ``HiFi-GAN`` (the parity generator, whose 12 ResBlocks run K4) and the
  iSTFT generators ``HiFi-GAN-iSTFT`` and ``HiFi-GAN-iSTFT-C8C2I`` (6
  K4 ResBlocks);
- ``MelGAN`` (``models/melgan.py``), fed log10 mels;
- any other name (``none`` in the tracked configs): Griffin-Lim on the
  pseudo-inverse of the mel filterbank, the JAX package's weights-free
  fallback.

Weights come from a tracked npz snapshot, a reference ``.pth.tar``, or the
port's own vocoder checkpoint (the train state of
``training/vocoder.py`` or its lean export by ``cli/export_cli.py``);
``vocoder_infer`` scales to int16 and trims each waveform to
mel_len * hop_length (reference utils/model.py:74-92).  MelGAN's and
Griffin-Lim's convolutions and FFTs are cuDNN and cuFFT calls: the JAX
package runs them through XLA, outside any Pallas kernel.
"""

import json
import math
import os

import numpy as np
import torch
from torch import nn

from fastspeech2_tpu_torch.audio.mel import mel_filterbank
from fastspeech2_tpu_torch.audio.stft import griffin_lim
from fastspeech2_tpu_torch.models.hifigan import HiFiGANGenerator
from fastspeech2_tpu_torch.models.hifigan_istft import HiFiGANiSTFTGenerator
from fastspeech2_tpu_torch.models.melgan import MelGANGenerator
from fastspeech2_tpu_torch.ops.device_cache import cached_constant
from fastspeech2_tpu_torch.utils.params_io import (
    fold_weight_norm,
    hifigan_from_jax_params,
    load_variables_npz,
    melgan_from_jax_params,
    melgan_from_torch_state_dict,
)

_HIFIGAN_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                            "configs", "hifigan")
CONFIGS = {
    "HiFi-GAN": "config.json",
    # C8C8I: the iSTFTNet recipe's quality/speed point
    "HiFi-GAN-iSTFT": "config_istft.json",
    # C8C2I: stage 2 at 1/4 of the positions
    "HiFi-GAN-iSTFT-C8C2I": "config_istft_c8c2i.json",
}
RANDOM_INIT_SEED = 0


# the generator-config keys each family's constructor takes (the upstream
# config.json schema; ``num_mels`` is passed as n_mel_channels)
_HIFIGAN_KEYS = ("upsample_rates", "upsample_kernel_sizes",
                 "upsample_initial_channel", "resblock_kernel_sizes",
                 "resblock_dilation_sizes")
_ISTFT_KEYS = ("gen_istft_n_fft", "gen_istft_hop_size")
_MELGAN_KEYS = ("upsample_rates", "ngf", "n_residual_layers")
# every key of a config.json that describes the generator
GENERATOR_KEYS = ("arch",) + _HIFIGAN_KEYS + _ISTFT_KEYS + _MELGAN_KEYS[1:]


def _tuples(v):
    return (tuple(_tuples(x) for x in v) if isinstance(v, (list, tuple))
            else v)


def build_generator(config, fused=True):
    """MelGAN when the config has ``arch: melgan``, the iSTFT generator
    when it has ``gen_istft_n_fft``, else the parity generator; keys the
    config leaves out take the constructor's defaults.  ``fused``: the
    HiFi-GAN ResBlocks through K4 (inference) or plain (training)."""
    def kwargs(keys):
        return {k: _tuples(config[k]) for k in keys if k in config}

    n_mels = config.get("num_mels", 80)
    if config.get("arch") == "melgan":
        return MelGANGenerator(**kwargs(_MELGAN_KEYS), n_mel_channels=n_mels)
    if "gen_istft_n_fft" in config:
        return HiFiGANiSTFTGenerator(**kwargs(_HIFIGAN_KEYS + _ISTFT_KEYS),
                                     n_mel_channels=n_mels, fused=fused)
    return HiFiGANGenerator(**kwargs(_HIFIGAN_KEYS), n_mel_channels=n_mels,
                            fused=fused)


def generator_from_jax_params(variables, config):
    """The Flax variables of a generator of ``config`` ({"params": ...} or
    the bare params) -> the state_dict of ``build_generator(config)``."""
    if config.get("arch") == "melgan":
        return melgan_from_jax_params(variables)
    return hifigan_from_jax_params(
        variables, len(config.get("upsample_rates", (8, 8, 2, 2))),
        len(config.get("resblock_kernel_sizes", (3, 7, 11))))


def _weak_scalar(value, like):
    """A Python float as JAX's weakly typed constant meets ``like``: rounded
    to its dtype first (``jnp.log(10.0)`` becomes a bfloat16 2.296875 next
    to a bfloat16 mel).  Made once per (value, dtype, device): no copy from
    the host in a forward, which a CUDA graph could not capture."""
    return _scalar_tensor(value, like.dtype, like.device)


@cached_constant(maxsize=None)
def _scalar_tensor(value, dtype, device):
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=dtype, device=device)


class MelGANVocoder(nn.Module):
    """The MelGAN generator fed log10 mels: the reference divides the log-e
    mel by ln 10 before the network (utils/model.py:78;
    ``fastspeech2_tpu/synthesis/vocoder.py:122-125``).  The division runs at
    the mel's dtype, as the JAX vocoder's does, and its result is then
    upcast to the generator's float32."""

    def __init__(self, generator):
        super().__init__()
        self.generator = generator

    def forward(self, mels):
        """[B, T, n_mels] log-e mels -> [B, T * 256] waveform."""
        log10 = mels / _weak_scalar(math.log(10.0), mels)
        return self.generator(log10.float())


class GriffinLimVocoder(nn.Module):
    """Weights-free fallback: mel -> linear magnitude by the pseudo-inverse
    of the mel filterbank (reference audio/tools.py:18-34 spec_from_mel),
    clamped at 0 -> Griffin-Lim (``n_iters`` iterations from the initial
    phase of seed 0).  [B, T, n_mels] -> [B, hop * (T - 1)]."""

    def __init__(self, preprocess_config, n_iters=30):
        super().__init__()
        pp = preprocess_config["preprocessing"]
        self.n_fft = pp["stft"]["filter_length"]
        self.hop = pp["stft"]["hop_length"]
        self.win = pp["stft"]["win_length"]
        self.n_iters = n_iters
        sr = pp["audio"]["sampling_rate"]
        basis = mel_filterbank(sr, self.n_fft, pp["mel"]["n_mel_channels"],
                               pp["mel"]["mel_fmin"],
                               pp["mel"]["mel_fmax"] or sr / 2)
        # numpy's pinv, in float32 as the JAX package computes it
        self.register_buffer("inv_basis", torch.from_numpy(
            np.linalg.pinv(basis).astype(np.float32)))

    def forward(self, mels):
        # exp at the mel's dtype (``:155``), then the float32 product
        mag = torch.einsum("fm,btm->bft", self.inv_basis,
                           torch.exp(mels).float())
        return griffin_lim(torch.clamp(mag, min=0.0), self.n_fft, self.hop,
                           self.win, n_iters=self.n_iters)


def read_torch_checkpoint(ckpt_path):
    """torch.load of a vocoder checkpoint on the CPU; a directory (an orbax
    checkpoint of the JAX package) raises."""
    if os.path.isdir(ckpt_path):
        raise NotImplementedError(
            f"{ckpt_path!r} is a directory: the port does not read the "
            "orbax checkpoints of the JAX package's vocoder trainer; export "
            "its generator as an npz or a .pth.tar, or train with the "
            "port's train_vocoder_cli (<out_dir>/<step>.pth.tar)")
    return torch.load(ckpt_path, map_location="cpu", weights_only=True)


def get_vocoder(model_config, preprocess_config, ckpt_path, device):
    """-> the vocoder (an nn.Module in eval mode on ``device``) that maps
    [B, T, n_mels] mels to [B, samples] float waveforms.

    ``ckpt_path``: a ``.npz`` snapshot of the JAX package, or a torch
    checkpoint: for HiFi-GAN ``{"generator": state_dict}`` or a bare
    state_dict, for MelGAN a melgan-neurips state dict (``model_g`` or
    ``generator`` of a training checkpoint taken when present); weight
    norm is folded at load.  The port's vocoder train state
    (``training/checkpoint.py::save_vocoder_checkpoint``) holds
    ``generator`` and the ``generator_config`` it was trained with: the
    generator is built from that config, whose family must be the one
    model.yaml names.  Without a checkpoint, ``HiFi-GAN`` takes
    ``configs/hifigan/generator_<speaker>.pth.tar`` where that exists (the
    reference's speaker selection, utils/model.py:58-65); otherwise a
    generator keeps a random init drawn from seed ``RANDOM_INIT_SEED``,
    which keeps the pipeline runnable, as the JAX package's ``PRNGKey(0)``
    init does.  PyTorch's initialisers cannot reproduce Flax's numbers, so
    the two packages' random-init waveforms differ.  Griffin-Lim reads
    ``preprocess_config`` and no weights.  Orbax directories of the JAX
    package are not read.
    """
    name = model_config["vocoder"]["model"]
    if name != "MelGAN" and name not in CONFIGS:
        # the JAX package's fallback for every other name
        return GriffinLimVocoder(preprocess_config).to(device).eval()
    if ckpt_path is None and name == "HiFi-GAN":
        speaker = model_config["vocoder"].get("speaker", "LJSpeech")
        candidate = os.path.join(_HIFIGAN_DIR,
                                 f"generator_{speaker}.pth.tar")
        if os.path.exists(candidate):
            ckpt_path = candidate
    npz = ckpt_path is not None and ckpt_path.endswith(".npz")
    ckpt = (read_torch_checkpoint(ckpt_path)
            if ckpt_path is not None and not npz else None)
    if isinstance(ckpt, dict) and "generator_config" in ckpt:
        config = ckpt["generator_config"]
        if (config.get("arch") == "melgan") != (name == "MelGAN"):
            raise ValueError(f"{ckpt_path} holds a generator of config "
                             f"{config}, not one for vocoder.model {name}")
    elif name == "MelGAN":
        config = {"arch": "melgan"}
    else:
        with open(os.path.join(_HIFIGAN_DIR, CONFIGS[name])) as f:
            config = json.load(f)
    melgan = name == "MelGAN"
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(RANDOM_INIT_SEED)
        generator = build_generator(config)
    if npz:
        generator.load_state_dict(generator_from_jax_params(
            load_variables_npz(ckpt_path), config))
    elif ckpt is not None:
        generator.load_state_dict(
            melgan_from_torch_state_dict(ckpt) if melgan
            else fold_weight_norm(ckpt.get("generator", ckpt)))
    if melgan:
        return MelGANVocoder(generator).to(device).eval()
    return generator.to(device).eval()


def vocoder_infer(mels, vocoder, preprocess_config, lengths=None):
    """[B, T, n_mels] -> list of int16 numpy waveforms, each trimmed to
    lengths[i] * hop_length.  The vocoders compute in float32.  A bfloat16
    mel reaches the HiFi-GAN generators upcast, as the JAX generator's first
    conv promotes it (fastspeech2_tpu/synthesis/vocoder.py:249-262);
    MelGAN and Griffin-Lim take it at its dtype, since the JAX package
    divides it by ln 10 or applies exp in bfloat16 before its first float32
    operation (``:124-125``, ``:155``)."""
    pp = preprocess_config["preprocessing"]
    max_wav_value = pp["audio"]["max_wav_value"]
    hop = pp["stft"]["hop_length"]
    if not isinstance(vocoder, (MelGANVocoder, GriffinLimVocoder)):
        mels = mels.float()
    with torch.inference_mode():
        wavs = vocoder(mels).float().cpu().numpy()
    wavs = np.clip(wavs * max_wav_value, -32768, 32767).astype(np.int16)
    out = []
    for i in range(wavs.shape[0]):
        w = wavs[i]
        if lengths is not None:
            w = w[: int(lengths[i]) * hop]
        out.append(w)
    return out
