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

Weights come from a tracked npz snapshot or a reference ``.pth.tar``;
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


def build_generator(config):
    """The parity generator, or the iSTFT one when the config has
    ``gen_istft_n_fft``."""
    common = dict(
        upsample_rates=tuple(config["upsample_rates"]),
        upsample_kernel_sizes=tuple(config["upsample_kernel_sizes"]),
        upsample_initial_channel=config["upsample_initial_channel"],
        resblock_kernel_sizes=tuple(config["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(
            tuple(d) for d in config["resblock_dilation_sizes"]),
        n_mel_channels=config["num_mels"])
    if "gen_istft_n_fft" not in config:
        return HiFiGANGenerator(**common)
    return HiFiGANiSTFTGenerator(
        gen_istft_n_fft=config["gen_istft_n_fft"],
        gen_istft_hop_size=config["gen_istft_hop_size"], **common)


class MelGANVocoder(nn.Module):
    """The MelGAN generator fed log10 mels: the reference divides the log-e
    mel by ln 10 before the network (utils/model.py:78;
    ``fastspeech2_tpu/synthesis/vocoder.py:122-125``)."""

    def __init__(self, generator):
        super().__init__()
        self.generator = generator

    def forward(self, mels):
        """[B, T, n_mels] log-e mels -> [B, T * 256] waveform."""
        return self.generator(mels / math.log(10.0))


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
        mag = torch.einsum("fm,btm->bft", self.inv_basis, torch.exp(mels))
        return griffin_lim(torch.clamp(mag, min=0.0), self.n_fft, self.hop,
                           self.win, n_iters=self.n_iters)


def _read_weights(ckpt_path, from_jax, from_torch):
    """npz snapshot -> from_jax(variables); a directory raises; anything
    else is a torch checkpoint -> from_torch(loaded dict)."""
    if ckpt_path.endswith(".npz"):
        return from_jax(load_variables_npz(ckpt_path))
    if os.path.isdir(ckpt_path):
        raise NotImplementedError(
            f"{ckpt_path!r} is a directory: orbax checkpoints of the JAX "
            "vocoder trainer load once vocoder training (M8) is ported; "
            "export its generator as an npz or a .pth.tar")
    return from_torch(torch.load(ckpt_path, map_location="cpu",
                                 weights_only=True))


def get_vocoder(model_config, preprocess_config, ckpt_path, device):
    """-> the vocoder (an nn.Module in eval mode on ``device``) that maps
    [B, T, n_mels] mels to [B, samples] float waveforms.

    ``ckpt_path``: a ``.npz`` snapshot of the JAX package, or a torch
    checkpoint: for HiFi-GAN ``{"generator": state_dict}`` or a bare
    state_dict, for MelGAN a melgan-neurips state dict (``model_g`` of a
    training checkpoint taken when present); weight norm is folded at
    load.  Without one, ``HiFi-GAN`` takes
    ``configs/hifigan/generator_<speaker>.pth.tar`` where that exists (the
    reference's speaker selection, utils/model.py:58-65); otherwise a
    generator keeps a random init drawn from seed ``RANDOM_INIT_SEED``,
    which keeps the pipeline runnable, as the JAX package's ``PRNGKey(0)``
    init does.  PyTorch's initialisers cannot reproduce Flax's numbers, so
    the two packages' random-init waveforms differ.  Griffin-Lim reads
    ``preprocess_config`` and no weights.
    """
    name = model_config["vocoder"]["model"]
    if name == "MelGAN":
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(RANDOM_INIT_SEED)
            generator = MelGANGenerator()
        if ckpt_path is not None:
            generator.load_state_dict(_read_weights(
                ckpt_path, melgan_from_jax_params,
                melgan_from_torch_state_dict))
        return MelGANVocoder(generator).to(device).eval()
    if name not in CONFIGS:
        # the JAX package's fallback for every other name
        return GriffinLimVocoder(preprocess_config).to(device).eval()
    with open(os.path.join(_HIFIGAN_DIR, CONFIGS[name])) as f:
        config = json.load(f)
    if ckpt_path is None and name == "HiFi-GAN":
        speaker = model_config["vocoder"].get("speaker", "LJSpeech")
        candidate = os.path.join(_HIFIGAN_DIR,
                                 f"generator_{speaker}.pth.tar")
        if os.path.exists(candidate):
            ckpt_path = candidate
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(RANDOM_INIT_SEED)
        generator = build_generator(config)
    if ckpt_path is not None:
        generator.load_state_dict(_read_weights(
            ckpt_path,
            lambda variables: hifigan_from_jax_params(
                variables, len(config["upsample_rates"]),
                len(config["resblock_kernel_sizes"])),
            lambda ckpt: fold_weight_norm(ckpt.get("generator", ckpt))))
    return generator.to(device).eval()


def vocoder_infer(mels, vocoder, preprocess_config, lengths=None):
    """[B, T, n_mels] -> list of int16 numpy waveforms, each trimmed to
    lengths[i] * hop_length.  The vocoders compute in float32: a bfloat16
    mel is upcast first, as the JAX vocoder's first conv promotes it
    (fastspeech2_tpu/synthesis/vocoder.py:249-262)."""
    pp = preprocess_config["preprocessing"]
    max_wav_value = pp["audio"]["max_wav_value"]
    hop = pp["stft"]["hop_length"]
    with torch.inference_mode():
        wavs = vocoder(mels.float()).float().cpu().numpy()
    wavs = np.clip(wavs * max_wav_value, -32768, 32767).astype(np.int16)
    out = []
    for i in range(wavs.shape[0]):
        w = wavs[i]
        if lengths is not None:
            w = w[: int(lengths[i]) * hop]
        out.append(w)
    return out
