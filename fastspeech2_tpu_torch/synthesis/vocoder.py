"""Vocoder loading and waveform inference (port of the HiFi-GAN branches of
``fastspeech2_tpu/synthesis/vocoder.py``).

``get_vocoder`` builds the generator that model.yaml names -- the parity
HiFi-GAN (``HiFi-GAN``, whose ResBlocks run K4) or the iSTFT generators
(``HiFi-GAN-iSTFT``, ``HiFi-GAN-iSTFT-C8C2I``) -- and loads its weights
from a tracked npz snapshot or a reference ``.pth.tar``; ``vocoder_infer``
scales to int16 and trims each waveform to mel_len * hop_length (reference
utils/model.py:74-92).  MelGAN and Griffin-Lim come in a later slice.
"""

import json
import os

import numpy as np
import torch

from fastspeech2_tpu_torch.models.hifigan import HiFiGANGenerator
from fastspeech2_tpu_torch.models.hifigan_istft import HiFiGANiSTFTGenerator
from fastspeech2_tpu_torch.utils.params_io import (
    hifigan_from_jax_params,
    hifigan_from_torch_state_dict,
    load_variables_npz,
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


def get_vocoder(model_config, ckpt_path, device):
    """-> the generator (an nn.Module in eval mode on ``device``) that maps
    [B, T, n_mels] mels to [B, T*hop] float waveforms.

    ``ckpt_path``: a ``.npz`` snapshot of the JAX package, or a torch
    checkpoint (``{"generator": state_dict}`` or a bare state_dict, weight
    norm folded at load).  Without one, ``HiFi-GAN`` takes
    ``configs/hifigan/generator_<speaker>.pth.tar`` where that exists (the
    reference's speaker selection, utils/model.py:58-65); otherwise the
    generator keeps a random init drawn from seed ``RANDOM_INIT_SEED``,
    which keeps the pipeline runnable, as the JAX package's ``PRNGKey(0)``
    init does.  PyTorch's initialisers cannot reproduce Flax's numbers, so
    the two packages' random-init waveforms differ.
    """
    name = model_config["vocoder"]["model"]
    if name not in CONFIGS:
        raise NotImplementedError(
            f"vocoder {name!r} is not ported yet (MelGAN and Griffin-Lim "
            "come with the rest of M6, ROADMAP.md); this port runs "
            f"{', '.join(CONFIGS)}")
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
    if ckpt_path is None:
        pass
    elif ckpt_path.endswith(".npz"):
        generator.load_state_dict(hifigan_from_jax_params(
            load_variables_npz(ckpt_path), len(config["upsample_rates"]),
            len(config["resblock_kernel_sizes"])))
    elif os.path.isdir(ckpt_path):
        raise NotImplementedError(
            f"{ckpt_path!r} is a directory: orbax checkpoints of the JAX "
            "vocoder trainer load once vocoder training (M8) is ported; "
            "export its generator as an npz or a .pth.tar")
    else:
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        generator.load_state_dict(hifigan_from_torch_state_dict(
            ckpt.get("generator", ckpt)))
    return generator.to(device).eval()


def vocoder_infer(mels, vocoder, preprocess_config, lengths=None):
    """[B, T, n_mels] -> list of int16 numpy waveforms, each trimmed to
    lengths[i] * hop_length."""
    pp = preprocess_config["preprocessing"]
    max_wav_value = pp["audio"]["max_wav_value"]
    hop = pp["stft"]["hop_length"]
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
