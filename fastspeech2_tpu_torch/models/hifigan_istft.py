"""iSTFT-head HiFi-GAN generator, "C8C8I" (port of
``fastspeech2_tpu/models/hifigan_istft.py``).

conv_pre -> 2 x [lrelu(0.1) -> ConvTranspose upsample -> mean of 3 MRF
ResBlocks] -> lrelu(0.01) -> conv_post -> (log-magnitude, phase) of an
n_fft=16 spectrum per frame -> windowed overlap-add inverse STFT (hop 4).
Total upsampling 8*8*4 = 256 = the mel hop: [B, T, n_mels] -> [B, T*256].
The inverse STFT is real arithmetic (cos/sin basis products + a static
overlap-add), as in the JAX package.  The ResBlocks go through K4
(``ops/cuda_resblock.py``) on CUDA, as the parity generator's do.
"""

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from fastspeech2_tpu_torch.models.hifigan import build_stages, run_stages
from fastspeech2_tpu_torch.ops.device_cache import cached_constant


def _istft_bases(n_fft):
    """Real irfft bases: frames = real @ C + imag @ S, [n_bins, n_fft]."""
    k = np.arange(n_fft // 2 + 1)[:, None]
    t = np.arange(n_fft)[None, :]
    w = np.where((k == 0) | (k == n_fft // 2), 1.0, 2.0)
    ang = 2.0 * np.pi * k * t / n_fft
    c = (w * np.cos(ang) / n_fft).astype(np.float32)
    s = (-w * np.sin(ang) / n_fft).astype(np.float32)
    return c, s


def _hann_periodic(n):
    t = np.arange(n)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * t / n)).astype(np.float32)


@cached_constant(maxsize=None)
def _istft_constants(n_fft, device):
    """(C, S, window) on ``device``, made once: a copy from the host in
    every forward would make the host wait for the card, and cannot be
    captured in a CUDA graph.  Made outside inference mode, so that the
    vocoder trainer can differentiate through them."""
    c, s = _istft_bases(n_fft)
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(a, device=device)
                     for a in (c, s, _hann_periodic(n_fft)))


@cached_constant(maxsize=64)
def _window_sum_square(n_fft, hop, f, device):
    """The window-sum-square normaliser of an F-frame overlap-add (1 where
    it vanishes), on ``device``, made once per F."""
    wsq = _hann_periodic(n_fft) ** 2
    n_overlap = n_fft // hop
    wss = 0.0
    for j in range(n_overlap):
        wchunk = np.tile(wsq[j * hop: (j + 1) * hop], (f, 1))
        wss = wss + np.pad(wchunk, ((j, n_overlap - 1 - j), (0, 0))).reshape(-1)
    with torch.inference_mode(False):
        return torch.as_tensor(np.where(wss > 1e-11, wss, 1.0),
                               dtype=torch.float32, device=device)


def overlap_add_istft(real, imag, n_fft, hop):
    """[B, F, n_bins] real/imag -> [B, F*hop] waveform.

    Windowed overlap-add with window-sum-square normalisation; the
    (n_fft - hop) // 2 samples at each edge are trimmed so the output is
    exactly F*hop samples.  The overlap-add is a sum of n_fft//hop shifted
    reshapes, not a scatter loop.
    """
    c, s, window = _istft_constants(n_fft, real.device)
    frames = torch.matmul(real, c) + torch.matmul(imag, s)
    frames = frames * window

    b, f, _ = frames.shape
    n_overlap = n_fft // hop
    sig = None
    for j in range(n_overlap):
        chunk = frames[:, :, j * hop: (j + 1) * hop]           # [B, F, hop]
        chunk = F.pad(chunk, (0, 0, j, n_overlap - 1 - j))
        part = chunk.reshape(b, -1)
        sig = part if sig is None else sig + part
    sig = sig / _window_sum_square(n_fft, hop, f, real.device)
    trim = (n_fft - hop) // 2
    return sig[:, trim: trim + f * hop]


class HiFiGANiSTFTGenerator(nn.Module):
    """Module names follow the reference HiFi-GAN state dict: conv_pre,
    ups.{i}, resblocks.{i}.convs{1,2}.{j}, conv_post.  ``fused``: K4
    ResBlocks (the default) or the plain ones, which training uses."""

    def __init__(self, upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
                 upsample_initial_channel=512, resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 gen_istft_n_fft=16, gen_istft_hop_size=4, n_mel_channels=80,
                 fused=True):
        super().__init__()
        self.n_fft = gen_istft_n_fft
        self.hop = gen_istft_hop_size
        self.conv_pre = nn.Conv1d(n_mel_channels, upsample_initial_channel, 7,
                                  padding=3)
        # K4 ResBlocks: the JAX package builds plain ones here
        # (fastspeech2_tpu/models/hifigan_istft.py:126-129, from a TPU v5e
        # measurement); on the H100 K4 is faster than cuDNN's chain of
        # float32 convs at these shapes (PERF.md)
        self.ups, self.resblocks, ch = build_stages(
            upsample_rates, upsample_kernel_sizes, upsample_initial_channel,
            resblock_kernel_sizes, resblock_dilation_sizes, fused=fused)
        n_bins = self.n_fft // 2 + 1
        self.conv_post = nn.Conv1d(ch, 2 * n_bins, 7, padding=3)

    def forward(self, mel):
        """mel: [B, T, n_mels] -> wav [B, T * prod(rates) * istft_hop]."""
        x = run_stages(self.conv_pre(mel.transpose(1, 2)), self.ups,
                       self.resblocks)
        x = self.conv_post(F.leaky_relu(x, 0.01)).transpose(1, 2)
        n_bins = self.n_fft // 2 + 1
        mag = torch.exp(torch.clamp(x[..., :n_bins], -20.0, 6.0))
        phase = x[..., n_bins:]
        return overlap_add_istft(mag * torch.cos(phase),
                                 mag * torch.sin(phase), self.n_fft, self.hop)
