"""HiFi-GAN generator (port of ``fastspeech2_tpu/models/hifigan.py``).

The parity HiFi-GAN V1 generator (reference hifigan/models.py:112-174,
hyperparameters in ``configs/hifigan/config.json``): conv_pre (80 -> 512,
k 7) -> 4 x [lrelu 0.1 -> ConvTranspose upsample (rates 8, 8, 2, 2; kernels
16, 16, 4, 4) -> the mean of 3 MRF ResBlocks (k 3, 7, 11; dilations 1, 3,
5)] -> lrelu 0.01 -> conv_post (-> 1, k 7) -> tanh.  Tensors are
channels-first [B, C, T] inside the generator; its public io is
[B, T, n_mels] -> [B, T * 256].

Its 12 ResBlocks go through K4 (``ops/cuda_resblock.py``): the kernel on
CUDA, the plain version on the CPU.  The JAX package resolves its
``resblock_backend="auto"`` to XLA from a TPU v5e measurement
(``hifigan.py:52-63``); the port sends the parity generator, and the
iSTFT generators (``models/hifigan_istft.py``), to K4 on the H100, where
it is faster than cuDNN's chain of float32 convs (PERF.md).  Training
builds them with ``fused=False`` (K4 is inference-only).
"""

import torch
from torch import nn
from torch.nn import functional as F

from fastspeech2_tpu_torch.ops.cuda_resblock import (
    fused_resblock,
    pack_resblock_weights,
    plain_resblock,
)

LRELU_SLOPE = 0.1


class ResBlock(nn.Module):
    """MRF residual block: per dilation d,
    x += conv_k(lrelu(conv_k,d(lrelu(x)))) (reference hifigan/models.py
    ResBlock1; module names convs1.{j} / convs2.{j}).  ``fused`` sends it
    through K4 (:func:`fused_resblock`); otherwise it runs the plain
    version."""

    def __init__(self, channels, kernel_size=3, dilations=(1, 3, 5),
                 fused=False):
        super().__init__()
        self.dilations = tuple(dilations)
        self.fused = fused
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=(kernel_size * d - d) // 2)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size,
                      padding=(kernel_size - 1) // 2)
            for _ in dilations)
        self._pack = self._pack_key = None

    def _apply(self, fn, *args, **kwargs):
        # .to() / .cuda() / .cpu() give the weights new storage
        self._pack = self._pack_key = None
        return super()._apply(fn, *args, **kwargs)

    def _weights(self):
        return ([c.weight for c in self.convs1], [c.bias for c in self.convs1],
                [c.weight for c in self.convs2], [c.bias for c in self.convs2])

    def _packed(self, weights):
        """K4's weight pack, made once after load and again only when a
        weight is replaced, moved or changed in place."""
        key = tuple((t.data_ptr(), t._version) for ws in weights for t in ws)
        if key != self._pack_key:
            self._pack, self._pack_key = pack_resblock_weights(*weights), key
        return self._pack

    def forward(self, x):
        weights = self._weights()
        if not self.fused:
            return plain_resblock(x, *weights, self.dilations)
        packed = None if x.device.type == "cpu" else self._packed(weights)
        return fused_resblock(x, *weights, self.dilations, packed=packed)


def build_stages(upsample_rates, upsample_kernel_sizes,
                 upsample_initial_channel, resblock_kernel_sizes,
                 resblock_dilation_sizes, fused):
    """-> (ups, resblocks, channels after the last stage): one
    ConvTranspose1d and len(resblock_kernel_sizes) ResBlocks per stage."""
    ups, resblocks = nn.ModuleList(), nn.ModuleList()
    ch = upsample_initial_channel
    for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
        c_out = upsample_initial_channel // (2 ** (i + 1))
        # padding (k-u)//2 gives exactly T*u frames: the crop the JAX
        # package applies to its VALID transposed conv
        # (fastspeech2_tpu/models/hifigan.py:138-148)
        ups.append(nn.ConvTranspose1d(ch, c_out, k, stride=u,
                                      padding=(k - u) // 2))
        ch = c_out
        for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
            resblocks.append(ResBlock(ch, rk, tuple(rd), fused=fused))
    return ups, resblocks, ch


def run_stages(x, ups, resblocks):
    """Each stage: lrelu(0.1) -> upsample -> the mean of its ResBlocks, all
    reading the same x (fastspeech2_tpu/models/hifigan.py:149-159)."""
    n = len(resblocks) // len(ups)
    for i, up in enumerate(ups):
        x = up(F.leaky_relu(x, LRELU_SLOPE))
        acc = None
        for block in resblocks[i * n:(i + 1) * n]:
            y = block(x)
            acc = y if acc is None else acc + y
        x = acc / n
    return x


class HiFiGANGenerator(nn.Module):
    """The parity generator.  Module names follow the reference HiFi-GAN
    state dict: conv_pre, ups.{i}, resblocks.{i}.convs{1,2}.{j},
    conv_post.  ``fused`` (the default) sends the ResBlocks through K4;
    the vocoder trainer builds with ``fused=False``, the plain ResBlocks
    autograd differentiates, as the JAX trainer pins its ResBlocks to XLA
    (``fastspeech2_tpu/training/vocoder.py:472-476``)."""

    def __init__(self, upsample_rates=(8, 8, 2, 2),
                 upsample_kernel_sizes=(16, 16, 4, 4),
                 upsample_initial_channel=512,
                 resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 n_mel_channels=80, fused=True):
        super().__init__()
        self.conv_pre = nn.Conv1d(n_mel_channels, upsample_initial_channel, 7,
                                  padding=3)
        self.ups, self.resblocks, ch = build_stages(
            upsample_rates, upsample_kernel_sizes, upsample_initial_channel,
            resblock_kernel_sizes, resblock_dilation_sizes, fused=fused)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel):
        """mel: [B, T, n_mels] -> wav [B, T * prod(upsample_rates)]."""
        x = run_stages(self.conv_pre(mel.transpose(1, 2)), self.ups,
                       self.resblocks)
        # the final slope is 0.01, not 0.1
        # (fastspeech2_tpu/models/hifigan.py:160)
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0]
