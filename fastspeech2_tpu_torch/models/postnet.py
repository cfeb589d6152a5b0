"""Tacotron-2 style PostNet (port of ``fastspeech2_tpu/models/postnet.py``).

5 x conv1d(k=5) + BatchNorm, tanh on all but the last, dropout 0.5 after
every layer; the residual add is done by the caller.  Frames at or past the
batch's max mel length are re-zeroed before every conv, so the static frame
length behaves like the reference's exact-length batch
(fastspeech2_tpu/models/postnet.py:18-69, models/fastspeech2.py:142-157).

The BatchNorm is :class:`MaskedBatchNorm`: in eval mode it uses its running
statistics; in training mode its batch statistics exclude the frames past
the batch's max mel length, which ``nn.BatchNorm1d`` cannot do.  The convs
run at the activations' dtype, the BatchNorm in float32 with its output
cast back (postnet.py:100-118).
"""

import torch
from torch import nn

from fastspeech2_tpu_torch.models.common import Conv, Dropout


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the channels of [B, T, C] with the JAX package's
    ``_MaskedBatchNorm`` arithmetic (postnet.py:18-70).

    Training mode: mean and variance over the kept frames only, the
    variance as E[x^2] - mean^2 clamped at 0; the running statistics move
    with momentum 0.1 (Flax's 0.9 on the old value), the running variance
    unbiased by n / (n - 1).  Parameter and buffer names are
    ``nn.BatchNorm1d``'s, so state dicts are unchanged.
    """

    eps = 1e-5
    momentum = 0.1

    def __init__(self, features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x, keep=None):
        """x: [B, T, C]; keep: [B, T] bool, True = frame in the statistics
        (None: every frame).  Computes in float32; the output has x's
        dtype."""
        dt, x = x.dtype, x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            if keep is None:
                n = torch.tensor(float(x.shape[0] * x.shape[1]),
                                 device=x.device)
                mean = x.mean(dim=(0, 1))
                var = (x * x).mean(dim=(0, 1)) - mean * mean
            else:
                w = keep.to(x.dtype)[:, :, None]
                n = torch.clamp(w.sum(), min=1.0)
                mean = (x * w).sum(dim=(0, 1)) / n
                var = (x * x * w).sum(dim=(0, 1)) / n - mean * mean
            var = torch.clamp(var, min=0.0)
            with torch.no_grad():
                unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
                m = 1.0 - self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + self.momentum * mean)
                self.running_var.copy_(m * self.running_var
                                       + self.momentum * unbiased)
                self.num_batches_tracked += 1
        return ((x - mean) * torch.rsqrt(var + self.eps) * self.weight
                + self.bias).to(dt)


class PostNet(nn.Module):
    def __init__(self, n_mel_channels=80, embedding_dim=512, kernel_size=5,
                 n_convolutions=5):
        super().__init__()
        layers = []
        for i in range(n_convolutions):
            c_in = n_mel_channels if i == 0 else embedding_dim
            c_out = (n_mel_channels if i == n_convolutions - 1
                     else embedding_dim)
            # names follow the reference: convolutions.{i}.{0: conv, 1: bn}
            layers.append(nn.ModuleList([Conv(c_in, c_out, kernel_size),
                                         MaskedBatchNorm(c_out)]))
        self.convolutions = nn.ModuleList(layers)
        self.dropout = Dropout(0.5)

    def forward(self, x, frame_mask=None):
        """x: [B, T, n_mels] -> [B, T, n_mels] residual correction.
        frame_mask: [B, T] bool, True = frame beyond the batch's max mel
        length."""
        last = len(self.convolutions) - 1
        keep = None if frame_mask is None else ~frame_mask
        for i, (conv, bn) in enumerate(self.convolutions):
            if frame_mask is not None:
                x = x.masked_fill(frame_mask[:, :, None], 0.0)
            x = bn(conv(x), keep)
            if i != last:
                x = torch.tanh(x)
            x = self.dropout(x)
        return x
