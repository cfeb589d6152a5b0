"""Shared building blocks (port of ``fastspeech2_tpu/models/common.py``).

Activations are [B, L, C] at every public function, as in the JAX package;
convolutions transpose to PyTorch's [B, C, L] inside.

The compute dtype (float32, or bfloat16 for the JAX package's --dtype
bfloat16) is the activations' dtype: it is set where the activations are
made (``FastSpeech2(cfg, dtype=...)``) and flows from layer to layer.
Parameters stay float32.  :class:`Linear` and :class:`Conv` compute as
Flax's Dense and Conv do at their dtype: the float32 weight and bias cast
to the input's dtype, the product rounded to it, then the bias added in
it.  :class:`LayerNorm` computes in float32 and casts back, as the JAX
package's TorchLayerNorm does.  The cast of a weight passes its gradient
back to the float32 parameter.

Dropout draws its masks from the generator that
:func:`set_dropout_generator` gives it (the training step gives one
seeded from the training seed and the step, as the JAX step folds its
dropout key on the step), or from PyTorch's default generator.
"""

import torch
from torch import nn
from torch.nn import functional as F


def set_dropout_generator(model, generator):
    """Draw every dropout mask of ``model`` from ``generator`` (a
    torch.Generator on the activations' device)."""
    for module in model.modules():
        if isinstance(module, Dropout):
            module.generator = generator


class Dropout(nn.Module):
    """Flax's dropout: in training mode keep each element with probability
    1 - rate and scale the kept ones by 1 / (1 - rate); the identity in
    eval mode."""

    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        if keep_prob == 0.0:
            return torch.zeros_like(x)
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with Flax's arithmetic: the variance is
    E[x^2] - E[x]^2 (clipped at 0) and the scale folds into the rsqrt.
    Parameter names (weight, bias) are PyTorch's, so reference state dicts
    load unchanged."""

    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        dt, x = x.dtype, x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * mul + self.bias).to(dt)


class Linear(nn.Linear):
    """nn.Linear at its input's dtype (module docstring)."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


class Conv(nn.Module):
    """Conv1d over [B, L, C] with SAME zero padding for an odd kernel
    (reference transformer/Layers.py ConvNorm; the module is named ``conv``
    as in the reference's state dict)."""

    def __init__(self, in_channels, out_channels, kernel_size, dilation=1):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError("SAME padding needs an odd kernel_size")
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              padding=dilation * (kernel_size - 1) // 2,
                              dilation=dilation)

    def forward(self, x):
        conv = self.conv
        y = F.conv1d(x.transpose(1, 2), conv.weight.to(x.dtype),
                     padding=conv.padding, dilation=conv.dilation)
        return (y + conv.bias.to(x.dtype)[:, None]).transpose(1, 2)

