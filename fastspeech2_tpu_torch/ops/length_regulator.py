"""Length regulator as a gather (port of
``fastspeech2_tpu/ops/length_regulator.py``).

    cum[b, p]   = cumsum(durations)[b, p]
    phone(b, t) = searchsorted(cum[b], t, side='right')   # frames -> phones
    out[b, t]   = x[b, phone(b, t)]

The output has the caller's frame length; frames past an utterance's total
duration repeat its last phone and are masked by the returned lengths.

The gradient sums each phone's frames as a product with the one-hot
[B, T, P] frame-to-phone matrix: a fixed order of additions, so a training
step is reproducible on the card, where torch.gather's own backward adds
with atomics in an order that changes from run to run.
"""

import torch
from torch.nn import functional as F


class _RepeatPhones(torch.autograd.Function):
    """out[b, t] = x[b, idx[b, t]], with the one-hot product backward."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n_phones = x.shape[1]
        return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        onehot = F.one_hot(idx, ctx.n_phones).to(g.dtype)      # [B, T, P]
        return torch.bmm(onehot.transpose(1, 2), g), None


def length_regulate(x, durations, max_mel_len):
    """[B, P, D] phone features + [B, P] integer durations ->
    ([B, max_mel_len, D] frame features, [B] mel lengths clipped to
    max_mel_len)."""
    cum = torch.cumsum(durations.to(torch.int64), dim=1)       # [B, P]
    mel_len = torch.clamp(cum[:, -1], max=max_mel_len)
    frames = torch.arange(max_mel_len, device=x.device, dtype=torch.int64)
    frames = frames[None, :].expand(cum.shape[0], -1).contiguous()
    idx = torch.searchsorted(cum, frames, right=True)          # [B, T]
    idx = torch.clamp(idx, max=x.shape[1] - 1)
    return _RepeatPhones.apply(x, idx), mel_len.to(torch.int32)
