"""Mask utilities (port of ``fastspeech2_tpu/ops/masking.py``).

A *pad mask* is True at PADDED positions, as in the reference
(utils/tools.py:91-99).
"""

import torch


def pad_mask_from_lengths(lengths, max_len):
    """[B] lengths -> [B, max_len] bool mask, True = padded position."""
    ids = torch.arange(max_len, device=lengths.device)[None, :]
    return ids >= lengths[:, None]


def fill_masked(x, pad_mask, value=0.0):
    """Set entries of x at padded positions to ``value``; a [B, L] mask
    works for [B, L] and [B, L, D] tensors."""
    if x.dim() == pad_mask.dim() + 1:
        pad_mask = pad_mask[..., None]
    return x.masked_fill(pad_mask, value)


def masked_mean(values, keep_mask):
    """Mean of ``values`` over the entries where ``keep_mask`` is True
    (True = KEEP here), 0 when none is kept: sum(values * keep) /
    max(sum(keep), 1), the JAX package's static-shape form of the
    reference's masked_select(...).mean()."""
    keep = keep_mask.to(values.dtype)
    return (values * keep).sum() / torch.clamp(keep.sum(), min=1.0)
