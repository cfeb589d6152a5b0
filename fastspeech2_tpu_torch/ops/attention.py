"""Masked multi-head scaled-dot-product attention, plain PyTorch (port of
``fastspeech2_tpu/ops/attention.py``; the plain versions of kernels K1
and K3 in ``ops/cuda_attention.py``).

scores = QK^T / sqrt(d_k); padded KEYS get a large negative FINITE value,
so a query row whose keys are all padded comes out as the uniform mean of
V instead of NaN; the softmax is float32.  Heads stay a tensor axis:
[B, H, L, Dh].

Both functions take float32 or bfloat16 tensors and compute what the TPU
kernels compute at that dtype: every product in float32 from the operands
upcast (a bfloat16 product is exact in float32), the probabilities rounded
to the operands' dtype before the product with V
(``fastspeech2_tpu/ops/pallas_attention.py:107``), and each result rounded
to that dtype.  At float32 every cast is the identity.
"""

import torch

_NEG_INF = -1e9


def multi_head_attention(q, k, v, key_pad_mask):
    """q, k, v: [B, H, L, Dh]; key_pad_mask: [B, L] bool, True = padded
    key.  Returns [B, H, L, Dh]."""
    dt = q.dtype
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    scores = scores.masked_fill(key_pad_mask[:, None, None, :], _NEG_INF)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(dt).float(), v.float())
    return out.to(dt)


def plain_attention_backward(q, k, v, key_pad_mask, g):
    """The gradients (dq, dk, dv) of :func:`multi_head_attention` for the
    incoming gradient ``g``, by the explicit formula of the TPU kernel
    (``fastspeech2_tpu/ops/pallas_attention.py:130-167``, the plain version
    of kernel K3): recompute P, then dV = P^T g, dP = g V^T,
    dS = P * (dP - rowsum(dP * P)) * scale, dQ = dS K, dK = dS^T Q.
    Shapes as for the forward; the mask gets no gradient.  P stays float32
    throughout (the TPU kernel rounds nothing but its outputs)."""
    dt = q.dtype
    q, k, v, g = (t.float() for t in (q, k, v, g))
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    scores = scores.masked_fill(key_pad_mask[:, None, None, :], _NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q)
    return dq.to(dt), dk.to(dt), dv.to(dt)
