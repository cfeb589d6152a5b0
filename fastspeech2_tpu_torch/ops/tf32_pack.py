"""Weights for the convolution kernels on ``wgmma``, laid out as their
``wgmma`` descriptors read them: the float32 K2 (``csrc/conv_ffn_f32.cu``)
and K4 (``csrc/resblock.cu``), split for 3xTF32 (:func:`pack_planes`), and
the bfloat16 K2 (``csrc/conv_ffn.cu``, :func:`pack_rows_bf16`).

A conv with T taps is T matrices A_j [N, K] (N output channels, K input
channels).  Each float32 weight w is split into big = tf32(w) and small =
tf32(w - big), rounded as ``cvt.rna.tf32.f32`` rounds (to nearest, ties
away from zero, 10 mantissa bits), so big + small is w to ~2^-22.  A
kernel stage is one (32-channel slice, tap): its two planes are [N][32]
rows of 128 bytes, K-major (the B operand of a tf32 ``wgmma``), each row's
16-byte chunks in the 128-byte swizzle.  At bfloat16 a stage is one
(64-channel slice, tap): the weights rounded to bfloat16, one [N][64] plane
of 128-byte rows in the same swizzle.
"""

import torch

SLICE = 32   # input channels per kernel stage: one 128-byte row of tf32
SLICE_BF16 = 64   # ... at bfloat16


def tf32_round(x):
    """float32 ``x`` rounded to TF32 as cvt.rna.tf32.f32 rounds a finite
    float: add half a TF32 unit to the bit pattern, clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)
    return r.view(torch.float32)


def _swizzle(planes):
    """[..., R, C] rows of 128 bytes (C = 32 float32 or 64 bfloat16
    values) -> the same rows with their 16-byte chunks in the 128-byte
    swizzle (chunk c of row r stored at c ^ (r % 8)); an involution, so it
    also undoes itself."""
    R, C = planes.shape[-2:]
    chunks = planes.reshape(*planes.shape[:-1], 8, C // 8)
    rows = torch.arange(R, device=planes.device)[:, None]
    cols = torch.arange(8, device=planes.device)[None, :]
    return chunks[..., rows, cols ^ (rows % 8), :] \
        .reshape(planes.shape)


def pack_planes(a):
    """a: [T, N, K] (tap, output channel, input channel), K a multiple of
    32 -> [K/32, T, 2, N, 32] float32, contiguous: for each (32-channel
    slice s, tap j), tf32(a) then tf32(a - tf32(a)) as [N][32] planes (row
    n holds a[j, n, 32 s:32 s + 32]), rows in the 128-byte swizzle."""
    T, N, K = a.shape
    if K % SLICE:
        raise ValueError(f"pack_planes: [T, N, K] = {tuple(a.shape)} needs "
                         f"K a multiple of {SLICE}")
    a = a.detach().float()
    big = tf32_round(a)
    planes = torch.stack([big, tf32_round(a - big)], 1)   # [T, 2, N, K]
    planes = planes.reshape(T, 2, N, K // SLICE, SLICE)
    return _swizzle(planes.permute(3, 0, 1, 2, 4)).contiguous()


def unpack_planes(packed):
    """Inverse of :func:`pack_planes`: -> (big, small), each [T, N, K]."""
    S, T, _, N, _ = packed.shape
    planes = _swizzle(packed).permute(1, 2, 3, 0, 4).reshape(T, 2, N,
                                                             S * SLICE)
    return planes[:, 0], planes[:, 1]


def pack_rows_bf16(a):
    """a: [T, N, K] (tap, output channel, input channel), K a multiple of
    64 -> [K/64, T, N, 64] bfloat16, contiguous: ``a`` rounded to bfloat16
    (to nearest even, as JAX's astype rounds), for each (64-channel slice
    s, tap j) an [N][64] plane (row n holds a[j, n, 64 s:64 s + 64]), rows
    in the 128-byte swizzle."""
    T, N, K = a.shape
    if K % SLICE_BF16:
        raise ValueError(f"pack_rows_bf16: [T, N, K] = {tuple(a.shape)} "
                         f"needs K a multiple of {SLICE_BF16}")
    rows = a.detach().to(torch.bfloat16).reshape(T, N, K // SLICE_BF16,
                                                 SLICE_BF16)
    return _swizzle(rows.permute(2, 0, 1, 3)).contiguous()


def unpack_rows_bf16(packed):
    """Inverse of :func:`pack_rows_bf16`: -> [T, N, K] bfloat16."""
    S, T, N, _ = packed.shape
    return _swizzle(packed).permute(1, 2, 0, 3).reshape(T, N,
                                                        S * SLICE_BF16)
