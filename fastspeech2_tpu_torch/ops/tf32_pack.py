"""Weights for the float32 convolution kernels on ``wgmma``, K2
(``csrc/conv_ffn_f32.cu``) and K4 (``csrc/resblock.cu``), split for
3xTF32 and laid out as their ``wgmma`` descriptors read them
(:func:`pack_planes`), and K2's bfloat16 pack (:func:`pack_fragments_bf16`).

A conv with T taps is T matrices A_j [N, K] (N output channels, K input
channels).  Each float32 weight w is split into big = tf32(w) and small =
tf32(w - big), rounded as ``cvt.rna.tf32.f32`` rounds (to nearest, ties
away from zero, 10 mantissa bits), so big + small is w to ~2^-22.  A
kernel stage is one (32-channel slice, tap): its two planes are [N][32]
rows of 128 bytes, K-major (the B operand of a tf32 ``wgmma``), each row's
16-byte chunks in the 128-byte swizzle.
"""

import torch

SLICE = 32   # input channels per kernel stage: one 128-byte row of tf32


def tf32_round(x):
    """float32 ``x`` rounded to TF32 as cvt.rna.tf32.f32 rounds a finite
    float: add half a TF32 unit to the bit pattern, clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)
    return r.view(torch.float32)


def _swizzle(planes):
    """[..., R, 32] float32 rows -> the same rows with their 16-byte chunks
    in the 128-byte swizzle (chunk c of row r stored at c ^ (r % 8)); an
    involution, so it also undoes itself."""
    R = planes.shape[-2]
    chunks = planes.reshape(*planes.shape[:-1], 8, 4)
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


def pack_fragments_bf16(a):
    """a: [T, M, K], M and K multiples of 16 -> [M/16, T, K/16, 32, 8]
    bfloat16, contiguous: ``a`` rounded to bfloat16 (to nearest even, as
    JAX's astype rounds) in the order of the A fragments of
    mma.m16n8k16.bf16 (``csrc/tf32_mma.cuh``): for each 16 x 16 block,
    lane (g, t) holds A[g, 2t], A[g, 2t+1], A[g+8, 2t], A[g+8, 2t+1],
    A[g, 2t+8], A[g, 2t+9], A[g+8, 2t+8], A[g+8, 2t+9]."""
    T, M, K = a.shape
    if M % 16 or K % 16:
        raise ValueError(f"pack_fragments_bf16: [T, M, K] = {tuple(a.shape)}"
                         " needs M and K multiples of 16")
    # rows m = 16 mb + 8 rh + g, columns k = 16 kb + 8 kh + 2 t + e
    p = a.detach().to(torch.bfloat16).reshape(T, M // 16, 2, 8, K // 16, 2,
                                              4, 2)
    # -> [mb, T, kb, g, t, kh, rh, e]
    return p.permute(1, 0, 4, 3, 6, 5, 2, 7).reshape(
        M // 16, T, K // 16, 32, 8).contiguous()
