"""Weights for the convolution kernel K2, split for 3xTF32 and laid out as
the tensor cores' A fragments read them (``csrc/conv_tiles.cuh``), and
K2's bfloat16 pack (:func:`pack_fragments_bf16`).  K4 splits its weights
with the same :func:`tf32_round` and lays them out for ``wgmma``
(``ops/cuda_resblock.pack_conv_weight``).

A conv with T taps is T matrices A_j [M, K] (M output channels, K input
channels).  Each float32 weight w is split into big = tf32(w) and small =
tf32(w - big), rounded as ``cvt.rna.tf32.f32`` rounds (to nearest, ties
away from zero, 10 mantissa bits), so big + small is w to ~2^-22.  The pack
is [M/16, T, K/8, 32, 8] float32: for each 16 x 8 block of A_j, lane
(g, t) = (lane // 4, lane % 4) holds a0 = A[g, t], a1 = A[g+8, t],
a2 = A[g, t+4], a3 = A[g+8, t+4] of the big plane, then the same four of
the small plane, as bit patterns stored in float32.
"""

import torch


def tf32_round(x):
    """float32 ``x`` rounded to TF32 as cvt.rna.tf32.f32 rounds a finite
    float: add half a TF32 unit to the bit pattern, clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)
    return r.view(torch.float32)


def pack_fragments(a):
    """a: float32 [T, M, K], M a multiple of 16, K of 8 ->
    [M/16, T, K/8, 32, 8], contiguous."""
    T, M, K = a.shape
    if M % 16 or K % 8:
        raise ValueError(f"pack_fragments: [T, M, K] = {tuple(a.shape)} "
                         "needs M a multiple of 16 and K of 8")

    def frag(p):
        # rows m = 16 mb + 8 rh + g, columns k = 8 kb + 4 th + t
        p = p.reshape(T, M // 16, 2, 8, K // 8, 2, 4)
        # -> [mb, T, kb, g, t, th, rh]: word th * 2 + rh of lane 4 g + t
        return p.permute(1, 0, 4, 3, 6, 5, 2).reshape(M // 16, T, K // 8,
                                                      32, 4)

    a = a.detach().float()
    big = tf32_round(a)
    small = tf32_round(a - big)
    return torch.cat([frag(big), frag(small)], dim=-1).contiguous()


def unpack_fragments(packed):
    """Inverse of :func:`pack_fragments`: -> (big, small), each [T, M, K]."""
    mb, T, kb = packed.shape[:3]

    def plane(p):
        p = p.reshape(mb, T, kb, 8, 4, 2, 2).permute(1, 0, 6, 3, 2, 5, 4)
        return p.reshape(T, mb * 16, kb * 8)

    return plane(packed[..., :4]), plane(packed[..., 4:])


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
