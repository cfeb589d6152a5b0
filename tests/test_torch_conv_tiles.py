"""PyTorch port, the arithmetic of K4 and the float32 K2
(``csrc/resblock.cu`` and ``csrc/conv_ffn_f32.cu``, both 3xTF32 on
``wgmma``) on the CPU.

The CUDA kernels run only on a card, so this file carries a numpy model of
what they compute and holds it against the JAX package's Pallas kernels
in interpret mode (``fused_resblock``, ``fused_conv_ffn``), as
``tests/test_torch_vocoder.py`` and ``tests/test_torch_ops.py`` run them:

- TF32 rounding as ``cvt.rna.tf32.f32`` does it (the port's
  ``ops/tf32_pack.tf32_round``, checked here against the bit rule);
- the weights split into big and small planes once, as [32-channel
  slice][tap][plane][C_out][32] rows in the 128-byte swizzle their
  ``wgmma`` descriptors read (``ops/tf32_pack.pack_planes``: K2's
  ``ops/cuda_ffn.pack_ffn_weights`` and K4's
  ``ops/cuda_resblock.pack_conv_weight``), read back here; the input
  split per tap as the kernels load it;
- the 3xTF32 product in the kernels' order: slices of 32 input channels,
  then taps, then 8-channel k-steps, each adding x_small w_big, x_big
  w_small and x_big w_big to a float32 accumulator (the tensor core
  modelled as exact products summed in float64 and rounded once per
  step);
- the shifted tap reads with dilation and the zero fill at the sequence
  edges (lrelu(0) = 0 for the first conv; t is 0 outside [0, L) for the
  second);
- K4's two launches per dilation unit, t through memory, each over blocks
  of 128 positions by NB output channels: the result equals one block
  over the whole row bit for bit, at every NB the grid takes;
- K2's taps split over blocks (a divisor of k1), the products of each
  unit of channels (the first conv: two slices, 64 channels; the second:
  one slice) summed from 0 and then added to the running sum, the
  partials summed in a fixed order with b1 before the ReLU, the second
  conv's hidden channels in groups of 32-channel slices whose shares are
  summed in order, and the LayerNorm in the second conv's epilogue order
  (each thread's sums over its 32 values of a row, a butterfly over the
  quad, the two warpgroups' halves added, E[y^2] - mean^2, eps 1e-5).

The last tests pin the 3xTF32 bounds the card's times are held to
(``tools/kernel_bounds.py``).  Sizes: C in {32, 64}, k in {3, 7, 11},
dilations (1, 3, 5), L of 1, below the halo (60 at k = 11) and at the
128-position tile +- 1; K2 at D = 256, H = 128 (the kernel's hidden
width is a multiple of 128), k2 in {1, 3}, with 1, 3 and 9 tap splits
and 1 or 2 hidden groups.  Tolerance 1e-5 absolute against the JAX package: float32
sums of up to 2304 O(1) terms in another order, as in the JAX package's
own kernel tests.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastspeech2_tpu.ops.pallas_ffn import fused_conv_ffn as jax_fused_ffn
from fastspeech2_tpu.ops.pallas_resblock import (
    fused_resblock as jax_fused_resblock,
)
from fastspeech2_tpu_torch.ops.cuda_resblock import (
    pack_conv_weight,
    unpack_conv_weight,
)
from fastspeech2_tpu_torch.ops.cuda_ffn import pack_ffn_weights
from fastspeech2_tpu_torch.ops.tf32_pack import (
    tf32_round,
    unpack_planes,
    unpack_rows_bf16,
)
from fastspeech2_tpu_torch.tools.kernel_bounds import (
    ffn_bound_ms,
    parity_resblock_shapes,
    resblock_bound_ms,
)

DILS = (1, 3, 5)
SLOPE = np.float32(0.1)
SLICE = 32        # input channels per stage (K2's convs and K4)
UNIT1 = 64        # channels per unit of K2's two-level sum: the first conv
UNIT2 = 32        # and the second
K4_BM = 128       # positions per K4 block
ATOL = 1e-5


# ---- TF32 and the 3xTF32 product ---------------------------------------------

def tf32_rna(x):
    """cvt.rna.tf32.f32 on the bit pattern (sign-magnitude: ties away from
    zero)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    x = np.asarray(x, np.float32)
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def lrelu(x):
    return np.where(x > 0, x, SLOPE * x).astype(np.float32)


def k2_weight_planes(w1, w2):
    """K2's w1 [k1, 256, H], w2 [k2, H, 256] (JAX layouts) -> (big, small)
    [T, C_out, C_in] of each, through K2's float32 pack and back, as the
    kernel reads them."""
    packs = pack_ffn_weights(torch.from_numpy(w1), torch.from_numpy(w2))
    return [tuple(p.numpy() for p in unpack_planes(packed))
            for packed in packs]


def k4_weight_planes(w):
    """[C_out, C_in, T] -> big, small [T, C_out, C_in], through K4's pack
    and back."""
    big, small = unpack_conv_weight(pack_conv_weight(torch.from_numpy(w)))
    return big.numpy(), small.numpy()


def conv_3xtf32(acc, staged, planes, taps, d, n, unit=None):
    """acc [M, n] + the conv of a staged window: output column c, tap j
    reads staged column c + j d.  staged = (big, small) [C_in, width],
    split once; planes = (big, small) [T, M, C_in]; ``taps`` the tap
    indices this block takes.  The kernels' order: slices of 32 channels,
    taps, k-steps of 8, three products each.  ``unit`` (K2's two levels):
    the products of each ``unit`` channels (their slices, all taps) are
    summed from 0 and then added to acc."""
    sb, ss = staged
    wb, ws = planes
    C_in = sb.shape[0]
    unit = unit or C_in
    acc = np.asarray(acc, np.float32).copy()
    for u0 in range(0, C_in, unit):
        part = np.zeros_like(acc) if unit != C_in else acc
        for c0 in range(u0, u0 + unit, SLICE):
            for i, j in enumerate(taps):
                cols = slice(i * d, i * d + n)
                for k0 in range(c0, c0 + SLICE, 8):
                    ks = slice(k0, k0 + 8)
                    for a, b in ((wb[j][:, ks], ss[ks, cols]),
                                 (ws[j][:, ks], sb[ks, cols]),
                                 (wb[j][:, ks], sb[ks, cols])):
                        step = (a.astype(np.float64)[:, :, None]
                                * b.astype(np.float64)[None, :, :]).sum(
                                    axis=1)
                        part = (part.astype(np.float64) + step).astype(
                            np.float32)
        acc = (acc + part).astype(np.float32) if unit != C_in else part
    return acc


def window(x, start, width):
    """x [C, L] at positions start .. start + width - 1, zero outside
    [0, L) (cp.async's zero fill)."""
    C, L = x.shape
    out = np.zeros((C, width), np.float32)
    lo, hi = max(start, 0), min(start + width, L)
    if hi > lo:
        out[:, lo - start:hi - start] = x[:, lo:hi]
    return out


# ---- K4 -------------------------------------------------------------------

def k4_launch(x, w, b, d, first, res=None, nb=None, bm=None):
    """One launch of K4's conv kernel on one batch row x [C, L]: for each
    block of ``bm`` positions (the whole row by default) and ``nb`` output
    channels (all by default), the 3xTF32 conv of the block's window (0
    outside [0, L), lrelu first when ``first``) in 32-channel slices, then
    + b and lrelu (first) or res + (acc + b)."""
    C, L = x.shape
    k = w.shape[-1]
    wb, ws = k4_weight_planes(w)
    nb, bm = nb or C, bm or L
    src = lrelu(x) if first else x
    out = np.empty_like(x)
    for l0 in range(0, L, bm):
        staged = split(window(src, l0 - (k - 1) // 2 * d, bm + (k - 1) * d))
        hi = min(l0 + bm, L)
        for c0 in range(0, C, nb):
            ch = slice(c0, c0 + nb)
            acc = conv_3xtf32(np.zeros((nb, bm)), staged, (wb[:, ch],
                                                           ws[:, ch]),
                              range(k), d, bm)
            v = acc[:, :hi - l0] + b[ch, None]
            out[ch, l0:hi] = lrelu(v) if first else res[ch, l0:hi] + v
    return out


def k4_resblock(x, w1, b1, w2, b2, nb=None, bm=None):
    """K4 on one batch row x [C, L]: per unit, t = lrelu(conv1(lrelu(x)) +
    b1) through memory, then x + (conv2(t) + b2); blocks of ``bm``
    positions by ``nb`` channels (the whole row and all channels by
    default)."""
    for u, d in enumerate(DILS):
        t = k4_launch(x, w1[u], b1[u], d, True, nb=nb, bm=bm)
        x = k4_launch(t, w2[u], b2[u], 1, False, res=x, nb=nb, bm=bm)
    return x


def _resblock_inputs(C, k, L, seed):
    """Port layouts: x [C, L], per unit Conv1d weights [C, C, k] scaled to
    keep the output O(1), biases of 2 (a leak at the edges shows)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, L), dtype=np.float32)
    scale = (C * k) ** -0.5
    w1, w2 = ([rng.standard_normal((C, C, k), dtype=np.float32) * scale
               for _ in DILS] for _ in range(2))
    b1, b2 = ([rng.standard_normal(C, dtype=np.float32) * 2.0 for _ in DILS]
              for _ in range(2))
    return x, w1, b1, w2, b2


@functools.lru_cache(maxsize=None)
def _jax_resblock(C, k, L):
    x, w1, b1, w2, b2 = _resblock_inputs(C, k, L, seed=C + k + L)
    jw = [jnp.asarray(np.stack([w.transpose(2, 1, 0) for w in ws]))
          for ws in (w1, w2)]
    out = jax_fused_resblock(jnp.asarray(x.T[None]), jw[0],
                             jnp.asarray(np.stack(b1)), jw[1],
                             jnp.asarray(np.stack(b2)), DILS, True)
    return np.asarray(out)[0].T


# L: one position, below the halo, and the 128-position tile +- 1
@pytest.mark.parametrize("C,k,L", [(32, 3, 1), (32, 7, 40), (32, 11, 129),
                                   (64, 3, 127), (64, 7, 129),
                                   (64, 11, 40), (32, 3, 127),
                                   (64, 11, 1)])
def test_k4_tiles_match_pallas_resblock(C, k, L):
    args = _resblock_inputs(C, k, L, seed=C + k + L)
    whole = k4_resblock(*args)
    np.testing.assert_allclose(whole, _jax_resblock(C, k, L), atol=ATOL,
                               rtol=0)
    # the kernel's blocks of 128 positions, whole-C and split-N grids,
    # change no bit
    for nb in sorted({C, 32}):
        assert np.array_equal(k4_resblock(*args, nb=nb, bm=K4_BM),
                              whole), nb


def test_k4_edges_take_no_bias():
    """A zero input: near the edges the output comes from the biases through
    each conv's own zero padding; a second conv that read lrelu(b1)
    outside [0, L) would differ from the reference."""
    x, w1, b1, w2, b2 = _resblock_inputs(32, 11, 129, seed=5)
    x = np.zeros_like(x)
    got = k4_resblock(x, w1, b1, w2, b2, bm=K4_BM)
    ref = _plain_resblock(x, w1, b1, w2, b2)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert np.abs(ref[:, :10] - ref[:, 60:70]).max() > 1e-2


def _plain_resblock(x, w1, b1, w2, b2):
    y = torch.from_numpy(x)[None]
    for u, d in enumerate(DILS):
        k = w1[u].shape[-1]
        t = torch.nn.functional.conv1d(
            torch.nn.functional.leaky_relu(y, 0.1), torch.from_numpy(w1[u]),
            torch.from_numpy(b1[u]), padding=(k * d - d) // 2, dilation=d)
        t = torch.nn.functional.conv1d(
            torch.nn.functional.leaky_relu(t, 0.1), torch.from_numpy(w2[u]),
            torch.from_numpy(b2[u]), padding=(k - 1) // 2)
        y = y + t
    return y[0].numpy()


def test_k4_weight_pack_is_the_swizzled_split_weights():
    """K4's pack holds tf32(w) and tf32(w - tf32(w)) per (32-channel
    slice, tap) as [C_out][32] rows, the 16-byte chunk c of row r at chunk
    c ^ (r % 8) (the 128-byte swizzle), and reads back to the planes."""
    w = np.random.default_rng(4).standard_normal((64, 64, 3),
                                                 dtype=np.float32)
    packed = pack_conv_weight(torch.from_numpy(w)).numpy()
    assert packed.shape == (2, 3, 2, 64, 32)
    big, small = split(w.transpose(2, 0, 1))
    s, j, r = 1, 2, 13
    for c in range(8):
        at = 4 * (c ^ (r % 8))
        cols = slice(32 * s + 4 * c, 32 * s + 4 * c + 4)
        assert np.array_equal(packed[s, j, 0, r, at:at + 4], big[j, r, cols])
        assert np.array_equal(packed[s, j, 1, r, at:at + 4],
                              small[j, r, cols])
    got_big, got_small = k4_weight_planes(w)
    assert np.array_equal(got_big, big) and np.array_equal(got_small, small)


@pytest.mark.parametrize("k2", [1, 3])
def test_weight_planes_are_the_split_weights(k2):
    """K2's float32 pack holds tf32(w) and tf32(w - tf32(w)) of each conv
    per (32-channel slice, tap) as [C_out][32] rows, the 16-byte chunk c of
    row r at chunk c ^ (r % 8), and reads back to the planes (w1
    [k1, 256, H] -> [8, k1, 2, H, 32], w2 [k2, H, 256] -> [H/32, k2, 2,
    256, 32])."""
    rng = np.random.default_rng(3 + k2)
    w1 = rng.standard_normal((9, 256, 128), dtype=np.float32)
    w2 = rng.standard_normal((k2, 128, 256), dtype=np.float32)
    w1p, w2p = (p.numpy() for p in pack_ffn_weights(torch.from_numpy(w1),
                                                    torch.from_numpy(w2)))
    assert w1p.shape == (8, 9, 2, 128, 32) and w2p.shape == (4, k2, 2, 256,
                                                             32)
    for w, packed in ((w1, w1p), (w2, w2p)):
        big, small = split(w.transpose(0, 2, 1))    # [T, C_out, C_in]
        s, j, r = 1, w.shape[0] - 1, 13
        for c in range(8):
            at = 4 * (c ^ (r % 8))
            cols = slice(32 * s + 4 * c, 32 * s + 4 * c + 4)
            assert np.array_equal(packed[s, j, 0, r, at:at + 4],
                                  big[j, r, cols])
            assert np.array_equal(packed[s, j, 1, r, at:at + 4],
                                  small[j, r, cols])
    for (big, small), w in zip(k2_weight_planes(w1, w2), (w1, w2)):
        want_big, want_small = split(w.transpose(0, 2, 1))
        assert np.array_equal(big, want_big)
        assert np.array_equal(small, want_small)
    assert np.array_equal(tf32_round(torch.from_numpy(w1)).numpy(),
                          tf32_rna(w1))


# ---- K2 -------------------------------------------------------------------

def layer_norm_epilogue(y, gamma, beta):
    """The second conv's epilogue over rows of 256: lane (w, t) (the
    thread of quad lane t in warpgroup w) sums y[128 w + 8 c + 2 t + e]
    over c = 0 .. 15 and e = 0, 1 in order (the square by fma), a
    butterfly over the quad's 4 lanes, the two warpgroups' halves added,
    then E[y^2] - mean^2 + 1e-5."""
    out = np.empty_like(y)
    cols = (128 * np.arange(2)[:, None, None, None]
            + 8 * np.arange(16)[None, None, :, None]
            + 2 * np.arange(4)[None, :, None, None]
            + np.arange(2)[None, None, None, :]).reshape(2, 4, 32)
    for r in range(y.shape[0]):
        lanes = y[r][cols]                      # [w, t, 32 values in order]
        s = np.zeros((2, 4), np.float32)
        sq = np.zeros((2, 4), np.float32)
        for i in range(32):
            v = lanes[..., i]
            s = (s + v).astype(np.float32)
            sq = (v.astype(np.float64) * v + sq).astype(np.float32)
        for off in (1, 2):
            idx = np.arange(4) ^ off
            s = (s + s[:, idx]).astype(np.float32)
            sq = (sq + sq[:, idx]).astype(np.float32)
        st = np.float32(s[0, 0] + s[1, 0])
        sqt = np.float32(sq[0, 0] + sq[1, 0])
        mean = np.float32(st / np.float32(256))
        var = np.float32(np.float64(sqt / np.float32(256))
                         - np.float64(mean) * mean)
        inv = np.float32(1) / np.float32(np.sqrt(var + np.float32(1e-5)))
        out[r] = (y[r] - mean) * inv * gamma + beta
    return out


def k2_model(x, w1, b1, w2, b2, gamma, beta, splits, groups=1):
    """x [L, 256] of one batch row; w1 [k1, 256, H], w2 [k2, H, 256] (JAX
    layouts); ``splits`` divides k1.  (a) per split, the partial over its
    taps; (b) h = ReLU(sum of partials in order + b1), 0 outside [0, L),
    per group of hidden channels its share of the second conv; (c) the
    shares summed in order, + b2 + x, the LayerNorm."""
    L = x.shape[0]
    k1, _, H = w1.shape
    k2 = w2.shape[0]
    assert k1 % splits == 0
    p1, p2 = k2_weight_planes(w1, w2)     # [k1, H, 256], [k2, 256, H]
    per = k1 // splits
    parts = []
    for s in range(splits):
        taps = range(s * per, s * per + per)
        staged = split(window(x.T, taps[0] - (k1 - 1) // 2,
                              L + len(taps) - 1))
        parts.append(conv_3xtf32(np.zeros((H, L)), staged, p1, taps, 1, L,
                                 unit=UNIT1))
    total = parts[0]
    for p in parts[1:]:
        total = (total + p).astype(np.float32)
    h = np.maximum(total + b1[:, None], 0).astype(np.float32)
    hb, hs = split(window(h, -((k2 - 1) // 2), L + k2 - 1))
    size = H // groups
    acc = None
    for g in range(groups):
        ch = slice(g * size, (g + 1) * size)
        share = conv_3xtf32(np.zeros((256, L)), (hb[ch], hs[ch]),
                            (p2[0][:, :, ch], p2[1][:, :, ch]), range(k2),
                            1, L, unit=UNIT2)
        acc = share if acc is None else (acc + share).astype(np.float32)
    y = ((acc + b2[:, None]).T + x).astype(np.float32)
    return layer_norm_epilogue(y, gamma, beta)


def _ffn_inputs(L, k2, seed, H=128):
    r = np.random.RandomState(seed)
    return (r.randn(2, L, 256).astype(np.float32),
            (r.randn(9, 256, H) * 0.03).astype(np.float32),
            (r.randn(H) * 0.1).astype(np.float32),
            (r.randn(k2, H, 256) * 0.1).astype(np.float32),
            (r.randn(256) * 0.1).astype(np.float32),
            (1.0 + 0.1 * r.randn(256)).astype(np.float32),
            (0.1 * r.randn(256)).astype(np.float32))


@pytest.mark.parametrize("L,k2", [(1, 3), (31, 1), (33, 3)])
@pytest.mark.parametrize("splits,groups", [(1, 1), (3, 2), (9, 2)])
def test_k2_tiles_match_pallas_ffn(L, k2, splits, groups):
    args = _ffn_inputs(L, k2, seed=L + k2)
    ref = np.asarray(jax_fused_ffn(*(jnp.asarray(a) for a in args), True))
    for b in range(2):
        got = k2_model(args[0][b], *args[1:], splits, groups)
        np.testing.assert_allclose(got, ref[b], atol=ATOL, rtol=0)


def test_k2_split_partials_sum_in_a_fixed_order():
    """9 taps in one block is a different sum from 3 + 3 + 3: the split
    changes the last bits, never more, and one plan always gives the same
    bits."""
    args = _ffn_inputs(17, 1, seed=2)
    one, three = (k2_model(args[0][0], *args[1:], s) for s in (1, 3))
    assert np.array_equal(k2_model(args[0][0], *args[1:], 3), three)
    np.testing.assert_allclose(one, three, atol=ATOL, rtol=0)


# ---- K2 at bfloat16 ---------------------------------------------------------

BF16 = torch.bfloat16
SLICE_BF16 = 64   # input channels per stage of the bfloat16 K2
KSTEP_BF16 = 16   # channels per k-step of its m64n256k16 products


def bf16(x):
    """float32 values rounded to bfloat16 (to nearest even), as float32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(BF16).float() \
        .numpy()


def conv_bf16(acc, x, w, taps, pad, slices):
    """acc [L, N] += the taps ``taps`` of the conv of x [L, C] (bfloat16
    values) with w [T, N, C] (bfloat16 values) over the input slices
    ``slices``, in the kernel's order: slices of 64 channels, then taps,
    then k-steps of 16 channels, each step's 16 exact products summed once
    (float64, rounded to float32) and added to the float32 accumulator."""
    L = x.shape[0]
    for sl in slices:
        for j in taps:
            xs = window(x.T, j - pad, L).T                 # [L, C]
            for c0 in range(SLICE_BF16 * sl, SLICE_BF16 * (sl + 1),
                            KSTEP_BF16):
                ch = slice(c0, c0 + KSTEP_BF16)
                step = xs[:, ch].astype(np.float64) @ w[j, :, ch].T.astype(
                    np.float64)
                acc = (acc.astype(np.float64) + step.astype(np.float32)) \
                    .astype(np.float32)
    return acc


def quad_layer_norm(y, gamma, beta):
    """conv2's epilogue (groups = 1): quad lane t of a row sums y[8 j + 2 t
    + e], j = 0 .. 31, e = 0, 1, in order (the square by fma), a butterfly
    over the quad, E[y^2] - mean^2 + 1e-5; the output rounded to
    bfloat16."""
    cols = (8 * np.arange(32)[None, :, None] + 2 * np.arange(4)[:, None, None]
            + np.arange(2)[None, None, :]).reshape(4, 64)
    return _layer_norm(y, gamma, beta, cols, (1, 2))


def warp_layer_norm(y, gamma, beta):
    """The LayerNorm launch (groups > 1): lane l of a row's warp sums
    y[l + 32 u], u = 0 .. 7, in order, a butterfly over the warp."""
    cols = np.arange(32)[:, None] + 32 * np.arange(8)[None, :]
    return _layer_norm(y, gamma, beta, cols, (16, 8, 4, 2, 1))


def _layer_norm(y, gamma, beta, cols, offsets):
    out = np.empty_like(y)
    n = cols.shape[0]
    for r in range(y.shape[0]):
        lanes = y[r][cols]
        s = np.zeros(n, np.float32)
        sq = np.zeros(n, np.float32)
        for i in range(cols.shape[1]):
            v = lanes[:, i]
            s = (s + v).astype(np.float32)
            sq = (v.astype(np.float64) * v + sq).astype(np.float32)
        for off in offsets:
            idx = np.arange(n) ^ off
            s = (s + s[idx]).astype(np.float32)
            sq = (sq + sq[idx]).astype(np.float32)
        mean = np.float32(s[0] / np.float32(256))
        var = np.float32(np.float64(sq[0] / np.float32(256))
                         - np.float64(mean) * mean)
        inv = np.float32(1) / np.float32(np.sqrt(var + np.float32(1e-5)))
        out[r] = (y[r] - mean) * inv * gamma + beta
    return bf16(out)


def k2_bf16_model(x, w1, b1, w2, b2, gamma, beta, splits, groups=1):
    """The bfloat16 K2 (``csrc/conv_ffn.cu``) on x [L, 256] (bfloat16
    values) of one batch row, with w1 [k1, 256, H], w2 [k2, H, 256] (JAX
    layouts) read back from their bfloat16 pack: (a) per split of the
    k1 taps the partial over its taps, the partials summed in order, h =
    bfloat16(ReLU(sum + b1)); (b) per group of hidden slices its share of
    the second conv, the shares summed in order; y = (shares + b2) + x;
    the LayerNorm of the epilogue (1 group) or of the launch after it."""
    L = x.shape[0]
    k1, _, H = w1.shape
    k2 = w2.shape[0]
    w1p, w2p = pack_ffn_weights(torch.from_numpy(w1), torch.from_numpy(w2),
                                BF16)
    r1, r2 = (unpack_rows_bf16(p).float().numpy() for p in (w1p, w2p))
    per = k1 // splits
    total = None
    for s in range(splits):
        part = conv_bf16(np.zeros((L, H), np.float32), x, r1,
                         range(s * per, s * per + per), (k1 - 1) // 2,
                         range(256 // SLICE_BF16))
        total = part if total is None else (total + part).astype(np.float32)
    h = bf16(np.maximum(total + b1, 0))
    size = H // SLICE_BF16 // groups
    acc = None
    for g in range(groups):
        share = conv_bf16(np.zeros((L, 256), np.float32), h, r2, range(k2),
                          (k2 - 1) // 2, range(g * size, (g + 1) * size))
        acc = share if acc is None else (acc + share).astype(np.float32)
    y = ((acc + b2) + x).astype(np.float32)
    norm = quad_layer_norm if groups == 1 else warp_layer_norm
    return norm(y, gamma, beta)


@pytest.mark.parametrize("L,k2,splits,groups", [(1, 3, 1, 1), (33, 1, 3, 2),
                                                (20, 3, 9, 2)])
def test_k2_bf16_tiles_match_pallas_ffn(L, k2, splits, groups):
    """The bfloat16 K2's order of sums, against the Pallas FFN on a
    bfloat16 x in interpret mode: both round h and the output to
    bfloat16, so they agree to an ulp at the largest |value|."""
    args = list(_ffn_inputs(L, k2, seed=L + k2 + 7, H=256))
    args[0] = bf16(args[0])
    ref = np.asarray(jax_fused_ffn(jnp.asarray(args[0]).astype(jnp.bfloat16),
                                   *(jnp.asarray(a) for a in args[1:]),
                                   True)).astype(np.float32)
    unit = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    for b in range(2):
        got = k2_bf16_model(args[0][b], *args[1:], splits, groups)
        assert np.abs(got - ref[b]).max() <= unit


# ---- bounds -------------------------------------------------------------------

def test_conv_bounds_use_the_3xtf32_basis():
    """K4's 12 calls of a 1000-frame parity forward: 594.5 GFLOP, 3.603 ms
    at three TF32 products per float32-accurate one (495 TFLOP/s), 8.874 ms
    on the CUDA cores; K2: operations at L = 1000, the 10.5 MB of weights
    at L = 32."""
    shapes = parity_resblock_shapes(1000)
    rows = [resblock_bound_ms(1, L, C, k) for C, L, k in shapes]
    assert abs(sum(r[0] for r in rows) - 3.603) < 1e-3
    assert abs(sum(r[2] for r in rows) - 8.8738) < 1e-3
    assert all(r[1] == "operations" for r in rows)
    ms, by, simt, flops, nbytes = ffn_bound_ms(1, 1000)
    assert by == "operations" and abs(flops - 5.243e9) < 1e6
    assert math.isclose(ms, 3 * flops / 495e12 * 1e3)
    assert abs(ms - 0.0318) < 1e-4 and abs(simt - 0.07825) < 1e-4
    ms, by, _, _, nbytes = ffn_bound_ms(1, 32)
    assert by == "bytes" and abs(nbytes - 10.56e6) < 0.01e6
    assert abs(ms - 0.0032) < 1e-4
