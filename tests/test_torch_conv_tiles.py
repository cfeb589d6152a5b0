"""PyTorch port, the arithmetic of K4 and K2 (``csrc/resblock.cu`` on
``wgmma``, ``csrc/conv_ffn.cu`` on ``csrc/conv_tiles.cuh``) on the CPU.

The CUDA kernels run only on a card, so this file carries a numpy model of
what they compute and holds it against the JAX package's Pallas kernels
in interpret mode (``fused_resblock``, ``fused_conv_ffn``), as
``tests/test_torch_vocoder.py`` and ``tests/test_torch_ops.py`` run them:

- TF32 rounding as ``cvt.rna.tf32.f32`` does it (the port's
  ``ops/tf32_pack.tf32_round``, checked here against the bit rule);
- the weights split into big and small planes once: K2's packed in
  fragment order (``ops/tf32_pack.pack_fragments``), K4's as [32-channel
  slice][tap][plane][C][32] rows in the 128-byte swizzle its ``wgmma``
  descriptors read (``ops/cuda_resblock.pack_conv_weight``), both read
  back here; the input split once per element K2 stages, and per tap as
  K4 loads it;
- the 3xTF32 product in the kernels' order: slices of input channels (16
  for K2, 32 for K4), then taps, then 8-channel k-steps, each adding
  w_big x_small, w_small x_big and w_big x_big to a float32 accumulator
  (the tensor core modelled as exact products summed in float64 and
  rounded once per step);
- the shifted tap reads with dilation and the zero fill at the sequence
  edges (lrelu(0) = 0 for the first conv; t is 0 outside [0, L) for the
  second);
- K4's two launches per dilation unit, t through memory, each over blocks
  of 128 positions by NB output channels: the result equals one block
  over the whole row bit for bit, at every NB the grid takes;
- K2's taps split over blocks, each slice's products summed from 0 and
  then added to the running sum, the partials summed in a fixed order with
  b1 before the ReLU, the second conv's hidden channels in groups of
  64-channel slices whose shares are summed in order, and the LayerNorm
  (per-lane sums of 8, a butterfly over 32 lanes, E[y^2] - mean^2, eps
  1e-5).

The last tests pin the 3xTF32 bounds the card's times are held to
(``tools/kernel_bounds.py``).  Sizes: C in {32, 64}, k in {3, 7, 11},
dilations (1, 3, 5), L of 1, below the halo (60 at k = 11) and at the
128-position tile +- 1; K2 at D = 256, H = 128, k2 in {1, 3}, with 1, 3
and 9 tap splits and 1 or 2 hidden groups.  Tolerance 1e-5 absolute against the JAX package: float32
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
from fastspeech2_tpu_torch.ops.tf32_pack import (
    pack_fragments,
    tf32_round,
    unpack_fragments,
)
from fastspeech2_tpu_torch.tools.kernel_bounds import (
    ffn_bound_ms,
    parity_resblock_shapes,
    resblock_bound_ms,
)

DILS = (1, 3, 5)
SLOPE = np.float32(0.1)
SLICE = 16        # input channels per staged slice (K2's first conv)
SLICE_B = 64      # hidden channels per staged slice (K2's second conv)
K4_SLICE = 32     # input channels per K4 stage
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


def weight_planes(w):
    """[C_out, C_in, T] -> big, small [T, C_out, C_in], through the port's
    packing and back, as the kernels read them."""
    packed = pack_fragments(torch.from_numpy(np.ascontiguousarray(
        w.transpose(2, 0, 1))))
    big, small = unpack_fragments(packed)
    return big.numpy(), small.numpy()


def k4_weight_planes(w):
    """[C_out, C_in, T] -> big, small [T, C_out, C_in], through K4's pack
    and back."""
    big, small = unpack_conv_weight(pack_conv_weight(torch.from_numpy(w)))
    return big.numpy(), small.numpy()


def conv_3xtf32(acc, staged, planes, taps, d, n, slice_c, per_slice=False):
    """acc [M, n] + the conv of a staged window: output column c, tap j
    reads staged column c + j d.  staged = (big, small) [C_in, width],
    split once; planes = (big, small) [T, M, C_in]; ``taps`` the tap
    indices this block takes.  The kernels' order: slices of ``slice_c``
    channels, taps, k-steps of 8, three products each.  ``per_slice`` (K2):
    each slice's products are summed from 0 and then added to acc."""
    sb, ss = staged
    wb, ws = planes
    acc = np.asarray(acc, np.float32).copy()
    for c0 in range(0, sb.shape[0], slice_c):
        part = np.zeros_like(acc) if per_slice else acc
        for i, j in enumerate(taps):
            cols = slice(i * d, i * d + n)
            for k0 in range(c0, c0 + slice_c, 8):
                ks = slice(k0, k0 + 8)
                for a, b in ((wb[j][:, ks], ss[ks, cols]),
                             (ws[j][:, ks], sb[ks, cols]),
                             (wb[j][:, ks], sb[ks, cols])):
                    step = (a.astype(np.float64)[:, :, None]
                            * b.astype(np.float64)[None, :, :]).sum(axis=1)
                    part = (part.astype(np.float64) + step).astype(
                        np.float32)
        acc = (acc + part).astype(np.float32) if per_slice else part
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
                              range(k), d, bm, K4_SLICE)
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


def test_weight_planes_are_the_split_weights():
    """The pack holds tf32(w) and tf32(w - tf32(w)) in the order the A
    fragments read (lane 4 g + t: rows g, g + 8 by columns t, t + 4)."""
    w = np.random.default_rng(3).standard_normal((32, 16, 3),
                                                 dtype=np.float32)
    packed = pack_fragments(torch.from_numpy(w.transpose(2, 0, 1).copy()))
    assert packed.shape == (2, 3, 2, 32, 8)
    big, small = split(w.transpose(2, 0, 1))
    g, t = 5, 2
    lane = packed[1, 2, 1, 4 * g + t].numpy()
    rows, cols = (16 + g, 16 + g + 8), (8 + t, 8 + t + 4)
    want = [big[2][rows[0], cols[0]], big[2][rows[1], cols[0]],
            big[2][rows[0], cols[1]], big[2][rows[1], cols[1]]]
    assert np.array_equal(lane[:4], np.array(want, np.float32))
    assert np.array_equal(lane[4], small[2][rows[0], cols[0]])
    assert np.array_equal(tf32_round(torch.from_numpy(w)).numpy(),
                          tf32_rna(w))


# ---- K2 -------------------------------------------------------------------

def layer_norm_epilogue(y, gamma, beta):
    """One warp per row of 256: lane l sums y[l + 32 u] over u in order
    (the square by fma), a butterfly over the 32 lanes, then E[y^2] -
    mean^2 + 1e-5."""
    out = np.empty_like(y)
    for r in range(y.shape[0]):
        lanes = y[r].reshape(8, 32)
        s = np.zeros(32, np.float32)
        sq = np.zeros(32, np.float32)
        for u in range(8):
            v = lanes[u]
            s = (s + v).astype(np.float32)
            sq = (v.astype(np.float64) * v + sq).astype(np.float32)
        for off in (16, 8, 4, 2, 1):
            idx = np.arange(32) ^ off
            s = (s + s[idx]).astype(np.float32)
            sq = (sq + sq[idx]).astype(np.float32)
        mean = np.float32(s[0] / np.float32(256))
        var = np.float32(np.float64(sq[0] / np.float32(256))
                         - np.float64(mean) * mean)
        inv = np.float32(1) / np.float32(np.sqrt(var + np.float32(1e-5)))
        out[r] = (y[r] - mean) * inv * gamma + beta
    return out


def k2_model(x, w1, b1, w2, b2, gamma, beta, splits, groups=1):
    """x [L, 256] of one batch row; w1 [k1, 256, H], w2 [k2, H, 256] (JAX
    layouts).  (a) per split, the partial over its taps; (b) h =
    ReLU(sum of partials in order + b1), 0 outside [0, L), per group of
    hidden channels its share of the second conv in 64-channel slices;
    (c) the shares summed in order, + b2 + x, the LayerNorm."""
    L = x.shape[0]
    k1, _, H = w1.shape
    k2 = w2.shape[0]
    p1 = weight_planes(w1.transpose(2, 1, 0))     # [k1, H, 256]
    p2 = weight_planes(w2.transpose(2, 1, 0))     # [k2, 256, H]
    per = -(-k1 // splits)
    parts = []
    for s in range(-(-k1 // per)):
        taps = range(s * per, min(s * per + per, k1))
        staged = split(window(x.T, taps[0] - (k1 - 1) // 2,
                              L + len(taps) - 1))
        parts.append(conv_3xtf32(np.zeros((H, L)), staged, p1, taps, 1, L,
                                 SLICE, per_slice=True))
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
                            1, L, SLICE_B, per_slice=True)
        acc = share if acc is None else (acc + share).astype(np.float32)
    y = ((acc + b2[:, None]).T + x).astype(np.float32)
    return layer_norm_epilogue(y, gamma, beta)


def _ffn_inputs(L, k2, seed, H=64):
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
    args = _ffn_inputs(L, k2, seed=L + k2, H=128)
    ref = np.asarray(jax_fused_ffn(*(jnp.asarray(a) for a in args), True))
    for b in range(2):
        got = k2_model(args[0][b], *args[1:], splits, groups)
        np.testing.assert_allclose(got, ref[b], atol=ATOL, rtol=0)


def test_k2_split_partials_sum_in_a_fixed_order():
    """5 + 4 taps is a different sum from 3 + 3 + 3: the split changes the
    last bits, never more, and one plan always gives the same bits."""
    args = _ffn_inputs(17, 1, seed=2)
    two, three = (k2_model(args[0][0], *args[1:], s) for s in (2, 3))
    assert np.array_equal(k2_model(args[0][0], *args[1:], 3), three)
    np.testing.assert_allclose(two, three, atol=ATOL, rtol=0)


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
