"""PyTorch port, the arithmetic of K1 and K3 (``csrc/attention.cu``,
``csrc/attention_bwd.cu``) on the CPU.

The CUDA kernels run only on a card, so this file carries a numpy model of
what they compute and holds it against the JAX package's Pallas attention
(``fused_multi_head_attention`` in interpret mode) and its gradients, as
``tests/test_torch_ops.py`` runs them:

- TF32 rounding as ``cvt.rna.tf32.f32`` does it: to nearest, ties away from
  zero, to 10 mantissa bits, on the bit pattern;
- the 3xTF32 product (three TF32 products per eight-wide k-step,
  accumulated in float32; the tensor core modelled as exact products
  summed in float64 and rounded once per step): S = Q K^T and dP = G V^T
  as a_big b_small, a_small b_big, a_big b_big (the score contract every
  route of K1 and K3 shares, ``csrc/attention_f32.cuh``); K1's P V and
  K3's products with P and dS in K4's order, small_big, big_small,
  big_big;
- K1's tiles (``csrc/attention.cu``, wgmma): 32-key tiles with the online
  softmax, the key chunks of the split grid and their combine in the
  fixed order 0, 1, ...;
- K3's tiles (``csrc/attention_bwd.cu``, wgmma): D = rowsum(G o O) in
  the order of its launch, P = exp(s - m) * (1 / l) from K1's row max and row sum, dQ
  per 64 query rows over 32-key tiles in order (K3a), dV and dK per 64 keys
  over 32-row query tiles in order (K3b, whose scores take the score
  contract's K-as-A route: the same bits).

A wrong combine formula, mask order or tile edge shows here in seconds,
without a card.  The last test pins the bound the card's times are held
to (``tools/kernel_bounds.py``, 3xTF32 on the tensor cores).  Inputs: B = 2, H = 2, Dh = 128, one fully padded batch
row, L from 1 to 130 (ragged against every tile).  Tolerance 1e-5
absolute: float32 sums of at most 130 O(1) terms in another order, as in
the JAX package's own kernel tests.
"""

import functools
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fastspeech2_tpu.ops.pallas_attention import fused_multi_head_attention
from fastspeech2_tpu_torch.tools.kernel_bounds import attention_bound_ms

DH = 128
KEY_TILE = 32     # K1's keys per tile
TILE = 64         # K3's rows per block: query rows (K3a), keys (K3b)
MASK = np.float32(-1e9)
INIT_MAX = np.float32(-1e30)
SCALE = np.float32(1.0 / math.sqrt(DH))
LENGTHS = (1, 17, 64, 65, 130)


# ---- TF32 and 3xTF32 ------------------------------------------------------

def tf32_rna(x):
    """cvt.rna.tf32.f32: add half a TF32 unit to the magnitude bits and
    drop the 13 low mantissa bits (sign-magnitude, so ties go away from
    zero)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    x = np.asarray(x, np.float32)
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mma_3xtf32(acc, a, b, small_first=False):
    """acc + a @ b ([..., M, K] @ [..., K, N], K a multiple of 8) as the
    kernels form it: per eight-wide k-step, a_big b_small, a_small b_big
    and a_big b_big, each added to the float32 accumulator
    (``small_first``: a_small b_big first, K4's order, which K1's P V
    takes)."""
    ab, as_ = split(a)
    bb, bs = split(b)
    acc = np.asarray(acc, np.float32)
    order = ((as_, bb), (ab, bs), (ab, bb)) if small_first else (
        (ab, bs), (as_, bb), (ab, bb))
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in order:
            step = x[..., ks].astype(np.float64) @ y[..., ks, :].astype(
                np.float64)
            acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc


def _rows(x, r0, n):
    """rows [r0, r0 + n) of [..., L, D], zeros past L (the kernels'
    zero-filled tiles)."""
    out = np.zeros(x.shape[:-2] + (n, x.shape[-1]), np.float32)
    got = x[..., r0:r0 + n, :]
    out[..., :got.shape[-2], :] = got
    return out


def _flags(pad, k0, n, L):
    """(key < L, key padded) for keys [k0, k0 + n): [n], [B, n]."""
    keys = np.arange(k0, k0 + n)
    ok = keys < L
    padded = np.zeros((pad.shape[0], n), bool)
    padded[:, ok] = pad[:, keys[ok]]
    return ok, padded


def _masked_scores(q_tile, k_tile, padded):
    s = mma_3xtf32(0.0, q_tile, np.swapaxes(k_tile, -1, -2))
    return np.where(padded[:, None, None, :], MASK, s * SCALE)


# ---- K1 ---------------------------------------------------------------------

def k1_model(q, k, v, pad, chunks=1):
    """-> (out, row_max, row_sum) of K1 with the keys split into ``chunks``
    chunks of whole 32-key tiles (1: the single-launch grid)."""
    L = q.shape[2]
    n_tiles = -(-L // KEY_TILE)
    per_chunk = -(-n_tiles // min(chunks, n_tiles))
    parts = []
    for t0 in range(0, n_tiles, per_chunk):
        m = np.full(q.shape[:3], INIT_MAX, np.float32)
        l = np.zeros(q.shape[:3], np.float32)
        o = np.zeros(q.shape, np.float32)
        for kt in range(t0, min(n_tiles, t0 + per_chunk)):
            k0 = kt * KEY_TILE
            ok, padded = _flags(pad, k0, KEY_TILE, L)
            s = _masked_scores(q, _rows(k, k0, KEY_TILE), padded)
            mx = np.maximum(m, np.where(ok, s, INIT_MAX).max(-1))
            alpha = np.exp(m - mx)
            p = np.where(ok, np.exp(np.where(ok, s - mx[..., None], 0)),
                         np.float32(0))
            l = l * alpha + p.sum(-1, dtype=np.float32)
            m = mx
            o = mma_3xtf32(o * alpha[..., None], p, _rows(v, k0, KEY_TILE),
                           small_first=True)
        parts.append((m, l, o))
    if len(parts) == 1:
        m, l, o = parts[0]
        return o * (np.float32(1) / l)[..., None], m, l
    # the combining launch: chunks in the order 0, 1, ...
    mx = np.full(q.shape[:3], INIT_MAX, np.float32)
    for m, _, _ in parts:
        mx = np.maximum(mx, m)
    lsum = np.zeros_like(mx)
    acc = np.zeros(q.shape, np.float32)
    for m, l, o in parts:
        w = np.exp(m - mx)
        lsum = lsum + l * w
        acc = acc + o * w[..., None]
    return acc * (np.float32(1) / lsum)[..., None], mx, lsum


# ---- K3 ---------------------------------------------------------------------

def _row_dot(g, out):
    """D = rowsum(G o O) as K3 forms it: each lane of a row's warp its four
    columns 4 lane .. in order, then a butterfly over the warp's 32
    lanes."""
    prod = (g * out).reshape(g.shape[:-1] + (32, 4))
    lanes = prod[..., 0]
    for c in range(1, 4):
        lanes = (lanes + prod[..., c]).astype(np.float32)
    for off in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[..., np.arange(32) ^ off]).astype(np.float32)
    return lanes[..., 0]


def _probs(s, rows, keys, row_max, row_sum, L):
    """P = exp(s - m) * (1 / l) of the masked, scaled scores s of query
    rows ``rows`` x keys ``keys`` ([..., rows, keys]), 0 where either lies
    at or past L."""
    row_ok = rows < L
    idx = np.minimum(rows, L - 1)
    m = np.where(row_ok, row_max[..., idx], np.float32(0))[..., None]
    inv_l = np.where(row_ok, np.float32(1) / row_sum[..., idx],
                     np.float32(0))[..., None]
    ok = row_ok[:, None] & (keys < L)[None, :]
    return np.where(ok, np.exp(np.where(ok, s - m, 0)) * inv_l,
                    np.float32(0))


def k3_model(q, k, v, pad, out, row_max, row_sum, g):
    """-> (dq, dk, dv) of K3a (D, and dQ per 64 query rows over 32-key
    tiles in order) and K3b (dV and dK per 64 keys over 32-row query tiles
    in order)."""
    L = q.shape[2]
    D = _row_dot(g, out)                                          # K3a
    dq, dk, dv = (np.zeros(q.shape, np.float32) for _ in range(3))

    def ds_of(p, dp, rows):
        d = np.where(rows < L, D[..., np.minimum(rows, L - 1)],
                     np.float32(0))[..., None]
        return p * (dp - d) * SCALE

    for q0 in range(0, L, TILE):
        rows = np.arange(q0, q0 + TILE)
        qt, gt = _rows(q, q0, TILE), _rows(g, q0, TILE)
        acc = np.zeros(q.shape[:2] + (TILE, DH), np.float32)
        for k0 in range(0, L, KEY_TILE):
            keys = np.arange(k0, k0 + KEY_TILE)
            _, padded = _flags(pad, k0, KEY_TILE, L)
            kt = _rows(k, k0, KEY_TILE)
            p = _probs(_masked_scores(qt, kt, padded), rows, keys, row_max,
                       row_sum, L)
            dp = mma_3xtf32(0.0, gt, np.swapaxes(_rows(v, k0, KEY_TILE),
                                                 -1, -2))
            acc = mma_3xtf32(acc, ds_of(p, dp, rows), kt, small_first=True)
        n = min(TILE, L - q0)
        dq[..., q0:q0 + n, :] = acc[..., :n, :]
    for k0 in range(0, L, TILE):                                  # K3b
        keys = np.arange(k0, k0 + TILE)
        _, padded = _flags(pad, k0, TILE, L)
        kt, vt = _rows(k, k0, TILE), _rows(v, k0, TILE)
        acc_dv = acc_dk = np.zeros(q.shape[:2] + (TILE, DH), np.float32)
        for q0 in range(0, L, KEY_TILE):
            rows = np.arange(q0, q0 + KEY_TILE)
            qt, gt = _rows(q, q0, KEY_TILE), _rows(g, q0, KEY_TILE)
            # S^T = K Q^T: the score contract's K-as-A route, the same
            # products in the same order, so S's bits
            p = _probs(_masked_scores(qt, kt, padded), rows, keys, row_max,
                       row_sum, L)
            dp = np.swapaxes(mma_3xtf32(0.0, vt, np.swapaxes(gt, -1, -2)),
                             -1, -2)
            pt = np.swapaxes(p, -1, -2)
            dst = np.swapaxes(ds_of(p, dp, rows), -1, -2)
            acc_dv = mma_3xtf32(acc_dv, pt, gt, small_first=True)
            acc_dk = mma_3xtf32(acc_dk, dst, qt, small_first=True)
        n = min(TILE, L - k0)
        dv[..., k0:k0 + n, :] = acc_dv[..., :n, :]
        dk[..., k0:k0 + n, :] = acc_dk[..., :n, :]
    return dq, dk, dv


# ---- inputs and the JAX reference --------------------------------------------

def _inputs(L, seed=0):
    """[2, 2, L, 128] q, k, v, g; batch row 0 partly padded (unless L is
    1), batch row 1 fully padded."""
    rng = np.random.RandomState(seed + L)
    q, k, v, g = (rng.randn(2, 2, L, DH).astype(np.float32)
                  for _ in range(4))
    lens = np.array([L - L // 4, 0])
    pad = np.arange(L)[None, :] >= lens[:, None]
    return q, k, v, g, pad


@functools.lru_cache(maxsize=None)
def _jax_reference(L):
    """-> (out, dq, dk, dv) of the Pallas kernels in interpret mode."""
    q, k, v, g, pad = _inputs(L)
    out, vjp = jax.vjp(
        lambda q, k, v: fused_multi_head_attention(q, k, v, jnp.asarray(pad),
                                                   True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return tuple(np.asarray(x) for x in (out, *vjp(jnp.asarray(g))))


def _float64_stats(q, k, pad):
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / math.sqrt(DH)
    s = np.where(pad[:, None, None, :], -1e9, s)
    m = s.max(-1)
    return m, np.exp(s - m[..., None]).sum(-1)


# ---- tests --------------------------------------------------------------------

def test_tf32_rna_rounds_to_nearest_ties_away_from_zero():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)     # a TF32 unit at 1
    cases = {
        one + ulp / 2: one + ulp,                      # tie: away from zero
        -(one + ulp / 2): -(one + ulp),
        one + ulp / 2 - np.float32(2.0 ** -23): one,   # below the tie
        one + 3 * ulp / 2: one + 2 * ulp,              # tie, odd neighbour
        np.float32(0.0): np.float32(0.0),
    }
    for x, want in cases.items():
        assert tf32_rna(np.float32(x)) == want, x
    x = np.random.RandomState(0).randn(10000).astype(np.float32) * 100
    r = tf32_rna(x)
    assert not (r.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert (np.abs(r.astype(np.float64) - x) <= 2.0 ** -11 * np.abs(x)).all()


@pytest.mark.parametrize("small_first", [False, True])
def test_3xtf32_product_keeps_float32_accuracy(small_first):
    """3xTF32 is within float32 rounding of the exact product in either
    order of its three products; a single TF32 product (about 3 decimal
    digits) is not."""
    rng = np.random.RandomState(1)
    a = rng.randn(64, DH).astype(np.float32)
    b = rng.randn(DH, 32).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    three = mma_3xtf32(np.zeros((64, 32), np.float32), a, b, small_first)
    single = tf32_rna(a).astype(np.float64) @ tf32_rna(b).astype(np.float64)
    f32 = (a @ b).astype(np.float64)
    err3 = np.abs(three - exact).max()
    assert err3 <= 4 * np.abs(f32 - exact).max() + 1e-6
    assert err3 < 1e-5 and np.abs(single - exact).max() > 100 * err3


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("L", LENGTHS)
def test_k1_tiles_match_pallas_forward(L, chunks):
    q, k, v, _, pad = _inputs(L)
    out, row_max, row_sum = k1_model(q, k, v, pad, chunks)
    np.testing.assert_allclose(out, _jax_reference(L)[0], atol=1e-5, rtol=0)
    # the statistics K3 reads: the row max of the masked, scaled scores
    # and the sum of exp(s - max), a fully padded row's -1e9 and L
    m, l = _float64_stats(q, k, pad)
    np.testing.assert_allclose(row_max, m, atol=1e-5, rtol=0)
    np.testing.assert_allclose(row_sum, l, atol=0, rtol=1e-5)
    assert (row_max[1] == MASK).all() and (row_sum[1] == L).all()


@pytest.mark.parametrize("L", LENGTHS)
def test_k3_tiles_match_pallas_backward(L):
    q, k, v, g, pad = _inputs(L)
    out, row_max, row_sum = k1_model(q, k, v, pad)
    got = k3_model(q, k, v, pad, out, row_max, row_sum, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, _jax_reference(L)[1:]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)
    # the fully padded batch row has the uniform P = 1/L, so its dq and dk
    # are those of the reference kernel and not 0 (ROADMAP, found in the
    # reference); its dv is mean(g) over the rows
    if L > 1:
        assert np.abs(got[0][1]).max() > 1e-3
    np.testing.assert_allclose(got[2][1],
                               np.broadcast_to(g[1].mean(1, keepdims=True),
                                               g[1].shape),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("L", LENGTHS)
def test_k3_tiles_on_the_split_forward(L):
    """K3 reads the statistics of whichever grid K1 ran: the key-split
    combine's row max and row sum give the same gradients."""
    q, k, v, g, pad = _inputs(L)
    out, row_max, row_sum = k1_model(q, k, v, pad, chunks=4)
    got = k3_model(q, k, v, pad, out, row_max, row_sum, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, _jax_reference(L)[1:]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)


def test_attention_bounds_use_the_3xtf32_basis():
    """K1's and K3's least time: three TF32 products per float32-accurate
    one at 495 TFLOP/s, or the bytes at 3.35 TB/s, whichever is larger; the
    SIMT float32 bound (67 TFLOP/s) beside it for the record."""
    ms, by, simt, flops, nbytes = attention_bound_ms(10, 2, 1000)
    assert flops == 4 * 10 * 2 * 1000 ** 2 * DH and by == "operations"
    assert math.isclose(ms, 3 * flops / 495e12 * 1e3)
    assert math.isclose(simt, flops / 67e12 * 1e3)
    ms, by, _, flops, nbytes = attention_bound_ms(10, 2, 1000, backward=True)
    assert flops == 10 * 10 * 2 * 1000 ** 2 * DH
    assert nbytes == 4 * 7 * 10 * 2 * 1000 * DH + 10 * 1000
    assert math.isclose(ms, 3 * flops / 495e12 * 1e3)
    # at the README sentence's encoder length the bytes bound it
    ms, by, _, _, nbytes = attention_bound_ms(1, 2, 32)
    assert by == "bytes" and math.isclose(ms, nbytes / 3.35e12 * 1e3)
