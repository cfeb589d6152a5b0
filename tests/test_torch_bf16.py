"""PyTorch port at bfloat16 (the JAX package's --dtype bfloat16, the JAX
train CLI's default): the plain versions of K1, K2 and K3, the whole model
and the three CLIs, each held against the JAX package at bfloat16 on the
same numpy inputs, at a tiny size.  The JAX side runs its Pallas kernels in
interpret mode.  The CUDA kernels' bfloat16 instances are held against
these plain versions by tests/test_torch_cuda.py and chip_smoke.py, on a
card.

Tolerances are in ulps of bfloat16 at the largest |reference| (one ulp at
1.0 is 2^-7).  A plain version rounds where the TPU kernel rounds, so the
two differ only where a float32 sum taken in another order lands on the
other side of a bfloat16 rounding boundary: one ulp.  Through the whole
model such flips propagate, so there the bound is calibrated on the same
inputs: the port at bfloat16 lies no further from the JAX package at
bfloat16 than the JAX package at bfloat16 lies from itself at float32, and
it differs from the port's own float32 result (it really ran at
bfloat16).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from fastspeech2_tpu.configs.config import OptimConfig as JaxOptimConfig
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JaxFastSpeech2
from fastspeech2_tpu.ops.pallas_attention import (
    attention_op,
    fused_multi_head_attention,
)
from fastspeech2_tpu.ops.pallas_ffn import fused_conv_ffn as jax_fused_ffn
from fastspeech2_tpu.training.optim import make_optimizer
from fastspeech2_tpu.training.step import _apply_model
from fastspeech2_tpu_torch.cli import evaluate_cli, synthesize_cli, train_cli
from fastspeech2_tpu_torch.configs.config import FastSpeech2Config, OptimConfig
from fastspeech2_tpu_torch.models.common import Dropout
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_tpu_torch.models.loss import fastspeech2_loss
from fastspeech2_tpu_torch.ops import cuda_attention, cuda_ffn
from fastspeech2_tpu_torch.ops.attention import plain_attention_backward
from fastspeech2_tpu_torch.training import loop
from fastspeech2_tpu_torch.training.optim import NoamAdam
from fastspeech2_tpu_torch.training.step import batch_to_device, train_step
from fastspeech2_tpu_torch.utils.params_io import from_jax_params
from helpers import init_variables, synthetic_batch, tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "LJSpeech10")
VOCODER = os.path.join(REPO, "weights", "vocoder_gen_mixed60k.npz")
README_SENTENCE = "The quick brown fox jumps over the lazy dog."
BF16 = torch.bfloat16
# XLA on the CPU may skip a bfloat16 rounding inside a fusion (it drops a
# float32 -> bfloat16 -> float32 round trip); compiled without that, the
# JAX reference rounds at every bfloat16 value, as the port does
STRICT = {"xla_allow_excess_precision": False}
# the JAX CLIs on the CPU default to their XLA formulations ("auto"), whose
# FFN in eval mode rounds at bfloat16 as the training path does; the port,
# as the JAX package on its TPU, runs K2's arithmetic there
PALLAS_INTERPRET = {"attention_backend": "pallas_interpret",
                    "ffn_backend": "pallas_interpret"}
OPTIM = dict(batch_size=3, betas=(0.9, 0.98), eps=1e-9, weight_decay=0.0,
             grad_clip_thresh=0.5, grad_acc_step=1, warm_up_step=4,
             anneal_steps=(2,), anneal_rate=0.3, mu_dtype="bfloat16")


def ulps(got, ref):
    """max |got - ref| in ulps of bfloat16 at the largest |ref|."""
    got, ref = (np.asarray(a, np.float64) for a in (got, ref))
    unit = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    return float(np.abs(got - ref).max() / unit)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jax.device_get(x)).astype(np.float32)


def _both(*arrays):
    """float32 numpy arrays -> (torch bfloat16 tensors, jax bfloat16
    arrays); both round to nearest even, so they hold the same values."""
    return ([torch.from_numpy(a).to(BF16) for a in arrays],
            [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays])


def _attention_inputs(B, H, L, D, lens, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, L, D).astype(np.float32) for _ in range(3))
    mask = np.arange(L)[None, :] >= np.asarray(lens)[:, None]
    return q, k, v, mask


# ---- K1, K3, K2: the plain versions at bfloat16 ----------------------------

# lens: a full row, a partly padded row, and a row whose keys are ALL padded
ATTENTION_CASES = [(3, 2, 48, 32, [48, 29, 0]), (2, 2, 70, 16, [70, 0])]


@pytest.mark.parametrize("B,H,L,D,lens", ATTENTION_CASES)
def test_attention_plain_bf16_matches_pallas_interpret(B, H, L, D, lens):
    q, k, v, mask = _attention_inputs(B, H, L, D, lens)
    (tq, tk, tv), (jq, jk, jv) = _both(q, k, v)
    ref = attention_op(jq, jk, jv, jnp.asarray(mask),
                       backend="pallas_interpret")
    before = (cuda_attention.launches, cuda_attention.launches_bf16)
    got = cuda_attention.fused_attention(tq, tk, tv, torch.from_numpy(mask))
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    assert ulps(_np(got), _np(ref)) <= 1
    assert (cuda_attention.launches, cuda_attention.launches_bf16) == before
    # P is rounded to bfloat16 before the product with V: the float32
    # attention of the same inputs is another function
    f32 = cuda_attention.fused_attention(tq.float(), tk.float(), tv.float(),
                                         torch.from_numpy(mask))
    assert not torch.equal(got.float(), f32.to(BF16).float())


@pytest.mark.parametrize("B,H,L,D,lens", ATTENTION_CASES)
def test_attention_backward_plain_bf16_matches_pallas_interpret(B, H, L, D,
                                                                 lens):
    q, k, v, mask = _attention_inputs(B, H, L, D, lens, seed=1)
    g = np.random.RandomState(2).randn(B, H, L, D).astype(np.float32)
    (tq, tk, tv, tg), (jq, jk, jv, jg) = _both(q, k, v, g)
    _, vjp = jax.vjp(
        lambda q, k, v: fused_multi_head_attention(q, k, v,
                                                   jnp.asarray(mask), True),
        jq, jk, jv)
    ref = vjp(jg)
    got = plain_attention_backward(tq, tk, tv, torch.from_numpy(mask), tg)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == BF16 and b.dtype == jnp.bfloat16, name
        assert ulps(_np(a), _np(b)) <= 1, name


def test_attention_function_on_cpu_takes_the_k3_formula():
    """On the CPU the autograd path is the plain K1 forward with K3's plain
    backward, as on the card it is K1 with K3."""
    q, k, v, mask = _attention_inputs(2, 2, 40, 16, [40, 23], seed=3)
    g = np.random.RandomState(4).randn(2, 2, 40, 16).astype(np.float32)
    (tq, tk, tv, tg), _ = _both(q, k, v, g)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = cuda_attention.fused_attention(*leaves, torch.from_numpy(mask))
    got = torch.autograd.grad(out, leaves, tg)
    ref = plain_attention_backward(tq, tk, tv, torch.from_numpy(mask), tg)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k2", [1, 3])
def test_conv_ffn_plain_bf16_matches_pallas_interpret(k2):
    r = np.random.RandomState(k2)
    x = r.randn(2, 24, 16).astype(np.float32)
    weights = [(r.randn(9, 16, 32) * 0.1).astype(np.float32),
               (r.randn(32) * 0.1).astype(np.float32),
               (r.randn(k2, 32, 16) * 0.1).astype(np.float32),
               (r.randn(16) * 0.1).astype(np.float32),
               (1.0 + 0.1 * r.randn(16)).astype(np.float32),
               (0.1 * r.randn(16)).astype(np.float32)]
    (tx,), (jx,) = _both(x)
    ref = jax_fused_ffn(jx, *(jnp.asarray(w) for w in weights), True)
    before = (cuda_ffn.launches, cuda_ffn.launches_bf16)
    got = cuda_ffn.fused_conv_ffn(tx, *(torch.from_numpy(w)
                                        for w in weights))
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    assert ulps(_np(got), _np(ref)) <= 1
    assert (cuda_ffn.launches, cuda_ffn.launches_bf16) == before


def _k1_bf16_model(q, k, v, mask, tile=64, chunks=1, stats=False):
    """The arithmetic of K1's bfloat16 instance (csrc/attention_bf16.cu):
    per 64-key tile an online softmax in float32, the running exp(s - m)
    rounded to bfloat16 before the product with V, 1/l applied to the
    float32 sum at the end; with ``chunks`` > 1 the key-split path, whose
    float32 partials are combined in order.  q, k, v: bfloat16.  With
    ``stats`` also the row max and row sum the kernel writes for K3."""
    scale = 1.0 / q.shape[-1] ** 0.5
    B, H, L, _ = q.shape
    n_tiles = -(-L // tile)
    per = -(-n_tiles // chunks)
    parts = []
    for c0 in range(0, n_tiles, per):
        m = torch.full((B, H, L, 1), -1e30)
        l = torch.zeros(B, H, L, 1)
        o = torch.zeros(B, H, L, q.shape[-1])
        for t0 in range(c0 * tile, min(n_tiles, c0 + per) * tile, tile):
            keys = slice(t0, min(t0 + tile, L))
            s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                             k[:, :, keys].float()) * scale
            s = s.masked_fill(mask[:, None, None, keys], -1e9)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + torch.einsum("bhqk,bhkd->bhqd",
                                         p.to(BF16).float(),
                                         v[:, :, keys].float())
            m = m_new
        parts.append((m, l, o))
    m = torch.stack([p[0] for p in parts]).amax(0)
    w = [torch.exp(p[0] - m) for p in parts]
    l = sum(p[1] * wi for p, wi in zip(parts, w))
    o = sum(p[2] * wi for p, wi in zip(parts, w))
    out = (o / l).to(BF16)
    return (out, m[..., 0], l[..., 0]) if stats else out


@pytest.mark.parametrize("chunks", [1, 2, 3])
@pytest.mark.parametrize("B,H,L,D,lens", ATTENTION_CASES)
def test_k1_bf16_arithmetic_matches_pallas_interpret(B, H, L, D, lens,
                                                      chunks):
    """K1's bfloat16 instance rounds the unnormalised P of its online
    softmax, the TPU kernel the normalised P: the two stay within the
    chip gate's 2 ulps of bfloat16."""
    q, k, v, mask = _attention_inputs(B, H, L, D, lens, seed=5)
    (tq, tk, tv), (jq, jk, jv) = _both(q, k, v)
    ref = attention_op(jq, jk, jv, jnp.asarray(mask),
                       backend="pallas_interpret")
    got = _k1_bf16_model(tq, tk, tv, torch.from_numpy(mask), chunks=chunks)
    assert ulps(_np(got), _np(ref)) <= 2


def _upper(x):
    """float32 x with the lower half of its bit pattern cleared: its leading
    8 significant bits, a bfloat16 value (truncation)."""
    return (x.contiguous().view(torch.int32) & -65536).view(torch.float32)


def _split3(x):
    """float32 x -> its three bfloat16 parts (as float32), hi + mid + lo =
    x (csrc/attention_bf16.cuh: split3): each part the leading bits of what
    the parts before it leave."""
    hi = _upper(x)
    mid = _upper(x - hi)
    lo = (x - hi) - mid
    return hi, mid, lo


def _parts_product(eq, x, y):
    """A float32 x times a bfloat16-exact y as the bfloat16 K3 forms it:
    each of x's three parts times y, accumulated lo, mid, hi."""
    hi, mid, lo = _split3(x)
    out = torch.einsum(eq, lo, y)
    out = out + torch.einsum(eq, mid, y)
    return out + torch.einsum(eq, hi, y)


def _k3_bf16_model(q, k, v, mask, g, row_max, row_sum, tile=64):
    """The arithmetic of K3's bfloat16 instance (csrc/attention_bwd_bf16.cu)
    from K1's row statistics: P = exp(s - m) * (1 / l) in float32; K3a walks the
    64-key tiles twice per query row, first for D = rowsum(dP * P), then
    for dQ += dS K key tile by key tile; K3b walks the 64-row query tiles
    for each key, dV += P^T G and dK += dS^T Q; every product with P or dS
    as three bfloat16 parts (_parts_product).  q, k, v, g: bfloat16."""
    scale = 1.0 / q.shape[-1] ** 0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    L = q.shape[2]
    m, inv_l = row_max[..., None], 1.0 / row_sum[..., None]

    def probs(rows, keys):
        s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, rows],
                         kf[:, :, keys]) * scale
        s = s.masked_fill(mask[:, None, None, keys], -1e9)
        p = torch.exp(s - m[:, :, rows]) * inv_l[:, :, rows]
        dp = torch.einsum("bhqd,bhkd->bhqk", gf[:, :, rows], vf[:, :, keys])
        return p, dp

    tiles = [slice(t0, min(t0 + tile, L)) for t0 in range(0, L, tile)]
    everything = slice(0, L)
    D = torch.zeros_like(m)
    for keys in tiles:
        p, dp = probs(everything, keys)
        D = D + (dp * p).sum(-1, keepdim=True)
    dq = torch.zeros_like(qf)
    for keys in tiles:
        p, dp = probs(everything, keys)
        ds = p * (dp - D) * scale
        dq = dq + _parts_product("bhqk,bhkd->bhqd", ds, kf[:, :, keys])
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for rows in tiles:
        p, dp = probs(rows, everything)
        hi, mid, lo = _split3(p)
        assert torch.equal((hi + mid) + lo, p)   # P re-read from its parts
        ds = p * (dp - D[:, :, rows]) * scale
        dv = dv + _parts_product("bhqk,bhqd->bhkd", p, gf[:, :, rows])
        dk = dk + _parts_product("bhqk,bhqd->bhkd", ds, qf[:, :, rows])
    return dq.to(BF16), dk.to(BF16), dv.to(BF16)


@pytest.mark.parametrize("B,H,L,D,lens", ATTENTION_CASES)
def test_k3_bf16_arithmetic_matches_pallas_interpret(B, H, L, D, lens):
    """K3's bfloat16 instance (D from float32 P over all keys, dQ key tile
    by key tile, the products with P and dS as three exact bfloat16 parts),
    from K1's row statistics, lies within the chip gate's 2 ulps of
    bfloat16 of the TPU kernel's gradients, a fully padded row and ragged L
    included."""
    q, k, v, mask = _attention_inputs(B, H, L, D, lens, seed=6)
    g = np.random.RandomState(7).randn(B, H, L, D).astype(np.float32)
    (tq, tk, tv, tg), (jq, jk, jv, jg) = _both(q, k, v, g)
    _, vjp = jax.vjp(
        lambda q, k, v: fused_multi_head_attention(q, k, v,
                                                   jnp.asarray(mask), True),
        jq, jk, jv)
    ref = vjp(jg)
    tmask = torch.from_numpy(mask)
    _, row_max, row_sum = _k1_bf16_model(tq, tk, tv, tmask, stats=True)
    got = _k3_bf16_model(tq, tk, tv, tmask, tg, row_max, row_sum)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert ulps(_np(a), _np(b)) <= 2, name


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_split3_is_exact(seed):
    """A float32 value is the sum of its three bfloat16 parts exactly, from
    1e-30 to 1e4 and at probabilities' size, so the bfloat16 K3's products
    with P and dS are float32-accurate (the dropped nothing is exact)."""
    r = np.random.RandomState(seed)
    x = torch.from_numpy((r.randn(4096) * 10.0 ** r.uniform(
        -30, 4, 4096)).astype(np.float32))
    x = torch.cat([x, torch.from_numpy(r.rand(1024).astype(np.float32))])
    hi, mid, lo = _split3(x)
    for part in (hi, mid, lo):
        assert torch.equal(part.to(BF16).float(), part)
    assert torch.equal((hi + mid) + lo, x)
    assert torch.equal(hi, _upper(x))


def test_bf16_ffn_pack_is_the_swizzled_rows():
    """pack_rows_bf16 (K2's bfloat16 pack): per (64-channel slice s, tap j)
    an [N][64] plane of the weights rounded to bfloat16, the 16-byte chunk
    c of row n at chunk c ^ (n % 8) (the 128-byte swizzle the bfloat16
    wgmma's B descriptor reads), and unpack_rows_bf16 reads it back."""
    from fastspeech2_tpu_torch.ops.tf32_pack import (
        pack_rows_bf16,
        unpack_rows_bf16,
    )

    a = torch.from_numpy(np.random.RandomState(0).randn(3, 24, 128).astype(
        np.float32))
    packed = pack_rows_bf16(a)
    assert packed.dtype == BF16 and packed.shape == (2, 3, 24, 64)
    ab = a.to(BF16)
    for s, j, n in ((0, 0, 0), (1, 2, 13), (0, 1, 23)):
        for c in range(8):
            at = 8 * (c ^ (n % 8))
            assert torch.equal(packed[s, j, n, at:at + 8],
                               ab[j, n, 64 * s + 8 * c:64 * s + 8 * c + 8])
    assert torch.equal(unpack_rows_bf16(packed), ab)
    with pytest.raises(ValueError, match="multiple of 64"):
        pack_rows_bf16(a[..., :96])


def test_bf16_bounds():
    """K1 and K2 at bfloat16: one BF16 product at 989 TFLOP/s against
    2-byte activations; K3: S and dP as BF16 products, dV, dK and dQ at the
    cheaper of two TF32 passes at 495 TFLOP/s and three BF16 passes at 989:
    three BF16 passes."""
    from fastspeech2_tpu_torch.tools.kernel_bounds import (
        attention_bound_ms,
        ffn_bound_ms,
    )

    ms, by, _, flops, nbytes = attention_bound_ms(10, 2, 1000,
                                                  dtype="bfloat16")
    assert by == "operations" and ms == pytest.approx(flops / 989e12 * 1e3)
    assert nbytes == 2 * 4 * 10 * 2 * 1000 * 128 + 10 * 1000
    ms3, by3, _, flops3, nbytes3 = attention_bound_ms(
        10, 2, 1000, backward=True, dtype="bfloat16")
    bhl2d = 10 * 2 * 1000 * 1000 * 128
    assert flops3 == 10 * bhl2d
    assert 3 / 989e12 < 2 / 495e12
    assert by3 == "operations" and ms3 == pytest.approx(
        (4 * bhl2d / 989e12 + 3 * 6 * bhl2d / 989e12) * 1e3)
    assert ms3 == pytest.approx(0.0569, abs=1e-4)
    assert ms3 < attention_bound_ms(10, 2, 1000, backward=True)[0]
    assert nbytes3 < attention_bound_ms(10, 2, 1000, backward=True)[4]
    ms, by, _, flops, _ = ffn_bound_ms(1, 1000, dtype="bfloat16")
    assert by == "operations" and ms == pytest.approx(flops / 989e12 * 1e3)


# ---- the whole model ---------------------------------------------------------

def _port_config(jax_cfg):
    fields = FastSpeech2Config.__dataclass_fields__
    return FastSpeech2Config(**{f: getattr(jax_cfg, f) for f in fields})


def _numpy_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(jax.device_get(tree))


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)).long()
            if np.issubdtype(np.asarray(v).dtype, np.integer)
            else torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    """A tiny JAX model on the Pallas interpret backends with random
    BatchNorm statistics, its weights in the port, three batches, and the
    JAX loss gradient at either dtype.

    The gradients take the FFN's training path (ffn_backend "xla" in eval
    mode, the formula the JAX training step differentiates): the JAX
    package's Pallas FFN has no bfloat16 gradient (its custom VJP mixes a
    bfloat16 cotangent with float32 weights), and training never asks for
    one.  The port's counterpart is :func:`_training_ffn`."""
    jax_cfg = tiny_config(max_seq_len=48, attention_backend="pallas_interpret",
                          ffn_backend="pallas_interpret")
    batches = [synthetic_batch(jax_cfg, B=3, P=10, T=40, seed=s)
               for s in (1, 2, 3)]
    variables = _numpy_tree(init_variables(JaxFastSpeech2(jax_cfg),
                                           batches[0]))
    rng = np.random.RandomState(0)
    for stats in variables["batch_stats"]["postnet"].values():
        stats["mean"] = (0.2 * rng.randn(*stats["mean"].shape)).astype(
            np.float32)
        stats["var"] = (1.0 + 0.2 * rng.uniform(-1, 1, stats["var"].shape)
                        ).astype(np.float32)

    grad_cfg = dataclasses.replace(jax_cfg, ffn_backend="xla")
    example = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def grad_fn(dtype):
        model = JaxFastSpeech2(grad_cfg, dtype=dtype)

        def loss(params, batch):
            losses, _, _ = _apply_model(model, grad_cfg, params,
                                        variables["batch_stats"], batch,
                                        None, train=False)
            return losses.total, losses

        # one compile serves every batch (they share their shapes)
        return jax.jit(jax.grad(loss, has_aux=True)).lower(
            variables["params"], example).compile(
                compiler_options=STRICT)

    grads = {dt: grad_fn(dt) for dt in (jnp.float32, jnp.bfloat16)}
    return jax_cfg, variables, _port_config(jax_cfg), batches, grads


def _port_model(cfg, variables, dtype):
    model = FastSpeech2(cfg, dtype=dtype)
    model.load_state_dict(from_jax_params(variables, cfg))
    return model.eval()


def _training_ffn(model):
    """The FFN sublayers on their training path with dropout 0, the rest
    of the model in eval mode: the function the fixture's gradients
    differentiate."""
    for block in (*model.encoder.layer_stack, *model.decoder.layer_stack):
        block.pos_ffn.train()
        block.pos_ffn.dropout.rate = 0.0
    return model


def _jax_forward(jax_cfg, variables, batch, dtype, train=False):
    kwargs = {}
    if train:
        kwargs = dict(rngs={"dropout": jax.random.PRNGKey(0)},
                      mutable=["batch_stats"])
    out = JaxFastSpeech2(jax_cfg, dtype=dtype).apply(
        variables, jnp.asarray(batch["speakers"]),
        jnp.asarray(batch["texts"]), jnp.asarray(batch["src_lens"]),
        mel_lens=jnp.asarray(batch["mel_lens"]),
        max_mel_len=batch["mels"].shape[1],
        p_targets=jnp.asarray(batch["pitches"]),
        e_targets=jnp.asarray(batch["energies"]),
        d_targets=jnp.asarray(batch["durations"]), train=train, **kwargs)
    return out[0] if train else out


def _port_forward(model, batch):
    t = _tensors(batch)
    with torch.no_grad():
        return model(t["speakers"], t["texts"], t["src_lens"],
                     mel_lens=t["mel_lens"], max_mel_len=t["mels"].shape[1],
                     p_targets=t["pitches"], e_targets=t["energies"],
                     d_targets=t["durations"])


FIELDS = ("mel", "postnet_mel", "pitch_prediction", "energy_prediction",
          "log_duration_prediction")


def _assert_calibrated(got, ref, ref_f32, got_f32, names):
    for name in names:
        g, r, r32, g32 = (_np(getattr(o, name))
                          for o in (got, ref, ref_f32, got_f32))
        assert getattr(got, name).dtype == BF16, name
        port_err = np.abs(g - r).max()
        assert port_err <= np.abs(r - r32).max(), name
        assert np.abs(g - g32).max() > 0, name


def test_teacher_forced_bf16_outputs_match_jax(setup):
    jax_cfg, variables, cfg, batches, _ = setup
    ref, ref_f32 = (_jax_forward(jax_cfg, variables, batches[0], dt)
                    for dt in (jnp.bfloat16, jnp.float32))
    got, got_f32 = (_port_forward(_port_model(cfg, variables, dt),
                                  batches[0]) for dt in (BF16, torch.float32))
    _assert_calibrated(got, ref, ref_f32, got_f32, FIELDS)


def test_train_mode_bf16_outputs_match_jax(setup):
    """Train mode with the dropout rates before the PostNet at 0, so the
    pre-PostNet mel and the predictions are deterministic; the FFN takes
    its training path, which rounds otherwise than K2."""
    jax_cfg, variables, cfg, batches, _ = setup
    no_dropout = dataclasses.replace(jax_cfg, encoder_dropout=0.0,
                                     decoder_dropout=0.0, vp_dropout=0.0)
    ref, ref_f32 = (_jax_forward(no_dropout, variables, batches[0], dt,
                                 train=True)
                    for dt in (jnp.bfloat16, jnp.float32))
    outs = []
    for dt in (BF16, torch.float32):
        model = _port_model(cfg, variables, dt)
        for name, m in model.named_modules():
            if isinstance(m, Dropout) and not name.startswith("postnet"):
                m.rate = 0.0
        outs.append(_port_forward(model.train(), batches[0]))
    _assert_calibrated(outs[0], ref, ref_f32, outs[1],
                       [f for f in FIELDS if f != "postnet_mel"])


def test_bf16_gradients_match_jax(setup):
    """Eval mode with the FFN's training path (the fixture says why), so
    the step is deterministic.  The parameters and their gradients stay
    float32.  Calibrated against the JAX package's bfloat16 error (its
    distance from its float32 gradient): over all parameters together, in
    relative L2, the port lies no further from the JAX package at bfloat16
    than that; per parameter, relative to its largest |gradient|, no
    further than twice that.  (The port sums a bias's gradient over the
    positions in float32 and rounds once; the JAX package's bfloat16
    reduction rounds as it goes.  Each result then carries its own error of
    the reference's size, so the two may differ by their sum.)"""
    jax_cfg, variables, cfg, batches, grads = setup
    names, port, refs = [], [], {dt: [] for dt in (jnp.float32,
                                                     jnp.bfloat16)}
    for batch in batches:
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        ref = {dt: from_jax_params(
            {"params": _numpy_tree(grads[dt](variables["params"], jb)[0])},
            cfg) for dt in refs}
        model = _training_ffn(_port_model(cfg, variables, BF16))
        t = _tensors(batch)
        out = model(t["speakers"], t["texts"], t["src_lens"],
                    mel_lens=t["mel_lens"], max_mel_len=t["mels"].shape[1],
                    p_targets=t["pitches"], e_targets=t["energies"],
                    d_targets=t["durations"])
        fastspeech2_loss(cfg, out, t["mels"], t["pitches"], t["energies"],
                         t["durations"]).total.backward()
        for name, p in model.named_parameters():
            if name.endswith("slf_attn.w_ks.bias"):
                continue   # 0 in exact arithmetic: rounding noise only
            assert p.grad.dtype == torch.float32, name
            got = p.grad.numpy()
            r16, r32 = ref[jnp.bfloat16][name].numpy(), ref[
                jnp.float32][name].numpy()
            scale = max(float(np.abs(r32).max()), 1e-2)
            assert np.abs(got - r16).max() <= 2 * max(
                np.abs(r16 - r32).max(), 1e-3 * scale), name
            names.append(name)
            port.append(got.ravel())
            for dt in refs:
                refs[dt].append(ref[dt][name].numpy().ravel())
    got, r16, r32 = (np.concatenate(a) for a in (port, refs[jnp.bfloat16],
                                                  refs[jnp.float32]))
    assert np.linalg.norm(got - r16) <= np.linalg.norm(r16 - r32)


def test_bf16_trajectory_matches_jax_optimizer(setup):
    """Three updates at bfloat16 (eval mode, the FFN's training path), the
    optimizer in float32 with a bfloat16 first moment: the losses no
    further from the JAX package's at bfloat16 than those are from its
    float32 ones, and each parameter after the updates within twice the
    JAX package's own bfloat16 distance (as the gradients are held)."""
    jax_cfg, variables, cfg, batches, grads = setup
    optimizer, _ = make_optimizer(JaxOptimConfig(**OPTIM),
                                  jax_cfg.encoder_hidden)
    results = {}
    for dt in (jnp.float32, jnp.bfloat16):
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        opt_state = optimizer.init(params)
        losses = []
        for batch in batches:
            g, ls = grads[dt](params, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
            updates, opt_state = optimizer.update(g, opt_state, params)
            params = optax.apply_updates(params, updates)
            losses.append([float(v) for v in ls])
        results[dt] = (np.asarray(losses), from_jax_params(
            {"params": _numpy_tree(params)}, cfg))

    model = _training_ffn(_port_model(cfg, variables, BF16))
    opt = NoamAdam(model.parameters(), OptimConfig(**OPTIM),
                   cfg.encoder_hidden)
    got = np.asarray([[float(v) for v in train_step(model, opt,
                                                    _tensors(b), i)]
                      for i, b in enumerate(batches)])
    ref, ref32 = results[jnp.bfloat16][0], results[jnp.float32][0]
    assert np.abs(got - ref).max() <= np.abs(ref - ref32).max()
    for name, p in model.named_parameters():
        if name.endswith("slf_attn.w_ks.bias"):
            continue
        assert p.dtype == torch.float32
        want = results[jnp.bfloat16][1][name].numpy()
        want32 = results[jnp.float32][1][name].numpy()
        diff = np.abs(p.detach().numpy() - want).max()
        assert diff <= 2 * max(np.abs(want - want32).max(), 1e-6), name


# ---- mel_bf16 --------------------------------------------------------------

def test_mel_bf16_rounds_the_mels_on_the_host(setup):
    """train.yaml's transfer.mel_bf16: the mels go to the device as
    bfloat16 (fastspeech2_tpu/training/loop.py:263-276) and are upcast to
    float32 before the model and the loss (training/step.py:20-24)."""
    batch = setup[3][0]
    plain = batch_to_device(batch, "cpu")
    wire = batch_to_device(batch, "cpu", mel_bf16=True)
    assert plain["mels"].dtype == torch.float32
    assert wire["mels"].dtype == BF16
    assert torch.equal(wire["mels"].float(), plain["mels"].to(BF16).float())
    assert not torch.equal(wire["mels"].float(), plain["mels"])
    for key in plain:
        if key != "mels":
            assert torch.equal(wire[key], plain[key]), key


# ---- the CLIs --------------------------------------------------------------

def _tiny_workspace(tmp_path, mel_bf16=False):
    from fastspeech2_tpu_torch.data.synthetic import (
        generate_corpus,
        synthetic_preprocess_config,
    )

    corpus = str(tmp_path / "corpus")
    generate_corpus(corpus, n_utterances=16, seed=3, val_size=5, n_mels=8)
    with open(f"{CONFIG}/model.yaml") as f:
        model_cfg = yaml.safe_load(f)
    model_cfg["transformer"].update(encoder_layer=1, decoder_layer=1,
                                    encoder_hidden=16, decoder_hidden=16,
                                    conv_filter_size=32)
    model_cfg["variance_predictor"]["filter_size"] = 16
    model_cfg["variance_embedding"]["n_bins"] = 16
    model_cfg["max_seq_len"] = 64
    model_cfg["postnet"] = {"embedding_dim": 16, "kernel_size": 5,
                            "n_convolutions": 3}
    model_cfg.update(PALLAS_INTERPRET)
    with open(f"{CONFIG}/train.yaml") as f:
        train_cfg = yaml.safe_load(f)
    train_cfg["path"] = {k: str(tmp_path / k) for k in
                         ("ckpt_path", "log_path", "result_path")}
    train_cfg["optimizer"]["batch_size"] = 4
    train_cfg["step"].update(total_step=2, log_step=1, val_step=2,
                             save_step=2, synth_step=1000)
    train_cfg["bucket"] = {"text": 8, "mel": 32}
    if mel_bf16:
        train_cfg["transfer"] = {"mel_bf16": True}
    paths = []
    for name, cfg in (("preprocess", synthetic_preprocess_config(
            corpus, n_mels=8)), ("model", model_cfg), ("train", train_cfg)):
        path = tmp_path / f"{name}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        paths += [f"-{name[0]}", str(path)]
    return paths


def test_train_cli_honours_mel_bf16(tmp_path, monkeypatch):
    """The train CLI at its default dtype with transfer.mel_bf16 in
    train.yaml: every training batch reaches the step with bfloat16 mels,
    and the model computes at bfloat16."""
    seen = []
    inner = loop.train_step

    def spy(model, optimizer, batch, step, grad_acc_step=1):
        seen.append((batch["mels"].dtype, model.dtype))
        return inner(model, optimizer, batch, step, grad_acc_step)

    monkeypatch.setattr(loop, "train_step", spy)
    _, _, step = train_cli.main(_tiny_workspace(tmp_path, mel_bf16=True)
                                + ["--device", "cpu"])
    assert step == 2 and seen == [(BF16, BF16)] * 2


def _strict_jax_cli(module, argv):
    """The JAX package's ``module``.main(argv) in a subprocess whose XLA
    rounds at every bfloat16 value (STRICT; the flag must be set before
    XLA starts) -> main's return value, through JSON."""
    import json
    import subprocess
    import sys

    code = ("import json, sys, jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            f"from fastspeech2_tpu.cli.{module} import main\n"
            "out = main(sys.argv[1:])\n"
            "print('RESULT ' + json.dumps(out))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=" ".join(f"--{k}={str(v).lower()}"
                                  for k, v in STRICT.items()))
    proc = subprocess.run([sys.executable, "-c", code, *argv], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600, check=True)
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _jax_npz(tmp_path, args, seed):
    from fastspeech2_tpu.configs.config import (
        FastSpeech2Config as JaxFastSpeech2Config,
    )
    from fastspeech2_tpu.configs.config import load_yaml_configs
    from fastspeech2_tpu.utils.params_io import save_variables_npz

    pre, model_cfg, _ = load_yaml_configs(*args[1::2])
    jax_cfg = JaxFastSpeech2Config.build(pre, model_cfg)
    npz = str(tmp_path / "acoustic.npz")
    save_variables_npz(npz, dict(init_variables(
        JaxFastSpeech2(jax_cfg), synthetic_batch(jax_cfg, seed=seed),
        seed=seed)))
    return npz


def test_evaluate_cli_bf16_matches_jax_cli(tmp_path):
    """Both evaluate CLIs at --dtype bfloat16 on the same npz weights and
    synthetic val set, the JAX CLI with XLA rounding at every bfloat16
    value (STRICT); the losses are float32 means of bfloat16 outputs,
    calibrated against the JAX CLI at float32."""
    from fastspeech2_tpu.cli.evaluate_cli import main as jax_main

    args = _tiny_workspace(tmp_path)
    npz = _jax_npz(tmp_path, args, seed=6)
    common = args + ["--weights_npz", npz]
    ref = np.asarray(_strict_jax_cli("evaluate_cli",
                                     common + ["--dtype", "bfloat16"]))
    ref32 = np.asarray(jax_main(common))
    got = np.asarray(evaluate_cli.main(common + ["--dtype", "bfloat16",
                                                 "--device", "cpu"]))
    got32 = np.asarray(evaluate_cli.main(common + ["--device", "cpu"]))
    assert np.abs(got - ref).max() <= np.abs(ref - ref32).max()
    assert not np.array_equal(got, got32)


def test_synthesize_cli_bf16_matches_jax_cli(tmp_path, monkeypatch):
    """Both synthesize CLIs at --dtype bfloat16 on the README sentence with
    the tiny model of test_torch_port.py (the tracked full-size weights
    run on the card, in chip_smoke.py).  The phone IDs must match exactly.
    The durations come from round(exp(log_d) - 1) of a bfloat16 log_d: a
    log_d within an ulp of a .5 boundary may round the other way in the
    two packages, which changes the mel length; this seed has no such
    phone, and a flip would fail the equality below, naming the phones.
    The wav (float32 vocoder on the upcast bfloat16 mel) is held to 1% of
    full scale, calibrated like the model: no further from the JAX CLI's
    bfloat16 wav than that is from its float32 wav."""
    from scipy.io import wavfile

    from fastspeech2_tpu.cli.synthesize_cli import main as jax_main
    from test_torch_port import _tiny_setup

    monkeypatch.chdir(REPO)
    model_path, train_path, npz = _tiny_setup(tmp_path)
    with open(model_path) as f:
        model_cfg = yaml.safe_load(f)
    with open(model_path, "w") as f:
        yaml.safe_dump(dict(model_cfg, **PALLAS_INTERPRET), f)
    common = ["--mode", "single", "--text", README_SENTENCE,
              "-p", f"{CONFIG}/preprocess.yaml", "-m", model_path,
              "-t", train_path, "--weights_npz", npz,
              "--vocoder_ckpt", VOCODER]
    name = README_SENTENCE[:100] + ".wav"
    refs = {}
    jax_main(common)
    refs["float32"] = wavfile.read(tmp_path / "jax_result" / name)[1]
    _strict_jax_cli("synthesize_cli", common + ["--dtype", "bfloat16"])
    refs["bfloat16"] = wavfile.read(tmp_path / "jax_result" / name)[1]
    ids = []
    inner = synthesize_cli.Synthesizer.infer_ids

    def spy(self, id_seqs, *args, **kwargs):
        ids.append([np.asarray(s) for s in id_seqs])
        return inner(self, id_seqs, *args, **kwargs)

    monkeypatch.setattr(synthesize_cli.Synthesizer, "infer_ids", spy)
    wavs, out, paths = synthesize_cli.main(
        common + ["--dtype", "bfloat16", "--device", "cpu", "--result_path",
                  str(tmp_path / "torch_result")])
    assert out.postnet_mel.dtype == BF16

    from fastspeech2_tpu.cli.common import load_model_for_inference
    from fastspeech2_tpu.configs.config import load_yaml_configs
    from fastspeech2_tpu.synthesis import Synthesizer as JaxSynthesizer

    configs = load_yaml_configs(f"{CONFIG}/preprocess.yaml", model_path,
                                train_path)
    jax_model, variables, jax_cfg = load_model_for_inference(
        configs, dtype=jnp.bfloat16, weights_npz=npz)
    jax_synth = JaxSynthesizer(jax_model, variables, jax_cfg, configs[0])
    ref_ids, _ = jax_synth.text_to_ids(README_SENTENCE)
    np.testing.assert_array_equal(ids[0][0], ref_ids)
    ref_out = jax_synth.infer_ids([ref_ids])
    got_d = out.duration_rounded.numpy()
    ref_d = np.asarray(ref_out.duration_rounded)
    assert np.array_equal(got_d, ref_d), (
        f"durations flipped at phones {np.nonzero(got_d != ref_d)[1]}")

    got = wavfile.read(paths[0])[1].astype(np.float64)
    ref, ref32 = (refs[k].astype(np.float64) for k in ("bfloat16",
                                                       "float32"))
    assert got.shape == ref.shape == (int(out.mel_len[0]) * 256,)
    assert np.abs(got).max() > 0
    assert np.abs(got - ref).max() <= 0.01 * 32768
    assert np.abs(got - ref).max() <= np.abs(ref - ref32).max()
