"""PyTorch port, ops and kernels: each op of fastspeech2_tpu_torch.ops held
against its JAX counterpart on the same numpy inputs.

K1, K2 and K3 (the attention backward) are compared with the JAX package's
Pallas kernels run in interpret mode, as tests/test_pallas.py and
tests/test_pallas_ffn.py run them on the CPU.  On the CPU the port's wrappers compute their plain
versions; the CUDA kernels themselves are held against those plain
versions by tests/test_torch_cuda.py, on a card.

Tolerances: 1e-5 absolute in float32 for attention and the FFN (sums of a
few dozen O(1) terms in another order, as the JAX package's own kernel
tests allow); exact for the integer and table ops.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastspeech2_tpu.ops.length_regulator import (
    length_regulate as jax_length_regulate,
)
from fastspeech2_tpu.ops.masking import pad_mask_from_lengths as jax_pad_mask
from fastspeech2_tpu.ops.pallas_attention import (
    attention_op,
    fused_multi_head_attention,
)
from fastspeech2_tpu.ops.pallas_ffn import fused_conv_ffn as jax_fused_ffn
from fastspeech2_tpu.ops.positional import (
    sinusoid_position_encoding as jax_pe,
)
from fastspeech2_tpu_torch.ops import cuda_attention, cuda_ffn
from fastspeech2_tpu_torch.ops.attention import (
    multi_head_attention,
    plain_attention_backward,
)
from fastspeech2_tpu_torch.ops.length_regulator import length_regulate
from fastspeech2_tpu_torch.ops.masking import (
    fill_masked,
    pad_mask_from_lengths,
)
from fastspeech2_tpu_torch.ops.positional import sinusoid_position_encoding


def _attention_inputs(B, H, L, D, lens, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, L, D).astype(np.float32) for _ in range(3))
    mask = np.arange(L)[None, :] >= np.asarray(lens)[:, None]
    return q, k, v, mask


def _ffn_inputs(B=2, L=24, D=16, H=32, k1=9, k2=1, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(B, L, D).astype(np.float32),
            (r.randn(k1, D, H) * 0.1).astype(np.float32),
            (r.randn(H) * 0.1).astype(np.float32),
            (r.randn(k2, H, D) * 0.1).astype(np.float32),
            (r.randn(D) * 0.1).astype(np.float32),
            (1.0 + 0.1 * r.randn(D)).astype(np.float32),
            (0.1 * r.randn(D)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---- K1: attention --------------------------------------------------------

# lens: a full row, a partly padded row, and a row whose keys are ALL padded
@pytest.mark.parametrize("B,H,L,D,lens", [
    (3, 2, 48, 32, [48, 29, 0]),
    (2, 2, 70, 16, [70, 0]),
])
def test_attention_plain_matches_pallas_interpret(B, H, L, D, lens):
    q, k, v, mask = _attention_inputs(B, H, L, D, lens)
    ref = np.asarray(attention_op(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(mask),
                                  backend="pallas_interpret"))
    got = cuda_attention.fused_attention(*_t(q, k, v, mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_attention_fully_padded_row_is_uniform_mean_of_v():
    q, k, v, mask = _attention_inputs(1, 2, 40, 16, [0])
    got = multi_head_attention(*_t(q, k, v, mask)).numpy()
    assert np.isfinite(got).all()
    mean_v = v.mean(axis=2, keepdims=True)
    np.testing.assert_allclose(got, np.broadcast_to(mean_v, got.shape),
                               atol=1e-5)


def test_attention_wrapper_uses_plain_version_on_cpu():
    q, k, v, mask = _t(*_attention_inputs(2, 2, 20, 8, [20, 7]))
    before = cuda_attention.launches
    torch.testing.assert_close(cuda_attention.fused_attention(q, k, v, mask),
                               multi_head_attention(q, k, v, mask),
                               rtol=0, atol=0)
    assert cuda_attention.launches == before


# ---- K3: attention backward -----------------------------------------------

# a full row, a partly padded row, and a row whose keys are ALL padded
@pytest.mark.parametrize("B,H,L,D,lens", [
    (3, 2, 48, 32, [48, 29, 0]),
    (2, 2, 70, 16, [70, 0]),
])
def test_attention_backward_plain_matches_pallas_interpret(B, H, L, D, lens):
    q, k, v, mask = _attention_inputs(B, H, L, D, lens, seed=1)
    g = np.random.RandomState(2).randn(B, H, L, D).astype(np.float32)
    _, vjp = jax.vjp(
        lambda q, k, v: fused_multi_head_attention(q, k, v,
                                                   jnp.asarray(mask), True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))
    got = plain_attention_backward(*_t(q, k, v, mask, g))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_attention_backward_plain_matches_autograd():
    """Rows with a key to attend to: the explicit formula is autograd's
    gradient.  (A row whose keys are all padded is the exception: there
    the formula, like the TPU kernel, differs from the gradient of the
    masked fill; see test_attention_backward_plain_matches_pallas_interpret
    and tests/test_torch_cuda.py.)"""
    q, k, v, mask = _attention_inputs(2, 2, 33, 16, [33, 20], seed=4)
    g = np.random.RandomState(5).randn(2, 2, 33, 16).astype(np.float32)
    leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
    ref = torch.autograd.grad(
        multi_head_attention(*leaves, torch.from_numpy(mask)), leaves,
        torch.from_numpy(g))
    got = plain_attention_backward(*_t(q, k, v, mask, g))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


# ---- K2: conv FFN ---------------------------------------------------------

@pytest.mark.parametrize("k2", [1, 3])
def test_conv_ffn_plain_matches_pallas_interpret(k2):
    args = _ffn_inputs(k2=k2)
    ref = np.asarray(jax_fused_ffn(*(jnp.asarray(a) for a in args), True))
    got = cuda_ffn.fused_conv_ffn(*_t(*args)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_conv_ffn_wrapper_uses_plain_version_on_cpu():
    args = _t(*_ffn_inputs(L=11))
    before = cuda_ffn.launches
    torch.testing.assert_close(cuda_ffn.fused_conv_ffn(*args),
                               cuda_ffn.plain_conv_ffn(*args), rtol=0, atol=0)
    assert cuda_ffn.launches == before


# ---- masking, positions, length regulator ---------------------------------

def test_pad_mask_and_fill_match_jax():
    lens = np.array([5, 0, 9], np.int32)
    ref = np.asarray(jax_pad_mask(jnp.asarray(lens), 9))
    got = pad_mask_from_lengths(torch.from_numpy(lens), 9)
    np.testing.assert_array_equal(got.numpy(), ref)
    x = torch.ones(3, 9, 2)
    assert fill_masked(x, got).sum().item() == 2 * lens.sum()


@pytest.mark.parametrize("n,d", [(48, 256), (1024, 256), (7, 10)])
def test_position_encoding_matches_jax(n, d):
    np.testing.assert_array_equal(sinusoid_position_encoding(n, d).numpy(),
                                  np.asarray(jax_pe(n, d)))


@pytest.mark.parametrize("max_mel_len", [40, 16])
def test_length_regulator_matches_jax(max_mel_len):
    rng = np.random.RandomState(3)
    x = rng.randn(3, 8, 5).astype(np.float32)
    dur = rng.randint(0, 5, size=(3, 8)).astype(np.int32)
    dur[1, 5:] = 0
    ref_out, ref_len = jax_length_regulate(jnp.asarray(x), jnp.asarray(dur),
                                           max_mel_len)
    out, mel_len = length_regulate(torch.from_numpy(x),
                                   torch.from_numpy(dur), max_mel_len)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
    np.testing.assert_array_equal(mel_len.numpy(), np.asarray(ref_len))
