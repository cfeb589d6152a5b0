"""PyTorch port, CUDA kernels on the card: K1, K2 and K3 against their
plain versions at the main path's shapes, their input checks, the model's
forward going through K1 and K2, and a training step going through K1 and
K3.

Every test here is marked ``cuda`` and skips without a GPU.  The file
imports no JAX, so it also runs on a GPU host without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerance 1e-4 absolute in float32: the same sums in another order (up to
2304 terms for K2's first conv) on O(1) values.
"""

import pytest
import torch

from fastspeech2_tpu_torch.configs.config import FastSpeech2Config
from fastspeech2_tpu_torch.models import transformer
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_tpu_torch.ops import cuda_attention, cuda_ffn
from fastspeech2_tpu_torch.ops.attention import (
    multi_head_attention,
    plain_attention_backward,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    from fastspeech2_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


def _attention_inputs(lens, L, device, D=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(len(lens), 2, L, D, generator=g).to(device)
               for _ in range(3))
    mask = (torch.arange(L)[None, :] >= torch.tensor(lens)[:, None])
    return q, k, v, mask.to(device)


def _ffn_inputs(L, device, H=1024, k2=1, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * scale + shift).to(device)

    return [r(1, L, 256), r(9, 256, H, scale=0.03), r(H, scale=0.1),
            r(k2, H, 256, scale=0.03), r(256, scale=0.1),
            r(256, scale=0.1, shift=1.0), r(256, scale=0.1)]


# encoder L = round_up(phones, 16); decoder L = 1000 or round_up(need, 512)
@pytest.mark.parametrize("L,lens", [
    (32, [31, 0]), (48, [48, 33]), (1000, [1000, 253, 0]), (1536, [1100]),
])
def test_attention_kernel_matches_plain(device, L, lens):
    q, k, v, mask = _attention_inputs(lens, L, device, seed=L)
    before = cuda_attention.launches
    got = cuda_attention.fused_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert cuda_attention.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, multi_head_attention(q, k, v, mask),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("L,k2", [(1000, 1), (32, 1), (48, 3), (1536, 1)])
def test_conv_ffn_kernel_matches_plain(device, L, k2):
    args = _ffn_inputs(L, device, k2=k2, seed=L + k2)
    before = cuda_ffn.launches
    got = cuda_ffn.fused_conv_ffn(*args)
    torch.cuda.synchronize()
    assert cuda_ffn.launches == before + 1
    torch.testing.assert_close(got, cuda_ffn.plain_conv_ffn(*args),
                               atol=1e-4, rtol=0)


def test_kernels_raise_on_what_they_do_not_take(device):
    q, k, v, mask = _attention_inputs([20], 20, device)
    with pytest.raises(ValueError, match="float32"):
        cuda_attention.fused_attention(q.half(), k, v, mask)
    with pytest.raises(ValueError, match="head dim"):
        cuda_attention.fused_attention(*_attention_inputs([20], 20, device,
                                                          D=64))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_attention.fused_attention(q.transpose(2, 3).contiguous()
                                       .transpose(2, 3), k, v, mask)
    with pytest.raises(ValueError, match="key_pad_mask"):
        cuda_attention.fused_attention(q, k, v, mask.float())
    args = _ffn_inputs(16, device, H=96)
    with pytest.raises(ValueError, match="multiple of 64"):
        cuda_ffn.fused_conv_ffn(*args)
    args = _ffn_inputs(16, device)
    args[0] = args[0][:, :, :128].contiguous()
    with pytest.raises(ValueError, match="x must be"):
        cuda_ffn.fused_conv_ffn(*args)


# 160 frames > max_seq_len: the decoder cuts to 128 (training-time path)
@pytest.mark.parametrize("max_mel_len", [128, 160])
def test_model_forward_goes_through_both_kernels(device, max_mel_len):
    cfg = FastSpeech2Config(encoder_layer=1, decoder_layer=2,
                            max_seq_len=128)
    torch.manual_seed(0)
    model = FastSpeech2(cfg).to(device).eval()
    with torch.no_grad():
        # a few frames per phone
        model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(1.2)
    texts = torch.randint(1, 300, (2, 32), device=device)
    src_lens = torch.tensor([32, 20], device=device)
    speakers = torch.zeros(2, dtype=torch.long, device=device)
    cuda_attention.launches = cuda_ffn.launches = 0
    with torch.inference_mode():
        out = model(speakers, texts, src_lens, max_mel_len=max_mel_len)
    assert (cuda_attention.launches, cuda_ffn.launches) == (3, 3)
    saved = transformer.fused_attention, transformer.fused_conv_ffn
    transformer.fused_attention = multi_head_attention
    transformer.fused_conv_ffn = cuda_ffn.plain_conv_ffn
    try:
        with torch.inference_mode():
            ref = model(speakers, texts, src_lens, max_mel_len=max_mel_len)
    finally:
        transformer.fused_attention, transformer.fused_conv_ffn = saved
    assert torch.equal(out.duration_rounded, ref.duration_rounded)
    assert int(out.mel_len.min()) > 0
    assert out.postnet_mel.shape == (2, 128, cfg.n_mel_channels)
    torch.testing.assert_close(out.postnet_mel, ref.postnet_mel, atol=1e-3,
                               rtol=0)


# encoder L = 128 and decoder L = 1000 of the training slice's buckets, an
# L with a ragged edge, each with partly and fully padded batch rows
@pytest.mark.parametrize("L,lens", [
    (128, [128, 70, 0]), (1000, [1000, 611, 0]), (77, [77, 40, 0]),
])
def test_attention_backward_kernel_matches_plain(device, L, lens):
    q, k, v, mask = _attention_inputs(lens, L, device, seed=L + 1)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(L)).to(
        device)
    out, row_max, row_sum = cuda_attention._launch_forward(q, k, v, mask,
                                                           True)
    before = cuda_attention.bwd_launches
    got = cuda_attention.fused_attention_backward(q, k, v, mask, out,
                                                  row_max, row_sum, g)
    torch.cuda.synchronize()
    assert cuda_attention.bwd_launches == before + 1
    ref = plain_attention_backward(q, k, v, mask, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0, msg=name)


def test_attention_function_grads_match_autograd(device):
    """Batch rows with a key to attend to match autograd through the plain
    forward.  A batch row whose keys are ALL padded has the uniform
    P = 1/L: there the TPU kernel's formula (which K3 computes) gives dq
    and dk that are not 0, while autograd through the masked fill gives 0,
    so that row is held against the formula instead."""
    q, k, v, mask = _attention_inputs([96, 50, 0], 96, device, seed=5)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(6)).to(
        device)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = cuda_attention.fused_attention(*leaves, mask)
    # a strided incoming gradient: the backward makes it contiguous
    strided = g.transpose(1, 2).contiguous().transpose(1, 2)
    got = torch.autograd.grad(out, leaves, strided)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(multi_head_attention(*ref_leaves, mask),
                              ref_leaves, g)
    formula = plain_attention_backward(q, k, v, mask, g)
    for a, b, c in zip(got, ref, formula):
        torch.testing.assert_close(a[:2], b[:2], atol=1e-4, rtol=0)
        torch.testing.assert_close(a[2:], c[2:], atol=1e-4, rtol=0)


def test_conv_ffn_function_grads_match_autograd(device):
    args = _ffn_inputs(40, device, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in args]
    ref_leaves = [t.clone().requires_grad_(True) for t in args]
    g = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(4)
                    ).to(device)
    before = cuda_ffn.launches
    got = torch.autograd.grad(cuda_ffn.fused_conv_ffn(*leaves), leaves, g)
    assert cuda_ffn.launches == before + 1
    ref = torch.autograd.grad(cuda_ffn.plain_conv_ffn(*ref_leaves),
                              ref_leaves, g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_train_step_goes_through_k1_and_k3(device):
    from fastspeech2_tpu_torch.configs.config import OptimConfig
    from fastspeech2_tpu_torch.training.optim import NoamAdam
    from fastspeech2_tpu_torch.training.step import train_step

    cfg = FastSpeech2Config(encoder_layer=1, decoder_layer=2, max_seq_len=128,
                            n_mel_channels=16)
    torch.manual_seed(0)
    model = FastSpeech2(cfg).to(device).train()
    opt = NoamAdam(model.parameters(), OptimConfig(batch_size=2),
                   cfg.encoder_hidden)
    B, P, T = 2, 16, 96
    durations = torch.tensor([[6] * 16, [5] * 12 + [0] * 4])
    batch = {
        "speakers": torch.zeros(B, dtype=torch.long),
        "texts": torch.randint(1, 300, (B, P)) * (durations > 0),
        "src_lens": torch.tensor([16, 12]),
        "mels": torch.randn(B, T, 16),
        "mel_lens": durations.sum(1),
        "pitches": torch.rand(B, P),
        "energies": torch.rand(B, P),
        "durations": durations,
    }
    batch = {k: v.to(device) for k, v in batch.items()}
    cuda_attention.launches = cuda_attention.bwd_launches = 0
    cuda_ffn.launches = 0
    losses = train_step(model, opt, batch, 0)
    torch.cuda.synchronize()
    assert (cuda_attention.launches, cuda_attention.bwd_launches,
            cuda_ffn.launches) == (3, 3, 0)
    assert all(torch.isfinite(v) for v in losses)
