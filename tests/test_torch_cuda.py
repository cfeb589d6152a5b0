"""PyTorch port, CUDA kernels on the card: K1, K2, K3 and K4 against their
plain versions at the main path's shapes and at ragged L, their input
checks, K1's key-split grid at batch 1 and the row statistics it hands to
K3, K1, K2, K3 and K4 giving the same bits on a second launch, K4's two
routes and both tile widths, K2's tap splits, the FFN's weight pack
rebuilt after a weight change, the model's forward going through K1 and
K2, a training step going through K1 and K3, and the parity HiFi-GAN
going through K4.

Every test here is marked ``cuda`` and skips without a GPU.  The file
imports no JAX, so it also runs on a GPU host without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerance 1e-4 absolute in float32: the same sums in another order (up to
2304 terms for K2's first conv) on O(1) values; K4's outputs are held to
1e-4 of their largest |value| (sums of up to 2816 terms through six convs).

The bfloat16 instances of K1, K2 and K3 are held to 2 ulps of bfloat16 at
the largest |plain value|: kernel and plain version round at the same
points, and a float32 sum in another order may land on the other side of a
rounding boundary (one ulp; K1 also rounds its unnormalised P, the plain
version the normalised one).
"""

import numpy as np
import pytest
import torch

from fastspeech2_tpu_torch.configs.config import FastSpeech2Config
from fastspeech2_tpu_torch.models import transformer
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_tpu_torch.models.hifigan import HiFiGANGenerator, ResBlock
from fastspeech2_tpu_torch.ops import cuda_attention, cuda_ffn, cuda_resblock
from fastspeech2_tpu_torch.ops.attention import (
    multi_head_attention,
    plain_attention_backward,
)
from fastspeech2_tpu_torch.tools.kernel_bounds import parity_resblock_shapes

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    from fastspeech2_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


def _attention_inputs(lens, L, device, D=128, seed=0, H=2):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(len(lens), H, L, D, generator=g).to(device)
               for _ in range(3))
    mask = (torch.arange(L)[None, :] >= torch.tensor(lens)[:, None])
    return q, k, v, mask.to(device)


def _ffn_inputs(L, device, H=1024, k2=1, seed=0, B=1):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * scale + shift).to(device)

    return [r(B, L, 256), r(9, 256, H, scale=0.03), r(H, scale=0.1),
            r(k2, H, 256, scale=0.03), r(256, scale=0.1),
            r(256, scale=0.1, shift=1.0), r(256, scale=0.1)]


# encoder L = round_up(phones, 16); decoder L = 1000 or round_up(need, 512);
# ragged L against the 32-key and 64-row tiles; batch 1 at 1000 and 32 (the
# README sentence's shapes, where K1 splits the keys to fill the card);
# batch 10 at 1000, the training decoder's shape
TRAIN_LENS = [1000, 0, 731, 512, 999, 640, 877, 580, 950, 700]


@pytest.mark.parametrize("L,lens", [
    (32, [31, 0]), (48, [48, 33]), (1000, [1000, 253, 0]), (1536, [1100]),
    (1, [1, 0]), (63, [63, 40, 0]), (65, [65, 0]), (129, [129, 100, 0]),
    (1000, [253]), (32, [31]), (1000, TRAIN_LENS),
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


# the statistics K3 reads, on the single-launch and the key-split grids
@pytest.mark.parametrize("lens,L", [([1000, 253, 0], 1000), ([253], 1000),
                                    ([31], 32), ([100, 0], 129),
                                    (TRAIN_LENS, 1000)])
def test_attention_kernel_row_statistics(device, lens, L):
    q, k, v, mask = _attention_inputs(lens, L, device, seed=L + 2)
    out, row_max, row_sum = cuda_attention._launch_forward(q, k, v, mask,
                                                           True)
    torch.cuda.synchronize()
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / 128 ** 0.5
    s = s.masked_fill(mask[:, None, None, :], -1e9)
    ref_max = s.amax(-1)
    torch.testing.assert_close(row_max, ref_max, atol=1e-5, rtol=0)
    ref_sum = torch.exp(s - ref_max[..., None]).sum(-1)
    torch.testing.assert_close(row_sum, ref_sum, atol=0, rtol=1e-5)
    torch.testing.assert_close(out, multi_head_attention(q, k, v, mask),
                               atol=1e-4, rtol=0)


def test_attention_kernel_fills_the_card_at_batch_one(device):
    """At [1, 2, 1000, 128] the (query tile, b*h) grid is 32 blocks; K1
    splits the keys so that at least 128 blocks run.  The partials take
    chunks * B*H*L * (128 + 2) floats of scratch, none without a split."""
    for B, L in ((1, 1000), (1, 32), (10, 128), (10, 768), (10, 1000)):
        grid, scratch = cuda_attention.forward_plan(B, 2, L)
        assert grid[:2] == (-(-L // 64), B * 2), grid
        assert scratch == (0 if grid[2] == 1
                           else grid[2] * B * 2 * L * 130), (grid, scratch)
    grid, _ = cuda_attention.forward_plan(1, 2, 1000)
    assert grid[0] * grid[1] * grid[2] >= 128 and grid[2] > 1, grid


# two launches on the same inputs give the same bits (no atomics, a fixed
# order of every sum, the key-split combine included)
@pytest.mark.parametrize("lens,L", [([253], 1000), ([1000, 611, 0], 1000),
                                    ([31], 32)])
def test_attention_kernels_are_bitwise_repeatable(device, lens, L):
    q, k, v, mask = _attention_inputs(lens, L, device, seed=L + 3)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(L)).to(
        device)
    first = cuda_attention._launch_forward(q, k, v, mask, True)
    second = cuda_attention._launch_forward(q, k, v, mask, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    before = cuda_attention.bwd_launches
    grads = [cuda_attention.fused_attention_backward(q, k, v, mask, *first, g)
             for _ in range(2)]
    torch.cuda.synchronize()
    assert cuda_attention.bwd_launches == before + 2
    for a, b in zip(*grads):
        assert torch.equal(a, b)


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


# encoder L = 128 and decoder L = 1000 of the training slice's buckets, L
# ragged against the 64-row and 64-key tiles, each with partly and fully
# padded batch rows; batch 1 at 1000 (K1 on its key-split grid)
@pytest.mark.parametrize("L,lens", [
    (128, [128, 70, 0]), (1000, [1000, 611, 0]), (77, [77, 40, 0]),
    (1, [1, 0]), (63, [63, 0]), (65, [65, 30, 0]), (129, [129, 0]),
    (1000, [700]),
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


# tensor parallel over 2 ranks: one head per rank, the training shapes
@pytest.mark.parametrize("L", [128, 768, 1000])
@pytest.mark.parametrize("B", [5, 10])
def test_attention_kernels_at_one_head(device, L, B):
    lens = (TRAIN_LENS if L == 1000 else [L, 0] + [L // 2 + 7 * i
                                                   for i in range(8)])[:B]
    q, k, v, mask = _attention_inputs(lens, L, device, seed=L + B, H=1)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(B)).to(
        device)
    before = (cuda_attention.launches, cuda_attention.bwd_launches)
    out, row_max, row_sum = cuda_attention._launch_forward(q, k, v, mask,
                                                           True)
    got = cuda_attention.fused_attention_backward(q, k, v, mask, out,
                                                  row_max, row_sum, g)
    torch.cuda.synchronize()
    assert (cuda_attention.launches, cuda_attention.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, multi_head_attention(q, k, v, mask),
                               atol=1e-4, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), got,
                          plain_attention_backward(q, k, v, mask, g)):
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


def _resblock_inputs(C, k, L, device, B=1, bias=0.5, seed=0):
    """x [B, C, L] and three dilation units of Conv1d weights scaled to keep
    the output O(1); biases of size ``bias`` show a leak at the edges."""
    g = torch.Generator().manual_seed(seed)
    scale = (C * k) ** -0.5

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(device)

    x = r(B, C, L)
    w1, w2 = ([r(C, C, k, s=scale) for _ in range(3)] for _ in range(2))
    b1, b2 = ([r(C, s=bias) for _ in range(3)] for _ in range(2))
    return x, w1, b1, w2, b2


def _assert_resblock_close(got, ref):
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item(), err


# every (C, k) of the parity generator; L ragged against every tile size
@pytest.mark.parametrize("C", [256, 128, 64, 32])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_resblock_kernel_matches_plain(device, C, k):
    x, w1, b1, w2, b2 = _resblock_inputs(C, k, 1531, device, B=2, seed=C + k)
    before = cuda_resblock.launches
    got = cuda_resblock.fused_resblock(x, w1, b1, w2, b2, (1, 3, 5))
    torch.cuda.synchronize()
    assert cuda_resblock.launches == before + 1
    _assert_resblock_close(got, cuda_resblock.plain_resblock(
        x, w1, b1, w2, b2, (1, 3, 5)))


# L = 8: a 1-frame mel at C = 256, the halo (60 at k = 11) wider than L
@pytest.mark.parametrize("C,L", [(256, 8), (256, 1), (32, 37), (64, 300)])
def test_resblock_kernel_short_inputs(device, C, L):
    x, w1, b1, w2, b2 = _resblock_inputs(C, 11, L, device, seed=L)
    got = cuda_resblock.fused_resblock(x, w1, b1, w2, b2, (1, 3, 5))
    torch.cuda.synchronize()
    _assert_resblock_close(got, cuda_resblock.plain_resblock(
        x, w1, b1, w2, b2, (1, 3, 5)))


def test_resblock_kernel_edges_take_no_bias(device):
    """A zero input: the output near both edges comes from the biases
    through each conv's own zero padding only; a second conv that read
    lrelu(b1) outside [0, L) would differ here."""
    x, w1, b1, w2, b2 = _resblock_inputs(64, 11, 700, device, bias=2.0)
    x = torch.zeros_like(x)
    got = cuda_resblock.fused_resblock(x, w1, b1, w2, b2, (1, 3, 5))
    torch.cuda.synchronize()
    ref = cuda_resblock.plain_resblock(x, w1, b1, w2, b2, (1, 3, 5))
    assert (ref[..., :60] - ref[..., 300:360]).abs().max() > 1e-2
    _assert_resblock_close(got, ref)


def test_resblock_kernel_raises_on_what_it_does_not_take(device):
    x, w1, b1, w2, b2 = _resblock_inputs(64, 3, 40, device)
    with pytest.raises(ValueError, match="float32"):
        cuda_resblock.fused_resblock(x.half(), w1, b1, w2, b2, (1, 3, 5))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_resblock.fused_resblock(x.transpose(1, 2).contiguous()
                                     .transpose(1, 2), w1, b1, w2, b2,
                                     (1, 3, 5))
    packed = cuda_resblock.pack_resblock_weights(
        *([t.cpu() for t in ts] for ts in (w1, b1, w2, b2)))
    with pytest.raises(ValueError, match="w1 must be float32 on cuda"):
        cuda_resblock.fused_resblock(x, w1, b1, w2, b2, (1, 3, 5),
                                     packed=packed)
    x, w1, b1, w2, b2 = _resblock_inputs(48, 3, 40, device)
    with pytest.raises(ValueError, match="multiple of 64"):
        cuda_resblock.fused_resblock(x, w1, b1, w2, b2, (1, 3, 5))
    x, w1, b1, w2, b2 = _resblock_inputs(32, 5, 40, device)
    with pytest.raises(ValueError, match="k in"):
        cuda_resblock.fused_resblock(x, w1, b1, w2, b2, (1, 3, 5))


def test_resblock_kernel_refuses_a_gradient(device):
    x, w1, b1, w2, b2 = _resblock_inputs(32, 7, 300, device, seed=3)
    w1[0].requires_grad_(True)
    before = cuda_resblock.launches
    with pytest.raises(RuntimeError, match="inference-only"):
        cuda_resblock.fused_resblock(x, w1, b1, w2, b2, (1, 3, 5))
    with torch.no_grad():
        cuda_resblock.fused_resblock(x, w1, b1, w2, b2, (1, 3, 5))
    assert cuda_resblock.launches == before + 1


def test_parity_generator_goes_through_k4(device):
    torch.manual_seed(0)
    gen = HiFiGANGenerator().to(device).eval()
    mel = torch.randn(2, 16, 80, generator=torch.Generator().manual_seed(1)
                      ).to(device)
    cuda_resblock.launches = 0
    with torch.inference_mode():
        wav = gen(mel)
    assert cuda_resblock.launches == 12
    assert wav.shape == (2, 16 * 256) and torch.isfinite(wav).all()
    for m in gen.modules():
        if isinstance(m, ResBlock):
            m.fused = False
    with torch.inference_mode():
        ref = gen(mel)
    assert cuda_resblock.launches == 12
    torch.testing.assert_close(wav, ref, atol=1e-4, rtol=0)


# K2 at every shape the paths give it: the README sentence's encoder (32)
# and decoder (1000), the re-dispatch bucket (1536), one frame, and the
# validation forward's batch of 10; two launches must agree bit for bit
@pytest.mark.parametrize("B", [1, 10])
@pytest.mark.parametrize("L", [1, 32, 1000, 1536])
@pytest.mark.parametrize("k2", [1, 3])
def test_conv_ffn_kernel_at_the_path_shapes(device, B, L, k2):
    args = _ffn_inputs(L, device, k2=k2, seed=L + k2 + B, B=B)
    got = cuda_ffn.fused_conv_ffn(*args)
    again = cuda_ffn.fused_conv_ffn(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, cuda_ffn.plain_conv_ffn(*args),
                               atol=1e-4, rtol=0)


# every tile width of the first conv with tap splits that leave one, two,
# three and nine taps per block (9 = 3 + 3 + 3, 5 + 4, ...), and the second
# conv's hidden channels in 1, 4 and 16 groups
@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("groups", [1, 4, 16])
def test_conv_ffn_kernel_every_plan(device, bn, splits, groups):
    args = _ffn_inputs(100, device, k2=3, seed=bn + splits + groups)
    packed = cuda_ffn.pack_ffn_weights(args[1], args[3])
    got = cuda_ffn._launch(*args, packed=packed, plan=(bn, splits, groups))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, cuda_ffn.plain_conv_ffn(*args),
                               atol=1e-4, rtol=0)


def test_ffn_weight_pack_is_rebuilt_after_a_weight_change(device):
    torch.manual_seed(0)
    ffn = transformer.PositionwiseFeedForward(256, 1024, (9, 1), 0.1)
    ffn = ffn.to(device).eval()
    x = torch.randn(1, 50, 256, generator=torch.Generator().manual_seed(1)
                    ).to(device)
    with torch.inference_mode():
        ffn(x)
        first = ffn._pack
        ffn(x)
        assert ffn._pack is first
    with torch.no_grad():
        ffn.w_1.weight.mul_(0.5)
    with torch.inference_mode():
        got = ffn(x)
    assert ffn._pack is not first
    ref = cuda_ffn.plain_conv_ffn(
        x, ffn.w_1.weight.permute(2, 1, 0), ffn.w_1.bias,
        ffn.w_2.weight.permute(2, 1, 0), ffn.w_2.bias,
        ffn.layer_norm.weight, ffn.layer_norm.bias)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


# K4 at the 12 ResBlock shapes of a 1000-frame parity-vocoder forward
@pytest.mark.parametrize("C,L,k", parity_resblock_shapes(1000))
def test_resblock_kernel_at_the_parity_path_shapes(device, C, L, k):
    x, w1, b1, w2, b2 = _resblock_inputs(C, k, L, device, seed=C + k)
    with torch.inference_mode():
        got = cuda_resblock.fused_resblock(x, w1, b1, w2, b2, (1, 3, 5))
        ref = cuda_resblock.plain_resblock(x, w1, b1, w2, b2, (1, 3, 5))
    _assert_resblock_close(got, ref)


# both routes and every tile width the unit kernel has (the conv kernel
# has one), L at one position, below the halo (60 at k = 11), and at the
# 64- and 128-position tiles +- 1
@pytest.mark.parametrize("how,C,tile", [
    ("unit", 32, 64), ("unit", 32, 128), ("unit", 64, 64), ("unit", 64, 128),
    ("unit", 128, 64), ("conv", 64, 0), ("conv", 128, 0), ("conv", 256, 0)])
@pytest.mark.parametrize("L,k", [(1, 11), (9, 3), (40, 11), (63, 7),
                                 (65, 11), (127, 3), (129, 11)])
def test_resblock_routes_and_tiles(device, how, C, tile, L, k):
    x, w1, b1, w2, b2 = _resblock_inputs(C, k, L, device, B=2,
                                         seed=C + L + k)
    packed = cuda_resblock.pack_resblock_weights(w1, b1, w2, b2)
    with torch.inference_mode():
        got = cuda_resblock._launch(x, packed, (1, 3, 5), how=how, tile=tile)
        ref = cuda_resblock.plain_resblock(x, w1, b1, w2, b2, (1, 3, 5))
    _assert_resblock_close(got, ref)


# one unit of k = 11 dilated by 5: the widest halo of the path (50)
@pytest.mark.parametrize("how,C", [("unit", 64), ("conv", 128)])
def test_resblock_kernel_k11_d5(device, how, C):
    x, w1, b1, w2, b2 = _resblock_inputs(C, 11, 777, device, bias=2.0)
    w1, b1, w2, b2 = w1[:1], b1[:1], w2[:1], b2[:1]
    packed = cuda_resblock.pack_resblock_weights(w1, b1, w2, b2)
    with torch.inference_mode():
        got = cuda_resblock._launch(x, packed, (5,), how=how)
        ref = cuda_resblock.plain_resblock(x, w1, b1, w2, b2, (5,))
    _assert_resblock_close(got, ref)


@pytest.mark.parametrize("C,L,k", [(32, 4097, 7), (64, 3000, 11),
                                   (128, 2000, 3), (256, 1531, 11)])
def test_resblock_kernel_is_bitwise_repeatable(device, C, L, k):
    x, w1, b1, w2, b2 = _resblock_inputs(C, k, L, device, seed=k)
    with torch.inference_mode():
        got = [cuda_resblock.fused_resblock(x, w1, b1, w2, b2, (1, 3, 5))
               for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*got)


# ---- the bfloat16 instances --------------------------------------------------

def _assert_bf16_close(got, ref, ulps=2):
    assert got.dtype == ref.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    unit = 2.0 ** (torch.floor(torch.log2(ref.float().abs().max())).item()
                   - 7)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= ulps * unit, (err, unit)


@pytest.mark.parametrize("L,lens", [
    (32, [31, 0]), (1000, [253]), (1000, TRAIN_LENS), (128, [128, 70, 0]),
    (768, [768, 0, 500]), (63, [63, 40, 0]), (1, [1, 0]),
])
def test_attention_kernels_bf16_match_plain(device, L, lens):
    q, k, v, mask = (t.to(torch.bfloat16) if t.is_floating_point() else t
                     for t in _attention_inputs(lens, L, device, seed=L))
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(L)).to(
        device).to(torch.bfloat16)
    before = (cuda_attention.launches, cuda_attention.launches_bf16,
              cuda_attention.bwd_launches, cuda_attention.bwd_launches_bf16)
    out, row_max, row_sum = cuda_attention._launch_forward(q, k, v, mask,
                                                           True)
    again = cuda_attention.fused_attention(q, k, v, mask)
    grads = [cuda_attention.fused_attention_backward(
        q, k, v, mask, out, row_max, row_sum, g) for _ in range(2)]
    torch.cuda.synchronize()
    assert (cuda_attention.launches, cuda_attention.launches_bf16,
            cuda_attention.bwd_launches,
            cuda_attention.bwd_launches_bf16) == (
        before[0], before[1] + 2, before[2], before[3] + 2)
    assert torch.equal(out, again)
    _assert_bf16_close(out, multi_head_attention(q, k, v, mask))
    for a, b, c in zip(*grads, plain_attention_backward(q, k, v, mask, g)):
        assert torch.equal(a, b)
        _assert_bf16_close(a, c)


@pytest.mark.parametrize("B,L,k2", [(1, 1000, 1), (1, 32, 1), (1, 48, 3),
                                    (10, 128, 1), (10, 1000, 1), (1, 1, 1)])
def test_conv_ffn_kernel_bf16_matches_plain(device, B, L, k2):
    args = _ffn_inputs(L, device, k2=k2, seed=L, B=B)
    args[0] = args[0].to(torch.bfloat16)
    before = (cuda_ffn.launches, cuda_ffn.launches_bf16)
    got = cuda_ffn.fused_conv_ffn(*args)
    again = cuda_ffn.fused_conv_ffn(*args)
    torch.cuda.synchronize()
    assert (cuda_ffn.launches, cuda_ffn.launches_bf16) == (before[0],
                                                           before[1] + 2)
    assert torch.equal(got, again)
    _assert_bf16_close(got, cuda_ffn.plain_conv_ffn(*args))


def test_model_bf16_goes_through_the_bf16_kernels(device):
    """A bfloat16 model's forward launches the bfloat16 K1 and K2 only, and
    a training step the bfloat16 K1 and K3; the weight pack follows the
    dtype."""
    from fastspeech2_tpu_torch.configs.config import OptimConfig
    from fastspeech2_tpu_torch.training.optim import NoamAdam
    from fastspeech2_tpu_torch.training.step import train_step

    cfg = FastSpeech2Config(encoder_layer=1, decoder_layer=2, max_seq_len=128,
                            n_mel_channels=16)
    torch.manual_seed(0)
    model = FastSpeech2(cfg, dtype=torch.bfloat16).to(device).eval()
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
    cuda_attention.launches = cuda_attention.launches_bf16 = 0
    cuda_ffn.launches = cuda_ffn.launches_bf16 = 0
    with torch.inference_mode():
        out = model(batch["speakers"], batch["texts"], batch["src_lens"],
                    max_mel_len=128)
    assert out.postnet_mel.dtype == torch.bfloat16
    assert (cuda_attention.launches, cuda_attention.launches_bf16,
            cuda_ffn.launches, cuda_ffn.launches_bf16) == (0, 3, 0, 3)
    model.train()
    opt = NoamAdam(model.parameters(), OptimConfig(batch_size=2),
                   cfg.encoder_hidden)
    cuda_attention.launches_bf16 = cuda_attention.bwd_launches_bf16 = 0
    cuda_attention.bwd_launches = 0
    losses = train_step(model, opt, batch, 0)
    torch.cuda.synchronize()
    assert (cuda_attention.launches_bf16, cuda_attention.bwd_launches_bf16,
            cuda_attention.bwd_launches) == (3, 3, 0)
    assert all(torch.isfinite(v) for v in losses)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _tiny_fused_synthesizer(device):
    """A small acoustic model and iSTFT generator behind a Synthesizer on
    the card, and two phone-ID rows (20 and 9 phones)."""
    from fastspeech2_tpu_torch.synthesis.pipeline import Synthesizer
    from fastspeech2_tpu_torch.synthesis.vocoder import build_generator

    cfg = FastSpeech2Config(encoder_layer=1, decoder_layer=2,
                            max_seq_len=128)
    torch.manual_seed(0)
    model = FastSpeech2(cfg).to(device).eval()
    with torch.no_grad():
        model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(1.2)
    gen = build_generator({"upsample_rates": [8, 4],
                           "upsample_kernel_sizes": [16, 8],
                           "upsample_initial_channel": 128,
                           "resblock_kernel_sizes": [3],
                           "resblock_dilation_sizes": [[1, 3]],
                           "gen_istft_n_fft": 16, "gen_istft_hop_size": 8})
    pre = {"preprocessing": {"audio": {"max_wav_value": 32768.0},
                             "stft": {"hop_length": 256}}}
    syn = Synthesizer(model, cfg, pre, device, vocoder=gen.to(device).eval())
    g = torch.Generator().manual_seed(3)
    ids = [torch.randint(1, 300, (n,), generator=g).numpy() for n in (20, 9)]
    return syn, ids


def test_fused_dispatch_graph_replays_the_eager_dispatch(device):
    """The fused text->wav dispatch on the card: a shape without a graph
    is dispatched eagerly and makes none; warm_shape captures one (a
    warm-up run and the capture count their launches); a dispatch then
    replays it, and a replay gives the eager dispatch's outputs bit for bit
    at any control value; the replays are counted."""
    from fastspeech2_tpu_torch.synthesis.graphs import kernel_counts

    syn, ids = _tiny_fused_synthesizer(device)
    graphs = syn.graphs
    before = kernel_counts()
    wavs_e, _ = syn.synthesize_ids(ids)
    after = kernel_counts()
    assert not graphs.graphs and not syn._warm
    assert {k: after[k] - before[k] for k in after} == {
        "K1": 3, "K1_bf16": 0, "K2": 3, "K2_bf16": 0, "K4": 2}
    syn.warm_shape(2, 20)
    assert sorted(graphs.graphs) == [(2, 32)] and syn._warm == {(2, 32)}
    captured = graphs.graphs[(2, 32)].launches
    assert captured == {k: after[k] - before[k] for k in after}
    assert graphs.setup_launches == {k: 2 * v for k, v in captured.items()}
    wavs, out = syn.synthesize_ids(ids)
    assert graphs.replays() == 1 and kernel_counts() == dict(
        (k, after[k] + 2 * captured[k]) for k in after)
    assert [len(w) for w in wavs] == [int(m) * 256 for m in out.mel_len]
    assert all(np.array_equal(a, b) for a, b in zip(wavs, wavs_e))
    packed = syn._pack_batch(ids, None)
    for controls in ((1.0, 1.0, 1.0, 0.0, 0.0), (1.2, 0.8, 1.3, 0.1, -0.1)):
        wav_g, out_g = graphs.run(*packed, controls)
        wav_e, out_e = syn.fused_forward(*packed, controls)
        assert torch.equal(wav_g, wav_e)
        assert all(torch.equal(a, b) for a, b in zip(out_g, out_e))
    assert graphs.replays() == 3
    assert graphs.launches() == {k: 3 * v for k, v in captured.items()}
    assert graphs.pool_bytes() != 0
    # replays from several threads at once, each at its own duration
    # control: the lock keeps each one's inputs and outputs its own
    import threading

    ratios = [0.7 + 0.1 * i for i in range(8)]
    want = {r: syn.fused_forward(*packed, (1.0, 1.0, r, 0.0, 0.0))[0]
            for r in ratios}
    got = {}
    threads = [threading.Thread(target=lambda r=r: got.__setitem__(
        r, graphs.run(*packed, (1.0, 1.0, r, 0.0, 0.0))[0]))
        for r in ratios for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert all(torch.equal(got[r], want[r]) for r in ratios)


def test_graph_keeps_the_constants_it_reads(device):
    """A graph reads the cached position tables and iSTFT constants by
    address at every replay: after the caches drop them and their memory
    is handed out again (filled with NaN), a replay still gives the eager
    dispatch's outputs bit for bit."""
    from fastspeech2_tpu_torch.models import hifigan_istft
    from fastspeech2_tpu_torch.ops import positional

    syn, ids = _tiny_fused_synthesizer(device)
    packed = syn._pack_batch(ids, None)
    controls = (1.0, 1.0, 1.0, 0.0, 0.0)
    syn.graphs.capture(*packed)
    constants = syn.graphs.graphs[(2, 32)].constants
    sizes = [t.numel() for c in constants
             for t in (c if isinstance(c, tuple) else (c,))]
    assert len(sizes) >= 5   # two tables, C, S, the window, the wss
    wav_e, out_e = syn.fused_forward(*packed, controls)
    for cache in (positional._device_table, hifigan_istft._istft_constants,
                  hifigan_istft._window_sum_square):
        cache.cache_clear()
    del constants
    # the constants were made in the capture's warm-up run, on its side
    # stream, where the allocator hands their blocks out again
    junk = []
    for stream in (syn.graphs.stream, torch.cuda.current_stream(device)):
        with torch.cuda.stream(stream):
            junk += [torch.full((n,), float("nan"), device=device)
                     for n in sizes for _ in range(8)]
    wav_g, out_g = syn.graphs.run(*packed, controls)
    del junk
    assert torch.equal(wav_g, wav_e)
    assert all(torch.equal(a, b) for a, b in zip(out_g, out_e))
