"""K2: fused position-wise conv FFN, hand-written CUDA for Hopper on the
tensor cores (float32: ``csrc/conv_ffn_f32.cu``, 3xTF32 on ``wgmma``;
bfloat16: ``csrc/conv_ffn.cu``, bfloat16 ``wgmma``; both with the weights
fed by TMA), replacing the TPU
kernel ``fastspeech2_tpu/ops/pallas_ffn.py::_ffn_kernel``, with its plain
version.

Both compute LN(ReLU(conv1d_k1(x) + b1) -> conv1d_k2 + b2 + x) over
x [B, L, D] with w1 [k1, D, H] and w2 [k2, H, D] (the JAX package's
layouts), SAME zero padding at the sequence edges, and a LayerNorm whose
variance is E[y^2] - E[y]^2, eps 1e-5.

:func:`fused_conv_ffn` is the one entry point.  For tensors on the CPU it
computes the plain version; for CUDA tensors it launches the kernel or
raises.  There is no fallback from CUDA to the plain version.  When a
gradient is wanted it goes through :class:`FusedConvFFN`: K2 forward, and
a backward that recomputes the plain version from the saved inputs and
differentiates it, as the JAX package's custom VJP does with its XLA
reference (``fastspeech2_tpu/ops/pallas_ffn.py:194-204``).  Training mode
does not come here: the model's FFN runs its own plain path with dropout
there, as the JAX package does (``models/transformer.py:162-189``).

x's dtype picks the instance: float32, whose products run as 3xTF32
(within ~1e-5 of float32), or bfloat16 (the JAX package's --dtype
bfloat16), which computes what the TPU kernel computes on a bfloat16 x:
the weights rounded to bfloat16, float32 accumulation from float32 b1, h
rounded to bfloat16, b2, the residual and the LayerNorm in float32, the
output rounded to bfloat16.  The biases and the LayerNorm's parameters
stay float32.  Each instance counts its own launches.  The kernel reads
both convs' weights packed once (:func:`pack_ffn_weights`,
``ops/tf32_pack.py``): at float32 the big and small TF32 planes of each
(32-channel slice, tap) as swizzled rows, the ``wgmma`` B operand; at
bfloat16 the weights rounded to bfloat16, one swizzled plane of rows per
(64-channel slice, tap).  The model keeps that pack for
its no-grad forwards and rebuilds it only when a weight or the dtype
changes.  Without a pack, a call packs the weights it is given.
"""

import ctypes
import functools

import torch
from torch.nn import functional as F

from fastspeech2_tpu_torch.ops.cuda_build import check, load_library
from fastspeech2_tpu_torch.ops.tf32_pack import (
    SLICE,
    SLICE_BF16,
    pack_planes,
    pack_rows_bf16,
)

MODEL_DIM = 256

# fused_conv_ffn calls that launched the kernel since the count was last
# set to 0: float32 (two launches at the large shapes, the first conv and
# the second ending in the residual and LayerNorm; up to five at the small
# ones, csrc/conv_ffn_f32.cu), bfloat16 (two at the large shapes, up to
# four at the small ones, csrc/conv_ffn.cu)
launches = 0
launches_bf16 = 0


def conv1d_same(x, w):
    """x [B, L, C] (*) w [k, C, N] with SAME zero padding ((k-1)//2 before,
    k//2 after, as XLA's "SAME") -> [B, L, N]."""
    k = w.shape[0]
    lo = (k - 1) // 2
    xt = F.pad(x.transpose(1, 2), (lo, k - 1 - lo))
    return F.conv1d(xt, w.permute(2, 1, 0)).transpose(1, 2)


def pack_ffn_weights(w1, w2, dtype=torch.float32):
    """w1 [k1, D, H], w2 [k2, H, D] (JAX layouts, any strides) -> what K2's
    ``dtype`` instance reads: float32 (:func:`pack_planes`: w1p [D/32, k1,
    2, H, 32], w2p [H/32, k2, 2, D, 32]) or bfloat16
    (:func:`pack_rows_bf16`: w1p [D/64, k1, H, 64], w2p [H/64, k2, D,
    64])."""
    pack = pack_rows_bf16 if dtype == torch.bfloat16 else pack_planes
    return (pack(w1.detach().permute(0, 2, 1)),
            pack(w2.detach().permute(0, 2, 1)))


@functools.lru_cache(maxsize=256)
def forward_plan(B, L, H, k1, k2=1, dtype=torch.float32):
    """The kernel's own plan at ``dtype`` (``fs2_conv_ffn_f32_plan``,
    ``fs2_conv_ffn_plan``): the first conv's tap splits and the second
    conv's hidden groups."""
    lib = load_library()
    cfg = (ctypes.c_int * 2)()
    plan = (lib.fs2_conv_ffn_plan if dtype == torch.bfloat16
            else lib.fs2_conv_ffn_f32_plan)
    plan(B, L, H, k1, k2, cfg)
    return tuple(cfg)


def plain_conv_ffn(x, w1, b1, w2, b2, ln_scale, ln_bias, packed=None):
    """Plain PyTorch version (``xla_conv_ffn``,
    fastspeech2_tpu/ops/pallas_ffn.py:41-58) at x's dtype: the convs in
    float32 from their operands at x's dtype (a bfloat16 product is exact
    in float32), h rounded to x's dtype, the output too.  ``packed`` is
    ignored (it reads w1 and w2), so that this function can stand in for
    :func:`fused_conv_ffn`."""
    dt = x.dtype

    def up(w):   # w at x's dtype, in float32
        return w.to(dt).float()

    h = torch.relu(conv1d_same(x.float(), up(w1)) + b1.float()).to(dt)
    return residual_layer_norm(conv1d_same(h.float(), up(w2)) + b2.float(),
                               x, ln_scale, ln_bias)


def residual_layer_norm(y, x, ln_scale, ln_bias):
    """LN(y + x) over the last axis, in float32 as K2 forms it (the
    variance E[z^2] - E[z]^2, eps 1e-5), rounded to x's dtype."""
    z = y.float() + x.float()
    mu = z.mean(dim=-1, keepdim=True)
    var = (z * z).mean(dim=-1, keepdim=True) - mu * mu
    return ((z - mu) * torch.rsqrt(var + 1e-5) * ln_scale
            + ln_bias).to(x.dtype)


class FusedConvFFN(torch.autograd.Function):
    """K2 forward; backward by autograd through :func:`plain_conv_ffn`
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _launch(*args, packed=pack_ffn_weights(args[1], args[3],
                                                      args[0].dtype))

    @staticmethod
    def backward(ctx, g):
        args = [t.detach().requires_grad_(need)
                for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = plain_conv_ffn(*args)
        wanted = [t for t in args if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in args)


def fused_conv_ffn(x, w1, b1, w2, b2, ln_scale, ln_bias, packed=None):
    """x: float32 or bfloat16 [B, L, 256]; the rest float32: w1 [k1, 256,
    H]; b1 [H]; w2 [k2, H, 256]; b2, ln_scale, ln_bias [256]; H a multiple
    of 128 (of 256 at bfloat16); ``packed``: the weights' :func:`pack_ffn_weights` at x's dtype,
    made here when not given (and on the gradient path, from the saved
    weights).  The output has x's dtype."""
    args = (x, w1, b1, w2, b2, ln_scale, ln_bias)
    if x.device.type == "cpu":
        return plain_conv_ffn(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedConvFFN.apply(*args)
    if packed is None:
        packed = pack_ffn_weights(w1, w2, x.dtype)
    return _launch(*args, packed=packed)


def _launch(x, w1, b1, w2, b2, ln_scale, ln_bias, packed, plan=None):
    """``plan``: the kernel's plan for measurement, (tap splits, hidden
    groups); the kernel's own :func:`forward_plan` by default."""
    global launches, launches_bf16
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_ffn: unsupported device {x.device}")
    if x.dim() != 3 or w1.dim() != 3 or w2.dim() != 3:
        raise ValueError("fused_conv_ffn: x, w1, w2 must be 3-D")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_conv_ffn: x must be float32 or bfloat16, "
                         f"got {x.dtype}")
    bf16 = x.dtype == torch.bfloat16
    B, L, D = x.shape
    k1, _, H = w1.shape
    k2 = w2.shape[0]
    if H % (256 if bf16 else 128) != 0:
        raise ValueError(f"fused_conv_ffn: hidden width {H} is not a "
                         f"multiple of {256 if bf16 else 128}")
    w1p, w2p = packed
    if bf16:
        w1_shape = (D // SLICE_BF16, k1, H, SLICE_BF16)
        w2_shape = (H // SLICE_BF16, k2, D, SLICE_BF16)
    else:
        w1_shape = (D // SLICE, k1, 2, H, SLICE)
        w2_shape = (H // SLICE, k2, 2, D, SLICE)
    f32 = torch.float32
    shapes = {"x": (x, (B, L, MODEL_DIM), x.dtype),
              "w1": (w1p, w1_shape, x.dtype), "b1": (b1, (H,), f32),
              "w2": (w2p, w2_shape, x.dtype),
              "b2": (b2, (D,), f32), "ln_scale": (ln_scale, (D,), f32),
              "ln_bias": (ln_bias, (D,), f32)}
    for name, (t, shape, dtype) in shapes.items():
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"fused_conv_ffn: {name} must be {dtype} on "
                             f"{x.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"fused_conv_ffn: {name} must be contiguous "
                             f"{shape}, got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_conv_ffn: {name} is not 16-byte "
                             "aligned (the kernel loads 16 bytes at once)")
    lib = load_library()
    plan = plan or forward_plan(B, L, H, k1, k2, x.dtype)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x.data_ptr(), w1p.data_ptr(), b1.data_ptr(), w2p.data_ptr(),
                b2.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr())
        splits, groups = plan
        if bf16:
            # h (bfloat16), then (splits > 1) the first conv's partial sums,
            # then (groups > 1) the second conv's shares
            scratch = torch.empty(
                (H // 2 + (splits * H if splits > 1 else 0)
                 + (groups * D if groups > 1 else 0)) * B * L,
                device=x.device, dtype=torch.float32)
            name = "fs2_conv_ffn_fwd_bf16"
            err = lib.fs2_conv_ffn_fwd_bf16(
                *args, scratch.data_ptr(), out.data_ptr(), B, L, D, H, k1,
                k2, splits, groups, stream)
        else:
            # the first conv's partial sums, then (groups > 1) the second
            # conv's shares
            scratch = torch.empty(
                (splits * H + (groups * D if groups > 1 else 0)) * B * L,
                device=x.device, dtype=torch.float32)
            name = "fs2_conv_ffn_fwd_f32"
            err = lib.fs2_conv_ffn_fwd_f32(
                *args, scratch.data_ptr(), out.data_ptr(), B, L, D, H, k1,
                k2, splits, groups, stream)
    check(err, name)
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out
