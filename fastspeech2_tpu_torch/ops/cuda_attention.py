"""K1 and K3: fused masked self-attention forward and backward,
hand-written CUDA for Hopper, on wgmma and TMA at both dtypes (K1:
``csrc/attention.cu``, float32 as 3xTF32, and ``csrc/attention_bf16.cu``;
K3, recomputing K1's scores bit for bit: ``csrc/attention_bwd.cu``, float32
as 3xTF32, and ``csrc/attention_bwd_bf16.cu``), replacing
the TPU kernels
``fastspeech2_tpu/ops/pallas_attention.py::_mha_kernel`` and
``::_mha_bwd_kernel`` (the ``fused_multi_head_attention`` custom VJP).

:func:`fused_attention` is the one entry point.  For CUDA tensors it
launches K1, and when a gradient is wanted it goes through
:class:`FusedAttention`, whose backward launches K3; a shape or dtype
either kernel does not take raises.  There is no fallback from CUDA to the
plain version.  For tensors on the CPU the same two steps compute the
plain versions (``ops/attention.py``): the forward, and the TPU kernel's
backward formula.

Each kernel has a float32 and a bfloat16 instance (the JAX package's
--dtype bfloat16), chosen by the tensors' dtype; q, k and v share it.
Each instance counts its own launches.  Inside a CUDA graph's capture a
launch is counted once, when it is recorded: the graph's owner counts its
replays (``synthesis/graphs.py``, ``training/step.py``).  Both kernels
launch on the current stream and take their scratch from PyTorch's
allocator, so a capture records them on its stream, with the scratch in
the graph's pool.

The forward's host path is kept short for the small shapes, where it
costs more than the kernel: the input checks run as one condition (the
messages are built only when it fails), the device context is entered
only when the tensors are not on the current card, and the stream comes
from the raw accessor (``torch.cuda.current_stream()`` builds a Stream
object: several microseconds a call).  A launch is at least three tensor
allocations (out and the two row statistics) and a ctypes call; one
allocation for both statistics would need views, which cost more.
"""

import contextlib
import ctypes
import functools
import math

import torch

from fastspeech2_tpu_torch.ops.attention import (
    multi_head_attention,
    plain_attention_backward,
)
from fastspeech2_tpu_torch.ops.cuda_build import check, load_library

HEAD_DIM = 128
SCALE = 1.0 / math.sqrt(HEAD_DIM)   # ctypes rounds it to float, as JAX does

# K1 calls (one launch, or two on the key-split path) and K3 calls (two
# launches each) since the counts were last set to 0: float32, bfloat16
launches = 0
bwd_launches = 0
launches_bf16 = 0
bwd_launches_bf16 = 0

DTYPES = (torch.float32, torch.bfloat16)


def _check_inputs(name, q, k, v, key_pad_mask):
    shape, dt = q.shape, q.dtype
    if (q.is_cuda and len(shape) == 4 and shape[3] == HEAD_DIM
            and dt in DTYPES and k.shape == shape and v.shape == shape
            and k.dtype == dt and v.dtype == dt):
        dev = q.device
        if (k.device == dev and v.device == dev and q.is_contiguous()
                and k.is_contiguous() and v.is_contiguous()
                and (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0
                and key_pad_mask.dtype == torch.bool
                and key_pad_mask.device == dev
                and key_pad_mask.shape == (shape[0], shape[2])
                and key_pad_mask.is_contiguous()):
            return
    _explain_inputs(name, q, k, v, key_pad_mask)


def _explain_inputs(name, q, k, v, key_pad_mask):
    """Raises with the first thing the kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, H, L, Dh], got "
                         f"{tuple(q.shape)}")
    B, H, L, D = q.shape
    if q.dtype not in DTYPES:
        raise ValueError(f"{name}: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {arg} must be {q.dtype} on "
                             f"{q.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != (B, H, L, D) or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous "
                             f"{(B, H, L, D)}, got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned (the "
                             "kernel loads float4)")
    if D != HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} is not {HEAD_DIM}")
    if (key_pad_mask.dtype != torch.bool or key_pad_mask.device != q.device
            or tuple(key_pad_mask.shape) != (B, L)
            or not key_pad_mask.is_contiguous()):
        raise ValueError(f"{name}: key_pad_mask must be a contiguous bool "
                         f"[{B}, {L}] tensor on {q.device}")
    raise ValueError(f"{name}: inputs the kernels do not take")


@functools.lru_cache(maxsize=None)
def _plan(device_index, B, H, L, bf16, stats):
    grid = (ctypes.c_int * 3)()
    n = load_library().fs2_mha_fwd_plan(B, H, L, int(bf16), int(stats),
                                        grid)
    if n < 0:
        raise ValueError(f"fs2_mha_fwd_plan: bad shape {(B, H, L)}")
    return tuple(grid), n


def forward_plan(B, H, L, dtype=torch.float32, stats=False):
    """K1's grid on the current card for [B, H, L, 128] at ``dtype`` (each
    instance has its own tiles and plan), with the row statistics (the
    training path: at float32 its key chunks depend on L alone, so that a
    row's bits do not depend on the batch size or head count) or without:
    ((query tiles, B*H, key chunks), float32 scratch elements).  More than
    one key chunk means the split path: partials to scratch and a combining
    launch."""
    return _plan(torch.cuda.current_device(), B, H, L,
                 dtype == torch.bfloat16, stats)


def _on_device(device):
    """The device context for ``device``, entered only when it is not the
    current card."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _current_stream():
    """The current card's current CUDA stream, as the integer handle the
    kernels take."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream().cuda_stream
    return raw(torch.cuda.current_device())


def _launch_forward(q, k, v, key_pad_mask, with_stats):
    """K1 -> out, or (out, row_max, row_sum) with the softmax statistics
    the backward reads."""
    global launches, launches_bf16
    _check_inputs("fused_attention", q, k, v, key_pad_mask)
    device = torch.cuda.current_device()
    if q.get_device() != device:
        with torch.cuda.device(q.device):
            return _launch_forward(q, k, v, key_pad_mask, with_stats)
    bf16 = q.dtype == torch.bfloat16
    B, H, L, D = q.shape
    lib = load_library()
    _, n_scratch = _plan(device, B, H, L, bf16, with_stats)
    out = torch.empty_like(q)
    row_max = row_sum = scratch = None
    if with_stats:
        row_max = torch.empty((B, H, L), device=q.device, dtype=torch.float32)
        row_sum = torch.empty_like(row_max)
    if n_scratch:
        # the key-split partials
        scratch = torch.empty(n_scratch, device=q.device, dtype=torch.float32)
    name = "fs2_mha_fwd_bf16" if bf16 else "fs2_mha_fwd_f32"
    err = getattr(lib, name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_pad_mask.data_ptr(),
        out.data_ptr(),
        None if row_max is None else row_max.data_ptr(),
        None if row_sum is None else row_sum.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        B, H, L, D, SCALE, _current_stream())
    check(err, name)
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return (out, row_max, row_sum) if with_stats else out


def fused_attention_backward(q, k, v, key_pad_mask, out, row_max, row_sum,
                             g):
    """K3: (dq, dk, dv) of the attention whose K1 forward gave ``out``,
    ``row_max`` and ``row_sum``, for the incoming gradient ``g`` (made
    contiguous here: autograd may hand over a strided one).  The float32
    instance forms D = rowsum(G * out); the bfloat16 one does not read
    ``out``: it forms D = rowsum(dP * P) as the TPU kernel does
    (csrc/attention_bwd_bf16.cu says why)."""
    global bwd_launches, bwd_launches_bf16
    _check_inputs("fused_attention_backward", q, k, v, key_pad_mask)
    B, H, L, D = q.shape
    bf16 = q.dtype == torch.bfloat16
    g = g.contiguous()
    for name, t, shape, dtype in (
            ("out", out, (B, H, L, D), q.dtype),
            ("g", g, (B, H, L, D), q.dtype),
            ("row_max", row_max, (B, H, L), torch.float32),
            ("row_sum", row_sum, (B, H, L), torch.float32)):
        if (t.device != q.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"fused_attention_backward: {name} must be a "
                             f"contiguous, 16-byte aligned {dtype} {shape} "
                             f"tensor on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    lib = load_library()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # D, one float a query row, at both dtypes
    scratch = torch.empty(lib.fs2_mha_bwd_scratch_floats(B, H, L, int(bf16)),
                          device=q.device, dtype=torch.float32)
    scale = 1.0 / math.sqrt(D)
    with _on_device(q.device):
        stream = _current_stream()
        if bf16:
            name = "fs2_mha_bwd_bf16"
            err = lib.fs2_mha_bwd_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                key_pad_mask.data_ptr(), row_max.data_ptr(),
                row_sum.data_ptr(), g.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), B, H, L, D,
                scale, stream)
        else:
            name = "fs2_mha_bwd_f32"
            err = lib.fs2_mha_bwd_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                key_pad_mask.data_ptr(), out.data_ptr(), row_max.data_ptr(),
                row_sum.data_ptr(), g.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), B, H, L, D,
                scale, stream)
    check(err, name)
    if bf16:
        bwd_launches_bf16 += 1
    else:
        bwd_launches += 1
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """K1 forward, K3 backward (the custom VJP of
    ``fastspeech2_tpu/ops/pallas_attention.py:227-251``), or their plain
    versions for CPU tensors; the mask gets no gradient, as in ``_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, key_pad_mask):
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, key_pad_mask)
            return multi_head_attention(q, k, v, key_pad_mask)
        out, row_max, row_sum = _launch_forward(q, k, v, key_pad_mask, True)
        ctx.save_for_backward(q, k, v, key_pad_mask, out, row_max, row_sum)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if saved[0].device.type == "cpu":
            dq, dk, dv = plain_attention_backward(*saved, g)
        else:
            dq, dk, dv = fused_attention_backward(*saved, g)
        return dq, dk, dv, None


def fused_attention(q, k, v, key_pad_mask):
    """softmax(where(pad_key, -1e9, QK^T/sqrt(Dh))) V over [B, H, L, Dh].

    q, k, v: float32 or bfloat16 [B, H, L, 128]; key_pad_mask: bool
    [B, L], True = padded key.  The output has q's dtype.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FusedAttention.apply(q, k, v, key_pad_mask)
    if q.device.type == "cpu":
        return multi_head_attention(q, k, v, key_pad_mask)
    return _launch_forward(q, k, v, key_pad_mask, False)
