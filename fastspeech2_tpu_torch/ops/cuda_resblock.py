"""K4: the HiFi-GAN MRF ResBlock, hand-written CUDA for Hopper
(``csrc/resblock.cu``), replacing the TPU kernel
``fastspeech2_tpu/ops/pallas_resblock.py::_resblock_kernel``, with its plain
version.

Both compute, on channels-first x [B, C, L] with the ResBlock's
``nn.Conv1d`` weights w1[u], w2[u] [C, C, k] and biases b1[u], b2[u] [C],
for each dilation d = dilations[u]:

    t = lrelu_0.1(x) -> k-tap conv dilated by d, SAME zero padding (k*d-d)//2
        -> + b1[u] -> lrelu_0.1 -> k-tap conv, padding (k-1)//2 -> + b2[u]
    x = x + t

in float32 (``xla_resblock``, fastspeech2_tpu/ops/pallas_resblock.py:50-72,
in the port's layout).

:func:`fused_resblock` is the one entry point.  For tensors on the CPU it
computes the plain version; for CUDA tensors it launches the kernel or
raises: no shape is sent to the plain version, short L included (the JAX
wrapper's ``lt <= halo`` exit has no counterpart here).  One call is one
ResBlock and six kernel launches (two per dilation unit); ``launches``
counts calls.  The kernel reads the weights packed once as [C_in, k, C_out]
(:func:`pack_resblock_weights`); the model keeps that pack and rebuilds it
only when a weight changes.  K4 is inference-only, as the TPU kernel is:
on CUDA a call that wants a gradient raises (nothing in the port trains
through it; vocoder training runs the plain path, as
``fastspeech2_tpu/training/vocoder.py:475`` does).
"""

import torch
from torch.nn import functional as F

from fastspeech2_tpu_torch.ops.cuda_build import check, load_library

LRELU_SLOPE = 0.1
KERNEL_SIZES = (3, 7, 11)

# fused_resblock calls that launched the kernel since the count was last set
# to 0 (each call is one ResBlock: six launches)
launches = 0


def plain_resblock(x, w1, b1, w2, b2, dilations):
    """Plain PyTorch version: x [B, C, L]; w1, w2 sequences of [C, C, k]
    Conv1d weights, b1, b2 of [C] biases, one of each per dilation."""
    k = w1[0].shape[-1]
    for u, d in enumerate(dilations):
        t = F.conv1d(F.leaky_relu(x, LRELU_SLOPE), w1[u], b1[u],
                     padding=(k * d - d) // 2, dilation=d)
        t = F.conv1d(F.leaky_relu(t, LRELU_SLOPE), w2[u], b2[u],
                     padding=(k - 1) // 2)
        x = x + t
    return x


def pack_resblock_weights(w1, b1, w2, b2):
    """-> (w1p, b1p, w2p, b2p): weights stacked as [U, C_in, k, C_out],
    biases as [U, C], contiguous: the layout K4 reads."""
    def pack_w(ws):
        return torch.stack([w.detach().permute(1, 2, 0) for w in ws]
                           ).contiguous()

    def pack_b(bs):
        return torch.stack([b.detach() for b in bs]).contiguous()

    return pack_w(w1), pack_b(b1), pack_w(w2), pack_b(b2)


def fused_resblock(x, w1, b1, w2, b2, dilations, packed=None):
    """x: float32 [B, C, L]; w1, w2: sequences of [C, C, k] weights; b1,
    b2: of [C] biases; ``packed``: their :func:`pack_resblock_weights`, made
    here when not given."""
    if x.device.type == "cpu":
        return plain_resblock(x, w1, b1, w2, b2, dilations)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *w1, *b1, *w2, *b2)):
        raise RuntimeError("fused_resblock: K4 is inference-only; call it "
                           "under torch.inference_mode() or no_grad()")
    if packed is None:
        packed = pack_resblock_weights(w1, b1, w2, b2)
    return _launch(x, packed, dilations)


def _launch(x, packed, dilations):
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError("fused_resblock: x must be [B, C, L]")
    B, C, L = x.shape
    w1p, b1p, w2p, b2p = packed
    U = len(dilations)
    k = w1p.shape[2] if w1p.dim() == 4 else -1
    shapes = {"x": (x, (B, C, L)), "w1": (w1p, (U, C, k, C)),
              "b1": (b1p, (U, C)), "w2": (w2p, (U, C, k, C)),
              "b2": (b2p, (U, C))}
    for name, (t, shape) in shapes.items():
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"fused_resblock: {name} must be float32 on "
                             f"{x.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"fused_resblock: {name} must be contiguous "
                             f"{shape}, got {tuple(t.shape)}")
        if name != "x" and t.data_ptr() % 16:
            raise ValueError(f"fused_resblock: {name} is not 16-byte "
                             "aligned (the kernel loads float4)")
    if C % 32 or k not in KERNEL_SIZES or min(dilations, default=0) < 1:
        raise ValueError(f"fused_resblock: takes C a multiple of 32, k in "
                         f"{KERNEL_SIZES} and dilations >= 1; got C={C}, "
                         f"k={k}, dilations={dilations}")
    lib = load_library()
    out = torch.empty_like(x)
    scratch = torch.empty_like(x)
    src = x
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for u, d in enumerate(dilations):
            err = lib.fs2_resblock_unit_f32(
                src.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                w1p[u].data_ptr(), b1p[u].data_ptr(), w2p[u].data_ptr(),
                b2p[u].data_ptr(), B, C, L, k, d, stream)
            check(err, "fs2_resblock_unit_f32")
            src = out
    launches += 1
    return out
