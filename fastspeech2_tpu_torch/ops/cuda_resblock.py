"""K4: the HiFi-GAN MRF ResBlock, hand-written CUDA for Hopper
(``csrc/resblock.cu``: 3xTF32 on ``wgmma``, the weights fed by TMA),
replacing the TPU kernel
``fastspeech2_tpu/ops/pallas_resblock.py::_resblock_kernel``, with its plain
version.

Both compute, on channels-first x [B, C, L] with the ResBlock's
``nn.Conv1d`` weights w1[u], w2[u] [C, C, k] and biases b1[u], b2[u] [C],
for each dilation d = dilations[u]:

    t = lrelu_0.1(x) -> k-tap conv dilated by d, SAME zero padding (k*d-d)//2
        -> + b1[u] -> lrelu_0.1 -> k-tap conv, padding (k-1)//2 -> + b2[u]
    x = x + t

in float32 (``xla_resblock``, fastspeech2_tpu/ops/pallas_resblock.py:50-72,
in the port's layout); the kernel's products run as 3xTF32, within ~1e-5
of float32.

:func:`fused_resblock` is the one entry point.  For tensors on the CPU it
computes the plain version; for CUDA tensors it launches the kernel or
raises: no shape is sent to the plain version, short L included (the JAX
wrapper's ``lt <= halo`` exit has no counterpart here).  One call is one
ResBlock; ``launches`` counts calls.  Each dilation unit is two launches of
the conv kernel, t through device memory (``csrc/resblock.cu`` says why),
at C in :data:`CHANNELS`.  The kernel reads each conv's weights split into
TF32 big and small planes, [32-channel slice][tap][plane][C][32], each
row's 16-byte chunks in the 128-byte swizzle that its ``wgmma`` descriptor
reads, packed once (:func:`pack_resblock_weights`); the model keeps that
pack and rebuilds it only when a weight changes.  K4 is inference-only, as
the TPU kernel is: on CUDA a call that wants a gradient raises (nothing in
the port trains through it; vocoder training runs the plain path, as
``fastspeech2_tpu/training/vocoder.py:475`` does).
"""

import torch
from torch.nn import functional as F

from fastspeech2_tpu_torch.ops.cuda_build import check, load_library
from fastspeech2_tpu_torch.ops.tf32_pack import (
    SLICE,
    pack_planes,
    unpack_planes,
)

LRELU_SLOPE = 0.1
KERNEL_SIZES = (3, 7, 11)
CHANNELS = (32, 64, 128, 256)
MAX_DILATION = 64

# fused_resblock calls that launched the kernel since the count was last set
# to 0 (each call is one ResBlock: two launches per dilation unit)
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


def pack_conv_weight(w):
    """A [C_out, C_in, k] conv weight (C_out = C_in = C, a multiple of 32)
    -> [C/32, k, 2, C, 32] float32, contiguous: for each (32-channel
    slice s, tap j), tf32(w) then tf32(w - tf32(w)) as [C_out][32] planes
    (row co holds w[co, 32 s:32 s + 32, j]), rows in the 128-byte swizzle
    (:func:`~fastspeech2_tpu_torch.ops.tf32_pack.pack_planes`)."""
    C_out, C_in, k = w.shape
    if C_out != C_in or C_in % SLICE:
        raise ValueError(f"pack_conv_weight: [C_out, C_in, k] = "
                         f"{tuple(w.shape)} needs C_out = C_in, a multiple "
                         f"of {SLICE}")
    return pack_planes(w.detach().permute(2, 0, 1))


def unpack_conv_weight(packed):
    """Inverse of :func:`pack_conv_weight`: -> (big, small), each
    [k, C_out, C_in]."""
    return unpack_planes(packed)


def pack_resblock_weights(w1, b1, w2, b2):
    """-> (w1p, b1p, w2p, b2p): each conv's weight as
    :func:`pack_conv_weight` packs it, stacked as [U, C/32, k, 2, C, 32];
    biases as [U, C]; contiguous: what K4 reads."""
    def pack_w(ws):
        return torch.stack([pack_conv_weight(w) for w in ws]).contiguous()

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
        if x.dim() != 3 or x.shape[1] not in CHANNELS:
            raise ValueError(f"fused_resblock: takes x [B, C, L] with C in "
                             f"{CHANNELS}, got {tuple(x.shape)}")
        packed = pack_resblock_weights(w1, b1, w2, b2)
    return _launch(x, packed, dilations)


def _launch(x, packed, dilations, nb=0):
    """``nb``: output channels per block (a power of two from 32 to C), 0
    for the kernel's own choice (C, halved while the halved grid still
    fits one wave of the card: ``fs2_resblock_n_block``); for tests and
    measurement, the model takes the default."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError("fused_resblock: x must be [B, C, L]")
    B, C, L = x.shape
    if C not in CHANNELS:
        raise ValueError(f"fused_resblock: takes C in {CHANNELS}, got C={C}")
    w1p, b1p, w2p, b2p = packed
    U = len(dilations)
    k = w1p.shape[2] if w1p.dim() == 6 else -1
    wshape = (U, C // SLICE, k, 2, C, SLICE)
    shapes = {"x": (x, (B, C, L)), "w1": (w1p, wshape), "b1": (b1p, (U, C)),
              "w2": (w2p, wshape), "b2": (b2p, (U, C))}
    for name, (t, shape) in shapes.items():
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"fused_resblock: {name} must be float32 on "
                             f"{x.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"fused_resblock: {name} must be contiguous "
                             f"{shape}, got {tuple(t.shape)}")
    if w1p.data_ptr() % 16 or w2p.data_ptr() % 16:
        raise ValueError("fused_resblock: the weight pack is not 16-byte "
                         "aligned (the kernel copies it by TMA)")
    if k not in KERNEL_SIZES or not all(1 <= d <= MAX_DILATION
                                        for d in dilations):
        raise ValueError(f"fused_resblock: takes k in {KERNEL_SIZES} and "
                         f"dilations in [1, {MAX_DILATION}]; got k={k}, "
                         f"dilations={dilations}")
    lib = load_library()
    out = torch.empty_like(x)
    scratch = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        # unit 0 reads x and writes out; later units update out in place
        # (the second conv's output may be its residual, never its input)
        src = x
        for u, d in enumerate(dilations):
            check(lib.fs2_resblock_conv_f32(
                src.data_ptr(), w1p[u].data_ptr(), b1p[u].data_ptr(), 0,
                scratch.data_ptr(), B, C, L, k, d, 1, nb, stream),
                "fs2_resblock_conv_f32")
            check(lib.fs2_resblock_conv_f32(
                scratch.data_ptr(), w2p[u].data_ptr(), b2p[u].data_ptr(),
                src.data_ptr(), out.data_ptr(), B, C, L, k, 1, 0, nb,
                stream), "fs2_resblock_conv_f32")
            src = out
    launches += 1
    return out
