"""The least time an H100 could take for K4
(``fastspeech2_tpu/ops/pallas_resblock.py::_resblock_kernel``, ported as
``csrc/resblock.cu``), at the shapes the parity HiFi-GAN gives it, for K2
(``pallas_ffn.py::_ffn_kernel``, ``csrc/conv_ffn_f32.cu``; at bfloat16
``csrc/conv_ffn.cu``) at the FFN's shapes,
and for K1 and K3 (the attention forward and backward,
``csrc/attention.cu`` and ``csrc/attention_bwd.cu``; at bfloat16
``csrc/attention_bf16.cu`` and ``csrc/attention_bwd_bf16.cu``) at the
attention shapes of the main paths:

    python -m fastspeech2_tpu_torch.tools.kernel_bounds [--frames 1000]

Pure arithmetic from the shapes, no device.  One K4 call is one MRF
ResBlock of kernel size k on x [B, C, L]: 3 dilation units (1, 3, 5) of two
k-tap convs, 12 k C^2 B L operations; it reads x and the weights once and
writes the output once.  The parity generator (upsample rates 8, 8, 2, 2
from 512 channels) runs it at C = 256, 128, 64 and 32 on L = 8 T, 64 T,
128 T and 256 T for a T-frame mel, with k = 3, 7 and 11 at each: 12 calls
per forward.  One K2 call on x [B, L, 256] with H = 1024 and taps (9, 1)
is 2 B L 256 H (9 + 1) operations; it reads x and both convs' weights and
biases once and writes the output once.

All four kernels run their products on the tensor cores as 3xTF32, three
TF32 products for each float32-accurate one, so their least time is
max(3 x operations / 495 TFLOP/s, bytes / 3.35 TB/s); the SIMT float32
bound (max(operations / 67 TFLOP/s, bytes / 3.35 TB/s), the CUDA cores'
float32 peak) is given beside it for the record.  Bytes: K1 reads q, k, v
and the mask and writes the output; K3 reads q, k, v, the incoming
gradient and the mask and writes dq, dk and dv.  Peaks: H100 SXM data
sheet (dense TF32 and BF16 without sparsity; HBM3 3.35 TB/s).

The bfloat16 instances (``dtype="bfloat16"``) move 2-byte activations
(and K2 2-byte weights; biases and LayerNorm parameters stay 4-byte).
K1's and K2's products are single bfloat16 products: max(operations /
989 TFLOP/s, bytes / 3.35 TB/s).  K3's five products are of two kinds:
S = Q K^T and dP = G V^T (4 B H L^2 Dh operations) have two bfloat16
operands, exact in one bfloat16 product at 989 TFLOP/s; dV = P^T G,
dK = dS^T Q and dQ = dS K (6 B H L^2 Dh) have one float32 operand (P or
dS) and one bfloat16 operand.  A float32-accurate product of those takes
either two TF32 passes at 495 TFLOP/s (the float32 operand's big and small
parts, the bfloat16 one exact in TF32) or three bfloat16 passes at 989
(the float32 operand as three exact bfloat16 parts, as the kernel splits
it); the bound takes the cheaper, three bfloat16 passes.  Its operations
term is the sum of the two kinds.
"""

import argparse

PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
# 3xTF32: big*small + small*big + big*big for each float32-accurate product
TF32_PASSES = 3
# a float32 operand times a bfloat16 one, float32-accurate: two TF32 passes
# (big, small) or three bfloat16 passes (hi, mid, lo)
TF32_PASSES_MIXED = 2
BF16_PASSES_MIXED = 3
PEAK_HBM_BYTES = 3.35e12
HEAD_DIM = 128
# the attention shapes of the main paths: [B, 2, L, 128] with batch 1 for
# the README sentence (encoder L 32, decoder 1000) and batch 10 in
# training (encoder 128, LJSpeech10's bucket 768, decoder 1000)
ATTENTION_SHAPES = ((1, 32), (1, 1000), (10, 128), (10, 768), (10, 1000))
# (channels, upsampling so far) of the parity generator's four stages
PARITY_STAGES = ((256, 8), (128, 64), (64, 128), (32, 256))
KERNEL_SIZES = (3, 7, 11)
MODEL_DIM = 256
FFN_DIM = 1024
FFN_TAPS = (9, 1)


def _tf32_ms(flops, passes=TF32_PASSES):
    """ms of ``flops`` float32-accurate operations at ``passes`` TF32
    products each."""
    return passes * flops / PEAK_TF32_FLOPS * 1e3


def _bf16_ms(flops, passes=1):
    """ms of ``flops`` operations at ``passes`` bfloat16 products each."""
    return passes * flops / PEAK_BF16_FLOPS * 1e3


def _bound(flops, nbytes, t_ops):
    """-> (bound in ms: max(``t_ops``, the bytes' time); "operations" |
    "bytes"; SIMT float32 bound in ms; operations; bytes)."""
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_simt = max(flops / PEAK_FP32_FLOPS * 1e3, t_bytes)
    if t_ops >= t_bytes:
        return t_ops, "operations", t_simt, flops, nbytes
    return t_bytes, "bytes", t_simt, flops, nbytes


def resblock_bound_ms(B, L, C, k, units=3, itemsize=4):
    """K4 on [B, C, L] -> (bound in ms on the 3xTF32 basis, "operations" |
    "bytes", the SIMT float32 bound in ms, operations, bytes)."""
    flops = units * 2 * (2.0 * k * C * C) * B * L
    nbytes = itemsize * (2 * B * L * C + units * 2 * (k * C * C + C))
    return _bound(flops, nbytes, _tf32_ms(flops))


def ffn_bound_ms(B, L, D=MODEL_DIM, H=FFN_DIM, taps=FFN_TAPS,
                 dtype="float32"):
    """K2 on x [B, L, D] at ``dtype`` -> (bound in ms on the 3xTF32 basis,
    or bfloat16's; "operations" | "bytes"; the SIMT float32 bound in ms;
    operations; bytes)."""
    k1, k2 = taps
    size = 2 if dtype == "bfloat16" else 4
    flops = 2.0 * B * L * D * H * (k1 + k2)
    nbytes = (size * (2 * B * L * D + k1 * D * H + k2 * H * D)
              + 4 * (H + 3 * D))
    return _bound(flops, nbytes, _bf16_ms(flops) if dtype == "bfloat16"
                  else _tf32_ms(flops))


def attention_bound_ms(B, H, L, backward=False, D=HEAD_DIM,
                       dtype="float32"):
    """K1 (forward) or K3 (``backward``) on [B, H, L, D] at ``dtype`` ->
    (bound in ms: 3xTF32 at float32; at bfloat16 bfloat16 products for K1,
    and for K3 bfloat16 products for S and dP with the cheaper of two TF32
    and three bfloat16 passes for the rest; "operations" | "bytes"; the
    SIMT float32 bound in ms; operations; bytes)."""
    product = 2.0 * B * H * L * L * D   # one L x L x D product
    flops = (5 if backward else 2) * product
    tensors = 7 if backward else 4
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * tensors * B * H * L * D + B * L
    if dtype != "bfloat16":
        t_ops = _tf32_ms(flops)
    elif backward:
        t_ops = _bf16_ms(2 * product) + min(
            _tf32_ms(3 * product, passes=TF32_PASSES_MIXED),
            _bf16_ms(3 * product, passes=BF16_PASSES_MIXED))
    else:
        t_ops = _bf16_ms(flops)
    return _bound(flops, nbytes, t_ops)


def parity_resblock_shapes(frames):
    """-> [(C, L, k)] of the 12 ResBlock calls of one parity-vocoder
    forward on a ``frames``-frame mel."""
    return [(C, up * frames, k) for C, up in PARITY_STAGES
            for k in KERNEL_SIZES]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--frames", type=int, default=1000)
    parser.add_argument("--batch", type=int, default=1)
    args = parser.parse_args(argv)
    total = total_simt = total_flops = 0.0
    shapes = parity_resblock_shapes(args.frames)
    for C, L, k in shapes:
        ms, by, simt, flops, nbytes = resblock_bound_ms(args.batch, L, C, k)
        total += ms
        total_simt += simt
        total_flops += flops
        print(f"K4 x [{args.batch}, {C}, {L}] k={k}: {flops:.4g} "
              f"operations, {nbytes:.4g} bytes -> bound {ms:.4f} ms ({by}, "
              f"3xTF32 on the tensor cores); SIMT float32 bound {simt:.4f} "
              "ms")
    print(f"K4, the {len(shapes)} calls of one parity-vocoder forward on a "
          f"{args.frames}-frame mel: {total_flops:.4g} operations, bound "
          f"{total:.4f} ms (3xTF32); SIMT float32 bound {total_simt:.4f} ms")
    for dtype in ("float32", "bfloat16"):
        for B, L in ((1, 32), (1, 1000), (10, 1000)):
            ms, by, simt, flops, nbytes = ffn_bound_ms(B, L, dtype=dtype)
            basis = "BF16" if dtype == "bfloat16" else "3xTF32"
            print(f"K2 {dtype} x [{B}, {L}, {MODEL_DIM}] -> {FFN_DIM}, taps "
                  f"{FFN_TAPS}: {flops:.4g} operations, {nbytes:.4g} bytes "
                  f"-> bound {ms:.4e} ms ({by}, {basis} on the tensor "
                  f"cores); SIMT float32 bound {simt:.4e} ms")
        for B, L in ATTENTION_SHAPES:
            for name, backward in (("K1", False), ("K3", True)):
                if backward and B == 1:
                    continue
                ms, by, simt, flops, nbytes = attention_bound_ms(
                    B, 2, L, backward, dtype=dtype)
                basis = ("3xTF32" if dtype != "bfloat16" else
                         "BF16 for S and dP, 3xBF16 for the rest" if backward
                         else "BF16")
                print(f"{name} {dtype} x [{B}, 2, {L}, {HEAD_DIM}]: "
                      f"{flops:.4g} operations, {nbytes:.4g} bytes -> bound "
                      f"{ms:.4e} ms ({by}, {basis} on the tensor cores); "
                      f"SIMT float32 bound {simt:.4e} ms")


if __name__ == "__main__":
    main()
