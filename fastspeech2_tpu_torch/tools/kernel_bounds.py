"""The least time an H100 could take for K4, the TPU kernel still to port
(``fastspeech2_tpu/ops/pallas_resblock.py::_resblock_kernel``), at the
shapes the parity HiFi-GAN gives it:

    python -m fastspeech2_tpu_torch.tools.kernel_bounds [--frames 1000]

Pure arithmetic from the shapes, no device.  One call is one MRF ResBlock
of kernel size k on x [B, L, C]: 3 dilation units (1, 3, 5) of two k-tap
convs, 12 k C^2 B L operations; it reads x and the weights once and writes
the output once.  The parity generator (upsample rates 8, 8, 2, 2 from 512
channels) runs it at C = 64 on L = 128 T and at C = 32 on L = 256 T for a
T-frame mel, with k = 3, 7 and 11 at each.  Peaks: 67 TFLOP/s float32
outside the tensor cores and 3.35 TB/s (H100 SXM data sheet).
"""

import argparse

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def resblock_bound_ms(B, L, C, k, units=3, itemsize=4):
    """-> (bound in ms, "operations" | "bytes", operations, bytes)."""
    flops = units * 2 * (2.0 * k * C * C) * B * L
    nbytes = itemsize * (2 * B * L * C + units * 2 * (k * C * C + C))
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", flops, nbytes
    return t_bytes, "bytes", flops, nbytes


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--frames", type=int, default=1000)
    parser.add_argument("--batch", type=int, default=1)
    args = parser.parse_args(argv)
    total = 0.0
    for C, up in ((64, 128), (32, 256)):
        L = up * args.frames
        for k in (3, 7, 11):
            ms, by, flops, nbytes = resblock_bound_ms(args.batch, L, C, k)
            total += ms
            print(f"K4 x [{args.batch}, {L}, {C}] k={k}: {flops:.4g} "
                  f"operations, {nbytes:.4g} bytes -> bound {ms:.4f} ms "
                  f"({by})")
    print(f"K4, the six calls of one parity-vocoder forward on a "
          f"{args.frames}-frame mel: bound {total:.4f} ms")


if __name__ == "__main__":
    main()
