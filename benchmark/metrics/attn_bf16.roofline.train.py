"""K1 and K3 at bfloat16 together, their share of their roofline over the
traced window: the least time of every encoder and decoder block's
attention forward and backward of the window's steps, at each row's real
length (benchmark/harness/flops.py), over the device time of the kernels
whose names hold mha_ and bf16, in percent."""

from benchmark.harness.trace import kernel_seconds


def read(ctx):
    sec, n = kernel_seconds(ctx["trace"]["kernels"], "mha_", "bf16")
    if not n or not ctx["attn_bound_s"]:
        return None
    return 100.0 * ctx["attn_bound_s"] / sec
