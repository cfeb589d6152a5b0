"""K4's share of its roofline over the traced window: the least time of
every K4 call of the dispatches that started inside it (six MRF ResBlocks
of the iSTFT vocoder a dispatch, at its utterances' own frames, not the
padded ones; benchmark/harness/flops.py) over the device time of the
kernels named resblock, in percent."""

from benchmark.harness import flops
from benchmark.harness.trace import kernel_seconds


def read(ctx):
    tr = ctx["trace"]
    sec, n = kernel_seconds(tr["kernels"], "resblock")
    if not n:
        return None
    vcfg = ctx["cell"].config["vocoder"]
    bound = sum(flops.vocoder_k4_bound_s(frames, vcfg)
                for t0, _, frames in ctx["dispatches"]
                if tr["t0"] <= t0 <= tr["t1"])
    return 100.0 * bound / sec
