"""The model FLOPs of the steps in the traced window (3 x the forward at
each row's own phones and frames: benchmark/harness/flops.py) over the
traced window's seconds (its end synchronised) times one H100's dense
peak at the configuration's compute dtype, in percent."""

from benchmark.harness import flops


def read(ctx):
    if not ctx["flops"]:
        return None
    dtype = ctx["cell"].config["dtype"]
    return 100.0 * ctx["flops"] / (ctx["trace"]["window_s"]
                                   * flops.PEAK_FLOPS[dtype])
