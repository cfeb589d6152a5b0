"""Requests per dispatch of the coalescer over the window: the change of
BatchingSynthesizer.stats()'s requests over that of its batches between
the window's opening and closing."""


def read(ctx):
    a, b = ctx["stats"]["before"], ctx["stats"]["after"]
    batches = b["batches"] - a["batches"]
    return (b["requests"] - a["requests"]) / batches if batches else None
