"""A test-only per-layer metric: the dispatches the window recorded."""


def read(ctx):
    return len(ctx["dispatches"]) or None
