"""Host milliseconds per Synthesizer.synthesize_ids call (packing, the
graph replay or eager dispatch, the copy of the wavs to the host) that
started inside the traced window, as the harness's wrapper of that method
times it; the call ends in a device-to-host copy, so the device's work is
inside it."""


def read(ctx):
    t0, t1 = ctx["trace"]["t0"], ctx["trace"]["t1"]
    calls = [(a, b) for a, b, _ in ctx["dispatches"] if t0 <= a <= t1]
    if not calls:
        return None
    return sum(b - a for a, b in calls) / len(calls) * 1e3
