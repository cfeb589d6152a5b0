"""Seconds the scan-mode step spent on its shape groups' warm-up steps and
CUDA graph captures in set-up (ScannedTrainStep.capture_seconds)."""


def read(ctx):
    return ctx["capture_s"] or None
