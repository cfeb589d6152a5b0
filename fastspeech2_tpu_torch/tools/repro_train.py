"""Is a training step reproducible on the card?

    python -m fastspeech2_tpu_torch.tools.repro_train

Trains 5 steps twice from one seed at full model width (the
synthetic corpus and batches of ``tools/profile_train.py``: batch 10,
encoder L 128, decoder L 1000) under three settings of the kernel
libraries, and prints for each the largest |difference| between the two
runs' parameters and the median time per step (host clock, device
synchronised, steps 2 onward):

- ``cudnn-default``: cuDNN free to pick any algorithm
  (``cudnn.deterministic = False``), as the port trained before
  ``init_training`` pinned it;
- ``cudnn-deterministic``: the flags ``init_training`` sets;
- ``strict``: also ``torch.use_deterministic_algorithms(True)``, which
  raises on an operation that has no deterministic implementation and so
  names it.

Raises without a card.
"""

import os
import statistics
import time

import torch

from fastspeech2_tpu_torch.tools.profile_train import init_synthetic_training
from fastspeech2_tpu_torch.training.step import train_step
from fastspeech2_tpu_torch.utils.device import resolve_device

MODES = ("cudnn-default", "cudnn-deterministic", "strict")
STEPS = 5


def train_once(device, mode):
    """-> ({name: parameter}, [ms per step]) after STEPS steps."""
    model, _, optimizer, batches = init_synthetic_training(device)
    torch.backends.cudnn.deterministic = mode != "cudnn-default"
    torch.use_deterministic_algorithms(mode == "strict")
    times = []
    try:
        for step in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(model, optimizer, batches[step % len(batches)], step)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = True
    return ({n: p.detach().clone() for n, p in model.named_parameters()},
            times)


def compare(device, mode):
    """-> (max |difference|, tensors that differ, tensors, median ms)."""
    a, ta = train_once(device, mode)
    b, tb = train_once(device, mode)
    diffs = {n: (a[n] - b[n]).abs().max().item() for n in a}
    return (max(diffs.values()), sum(v > 0 for v in diffs.values()),
            len(diffs), statistics.median(ta[1:] + tb[1:]))


def main():
    # cuBLAS is deterministic under use_deterministic_algorithms only with
    # a fixed workspace; it reads this before its first handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = resolve_device("cuda")
    card = torch.cuda.get_device_name(0)
    for mode in MODES:
        try:
            diff, n_diff, n, ms = compare(device, mode)
        except RuntimeError as e:
            if mode != "strict":
                raise
            print(f"[repro] {mode}: an operation has no deterministic "
                  f"implementation: {e}", flush=True)
            continue
        print(f"[repro] {mode}: {STEPS} steps twice from one seed: max "
              f"|parameter difference| {diff:.3e}, {n_diff} of {n} tensors "
              f"differ; median {ms:.2f} ms per step; on {card}", flush=True)


if __name__ == "__main__":
    main()
