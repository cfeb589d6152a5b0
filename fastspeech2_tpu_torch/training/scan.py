"""Scan mode of the acoustic trainer: the batch schedule of the JAX
package's device-resident scanned path
(``fastspeech2_tpu/training/loop.py::_train_scanned``, :429-535), as plain
functions.

With ``step.scan_step`` > 1 in train.yaml the JAX loop freezes the batches
of epoch 0, stacks each shape group's batches on the device once, and runs
K optimizer steps a dispatch, each indexing the stack by a schedule drawn
on the host.  ``training/loop.py`` runs that schedule here, each step
being the eager ``training.step.train_step`` on one batch of the stack.
These functions decide which batch each step trains on, with the same
numpy calls in the same order as the JAX loop, so the two packages train
on the same batches in the same order, a resume included.
"""

import math

import numpy as np

from fastspeech2_tpu_torch.training.step import BATCH_KEYS

SHUFFLE_SEED = 1234


def dispatch_steps(scan_step, periods, total_step):
    """K, the steps a dispatch: gcd of ``scan_step`` and every duty period
    (log, synth, val, save) below ``total_step``, so that each duty falls
    on a dispatch's end (:454-461).  K <= 1 means the per-step path."""
    K = scan_step
    for p in periods:
        if p < total_step:
            K = math.gcd(K, p)
    return K


def host_bytes(batch, mel_bf16=False):
    """The host bytes of a loader batch's model arrays as the JAX loop
    counts them against the budget (:471-482): the mels at 2 bytes an
    element with ``transfer.mel_bf16``."""
    return sum(batch[k].size * (2 if mel_bf16 and k == "mels"
                                else batch[k].itemsize) for k in BATCH_KEYS)


def signature(batch):
    """A batch's shape group: its model arrays' sorted (key, shape, dtype).
    mel_bf16 and the grad_acc_step reshape change every batch alike, so
    they leave the groups as they are."""
    return tuple(sorted((k, batch[k].shape, str(batch[k].dtype))
                        for k in BATCH_KEYS))


def gather_epoch(batches, budget_bytes, mel_bf16=False):
    """Epoch 0's loader batches -> their shape groups (lists of batches, in
    the order of each group's first batch), or None as soon as the summed
    host bytes pass ``budget_bytes`` (:471-482), before the rest of the
    epoch is read."""
    groups = {}
    total = 0
    for batch in batches:
        total += host_bytes(batch, mel_bf16)
        if total > budget_bytes:
            return None
        groups.setdefault(signature(batch), []).append(batch)
    return list(groups.values())


def budget_line(budget_bytes):
    """The JAX loop's line for an epoch over the budget."""
    return (f"scan mode disabled: stacked epoch exceeds the "
            f"{budget_bytes / 2**20:.0f} MiB HBM budget "
            f"(step.scan_hbm_budget_mb); falling back to the "
            f"streaming per-step path")


INCOMPATIBLE_LINE = ("scan_step incompatible with duty periods; using "
                     "per-step path")


class Schedule:
    """The dispatches' draws (:500-532).  Groups of ``sizes`` batches,
    weighted n_g / n_total; each dispatch adds the weights to the credit,
    takes the group of the largest credit (ties to the lower index) and
    pays 1 for it, and takes the next indices of that group's endless
    stream of permutations.  Every permutation comes from one
    ``np.random.RandomState(1234 + start_step)``, in the order the streams
    need them."""

    def __init__(self, sizes, start_step):
        self.rng = np.random.RandomState(SHUFFLE_SEED + start_step)
        self.streams = [self._stream(n) for n in sizes]
        n_total = sum(sizes)
        self.weights = np.array([n / n_total for n in sizes])
        self.credit = np.zeros(len(sizes))

    def _stream(self, n):
        while True:
            for i in self.rng.permutation(n):
                yield int(i)

    def draw(self, k):
        """The next dispatch of ``k`` steps -> (group, [k] batch indices)."""
        self.credit += self.weights
        gi = int(np.argmax(self.credit))
        self.credit[gi] -= 1.0
        idx = np.fromiter((next(self.streams[gi]) for _ in range(k)),
                          np.int32, count=k)
        return gi, idx


def schedule(sizes, K, start_step, total_step):
    """Every dispatch from ``start_step`` to ``total_step`` ->
    [(group, [k] batch indices)], k = min(K, steps left)."""
    plan, out, step = Schedule(sizes, start_step), [], start_step
    while step < total_step:
        k = min(K, total_step - step)
        out.append(plan.draw(k))
        step += k
    return out
