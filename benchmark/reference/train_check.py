"""The training cell's comparison: the reference follows the checked
optimizer steps (one on each shape group's first batch) from the same
initial weights on the same batches, in float32 with TF32 off, and the
system's readings are held to it.

A step: the teacher-forced forward in training mode, its dropout masks
drawn from a generator on the device seeded as the system seeds its own
(seed = ((1234 * 1000003 + step) * 1009 + micro-batch) mod 2^63), the six
losses, their gradient, clipping by the global norm (scaled by
max / norm only where norm >= max), Adam (bias-corrected moments, eps
outside the square root), a Noam learning rate d^-0.5 * min(s^-0.5,
s * warmup^-1.5) at s = step + 1, applied as p -= lr * update.

Numbers (those the traffic file's ``limits`` names are compared):

- ``loss_gap``: the largest over the steps of |system total loss -
  reference total loss| / |reference total loss|;
- ``grad_gap``: the first step's clipped gradient, the system's worked out
  from its first moment after that step (m / (1 - b1)): the largest over
  the leaves of |norm(system) - norm(reference)| / max(norm(reference), the
  median leaf's norm); ``grad_gap_median``: the median leaf's;
- ``change_gap``, ``change_gap_median``: the same of each leaf's change
  over all the steps, leaving out the leaves whose first reference
  gradient is under a thousandth of the median leaf's (they move under
  Adam by round-off).
"""

import numpy as np
import torch

from benchmark.reference.fs2 import Model, is_buffer, losses

TRAIN_SEED = 1234


def dropout_seed(step, micro=0):
    return ((TRAIN_SEED * 1_000_003 + step) * 1_009 + micro) % (1 << 63)


def noam_lr(count, d_model, warm_up):
    s = count + 1.0
    return d_model ** -0.5 * min(s ** -0.5, s * warm_up ** -1.5)


def reference_steps(params0, arch, optim, batches, device, quant=None):
    """-> (total losses of each step, the first step's clipped gradients,
    the parameters after the last step), name -> tensor."""
    names = [n for n in params0 if not is_buffer(n)]
    p = {n: params0[n].detach().clone().float() for n in params0}
    kw = {} if quant is None else {"quant": quant}
    model = Model(p, arch, **kw)
    model.train = True
    b1, b2 = optim["betas"]
    mu = {n: torch.zeros_like(p[n]) for n in names}
    nu = {n: torch.zeros_like(p[n]) for n in names}
    totals, first_grad = [], None
    for step, batch in enumerate(batches):
        gen = torch.Generator(device=device)
        gen.manual_seed(dropout_seed(step))
        model.gen = gen
        t = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        leaves = {n: p[n].requires_grad_(True) for n in names}
        out = model.forward(t["texts"], t["src_lens"], t["mels"].shape[1],
                            t["durations"], t["pitches"], t["energies"],
                            mel_lens=t["mel_lens"])
        loss = losses(out, t["mels"], t["pitches"], t["energies"],
                      t["durations"])
        grads = torch.autograd.grad(loss[0], [leaves[n] for n in names],
                                    allow_unused=True)
        totals.append(float(loss[0].detach()))
        with torch.no_grad():
            g = {n: (torch.zeros_like(p[n]) if gi is None else gi)
                 for n, gi in zip(names, grads)}
            norm = torch.sqrt(sum((x * x).sum() for x in g.values()))
            clip = optim["grad_clip_thresh"]
            if norm >= clip:
                g = {n: x / norm * clip for n, x in g.items()}
            if first_grad is None:
                first_grad = {n: x.clone() for n, x in g.items()}
            lr = noam_lr(step, arch["encoder_hidden"], optim["warm_up_step"])
            c1, c2 = 1.0 - b1 ** (step + 1), 1.0 - b2 ** (step + 1)
            for n in names:
                mu[n] = (1 - b1) * g[n] + b1 * mu[n]
                nu[n] = (1 - b2) * g[n] * g[n] + b2 * nu[n]
                upd = (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + optim["eps"])
                p[n] = (p[n].detach() - lr * upd)
        model.p = p
    return totals, first_grad, {n: p[n].detach() for n in names}


def _leaf_gaps(sys_norms, ref_norms, keep):
    """name -> |norm(system) - norm(reference)| / max(norm(reference), the
    median leaf's norm), over the leaves ``keep``."""
    med = float(np.median([ref_norms[n] for n in keep]))
    return {n: abs(sys_norms[n] - ref_norms[n]) / max(ref_norms[n], med)
            for n in keep}


def compare(sys_losses, sys_grad, sys_change, ref_losses, ref_grad,
            ref_change, limits):
    """Norms per leaf (name -> float) -> ([(name, value, limit)] of the
    numbers ``limits`` names, correct, every number and the worst leaves).
    """
    names = sorted(ref_grad)
    med = float(np.median([ref_grad[n] for n in names]))
    moving = [n for n in names if ref_grad[n] >= 1e-3 * med]
    grad = _leaf_gaps(sys_grad, ref_grad, names)
    change = _leaf_gaps(sys_change, ref_change, moving)
    numbers = {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(sys_losses, ref_losses)),
        "grad_gap": max(grad.values()),
        "grad_gap_median": float(np.median(list(grad.values()))),
        "change_gap": max(change.values()),
        "change_gap_median": float(np.median(list(change.values())))}
    checks = [(n, numbers[n], limits[n]) for n in numbers if n in limits]
    correct = all(v <= lim for _, v, lim in checks)
    notes = {"numbers": numbers, "grad": max(grad, key=grad.get),
             "change": max(change, key=change.get),
             "left_out": sorted(set(names) - set(moving))}
    return checks, correct, notes


def norms(tensors):
    return {n: float(t.double().norm()) for n, t in tensors.items()}
