"""Noam-scheduled Adam (port of ``fastspeech2_tpu/training/optim.py``).

lr(step) = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
           * anneal_rate^(# anneal_steps passed),   step = count + 1

The update is the JAX package's optax chain, written out on tensors in its
order: clip by global norm -> Adam moments (bias-corrected, eps outside the
sqrt) -> weight decay (when nonzero) -> schedule -> -1.  Two details of
optax are kept:

* the clip scales by max_norm / norm only when norm >= max_norm (not
  ``clip_grad_norm_``'s max_norm / (norm + 1e-6));
* with ``mu_dtype`` bfloat16 the update is computed from the float32 first
  moment, which is only then stored as bfloat16; on the next step
  b1 * mu is a bfloat16 product (optax multiplies the stored moment by the
  weakly typed b1), and the sum with (1 - b1) * g is float32.
"""

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def noam_schedule(d_model, warm_up_step, anneal_steps=(), anneal_rate=1.0):
    """count (updates done so far) -> float32 learning-rate tensor."""
    init_lr = d_model ** -0.5
    anneal = torch.tensor(list(anneal_steps), dtype=torch.float32)

    def schedule(count):
        step = torch.tensor(count, dtype=torch.float32) + 1.0
        scale = torch.minimum(step ** -0.5, step * warm_up_step ** -1.5)
        if anneal.numel():
            n_passed = int((step > anneal).sum())
            scale = scale * torch.tensor(anneal_rate ** n_passed,
                                         dtype=torch.float32)
        return scale * init_lr

    return schedule


class NoamAdam:
    """The optimizer over a list of parameters (updated in place by
    :meth:`step`), with its state in ``mu``, ``nu`` and ``count``.

    An update is two parts, so that a CUDA graph can hold the second
    (``training/step.py::make_scanned_train_step``): :meth:`advance`, on the
    host, advances ``count`` and writes the update's learning rate and
    Adam's bias corrections, computed on the host in float32 as before,
    into 0-d tensors on the parameters' device (``fill_``: no copy from the
    host, so the host does not wait for the card); :meth:`update` applies
    the update from those tensors.  The moments are written in place, so
    each keeps its storage across updates and :meth:`load_state_dict`."""

    def __init__(self, params, optim_config, d_model):
        self.params = list(params)
        self.config = optim_config
        self.schedule = noam_schedule(d_model, optim_config.warm_up_step,
                                      optim_config.anneal_steps,
                                      optim_config.anneal_rate)
        mu_dtype = _DTYPES[optim_config.mu_dtype]
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        device = self.params[0].device
        # the step's scalars, set by advance(): learning rate, 1 - b1^t,
        # 1 - b2^t; and b1 at the first moment's dtype
        self.lr, self.c1, self.c2 = (torch.zeros((), device=device)
                                     for _ in range(3))
        self.decay = torch.tensor(optim_config.betas[0], dtype=mu_dtype,
                                  device=device)

    @torch.no_grad()
    def step(self, grads, norm=None):
        """Apply one update from ``grads`` (aligned with the parameters);
        returns the learning rate it used, as a float32 tensor.  ``norm``:
        the global gradient norm to clip by, where the parameters are a
        shard of the model (``training/step.py::global_grad_norm``); by
        default the norm of ``grads``."""
        self.advance()
        return self.update(grads, norm).clone()

    def advance(self):
        """The host's part of the next update: its scalars written into
        ``lr``, ``c1`` and ``c2`` (optax counts from 0), ``count``
        advanced."""
        b1, b2 = self.config.betas
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - torch.tensor(b1) ** self.count
        c2 = 1.0 - torch.tensor(b2) ** self.count
        for dst, value in ((self.lr, lr), (self.c1, c1), (self.c2, c2)):
            dst.fill_(float(value))

    @torch.no_grad()
    def update(self, grads, norm=None):
        """The device's part: the update from ``grads`` with the scalars of
        the last :meth:`advance` -> ``lr``."""
        cfg = self.config
        b1, b2 = cfg.betas
        grads = [g.float() for g in grads]
        # clip_by_global_norm, without a sync: where(norm < max, g, g/n*max)
        if norm is None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
        small = norm < cfg.grad_clip_thresh
        grads = [torch.where(small, g, g / norm * cfg.grad_clip_thresh)
                 for g in grads]
        # scale_by_adam, then the schedule
        for p, g, mu_i, nu_i in zip(self.params, grads, self.mu, self.nu):
            mu = (1 - b1) * g + mu_i * self.decay          # float32
            nu = (1 - b2) * (g * g) + b2 * nu_i
            update = (mu / self.c1) / (torch.sqrt(nu / self.c2) + cfg.eps)
            mu_i.copy_(mu)
            nu_i.copy_(nu)
            if cfg.weight_decay:
                update = update + cfg.weight_decay * p
            p.add_(-1.0 * (self.lr * update))
        return self.lr

    def state_dict(self):
        """count and copies of the moments (the live ones change in place
        at every update)."""
        return {"count": self.count, "mu": [m.clone() for m in self.mu],
                "nu": [n.clone() for n in self.nu]}

    def load_state_dict(self, state):
        """Copy ``state`` into the kept moments (at their dtypes and on
        their device)."""
        if len(state["mu"]) != len(self.params):
            raise ValueError(f"optimizer state holds {len(state['mu'])} "
                             f"moments for {len(self.params)} parameters")
        for key in ("mu", "nu"):
            for dst, src in zip(getattr(self, key), state[key]):
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"optimizer state: a {key} of shape "
                                     f"{tuple(src.shape)} for a parameter "
                                     f"of shape {tuple(dst.shape)}")
                dst.copy_(src)
        self.count = int(state["count"])


class AdamW:
    """``optax.adamw(schedule, b1, b2, eps, weight_decay)`` over a list of
    parameters updated in place by :meth:`step`: optax's chain in its
    order, the moments (1 - b) * g^k + b * m, their bias corrections,
    mu_hat / (sqrt(nu_hat) + eps), + weight_decay * p (every parameter),
    * -schedule(count) with the count before the update, then p + update.
    ``schedule``: count -> learning rate (a Python float), or a subclass's
    ``schedule`` method.  The state is ``count``, ``mu`` and ``nu``."""

    def __init__(self, params, schedule=None, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=1e-4):
        self.params = list(params)
        if schedule is not None:
            self.schedule = schedule
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        """One update from ``grads``, aligned with the parameters."""
        b1, b2 = self.betas
        lr = self.schedule(self.count)
        self.count += 1
        one, count = np.float32(1), np.float32(self.count)
        c1 = float(one - np.power(np.float32(b1), count))
        c2 = float(one - np.power(np.float32(b2), count))
        grads = list(grads)
        mu = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(self.mu, b1))
        nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(self.nu, b2))
        self.mu, self.nu = mu, nu
        denom = torch._foreach_sqrt(torch._foreach_div(nu, c2))
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(torch._foreach_div(mu, c1), denom)
        if self.weight_decay:
            torch._foreach_add_(update, torch._foreach_mul(
                self.params, self.weight_decay))
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(self.params, update)

    def state_dict(self):
        return {"count": self.count, "mu": list(self.mu),
                "nu": list(self.nu)}

    def load_state_dict(self, state):
        if len(state["mu"]) != len(self.params):
            raise ValueError(f"optimizer state holds {len(state['mu'])} "
                             f"moments for {len(self.params)} parameters")
        self.count = int(state["count"])
        self.mu = [m.to(p.device) for m, p in zip(state["mu"], self.params)]
        self.nu = [n.to(p.device) for n, p in zip(state["nu"], self.params)]
