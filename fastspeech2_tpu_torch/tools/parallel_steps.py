"""Training steps at a (data, model) layout, as rank functions for
``parallel/launch.run_ranks``, and the same steps in one process: what the
multi-process tests run on the CPU and ``chip_smoke.py`` runs as two
ranks on one card.

:func:`acoustic_steps` builds the model and optimizer through the train
loop's own ``training.loop.build_training`` and steps them with
``training.step.train_step``.  It takes a spec (a dict, picklable):

* ``cfg`` (``FastSpeech2Config``), ``optim`` (``OptimConfig``),
  ``state`` (the whole model's state dict as numpy arrays), optionally
  ``opt_state`` (a whole optimizer state dict) and ``first_step``;
* ``batches``: global loader batches (numpy), one per step;
* ``data``, ``model``: the layout (1, 1 in one process);
* ``train`` (training mode, default True), ``dropout`` (False sets every
  dropout rate to 0, the PostNet's 0.5 included), ``device``, ``dtype``
  ("float32" or "bfloat16");
* ``save_dir``: write the whole checkpoint after the last step there
  (rank 0);
* ``record_masks``: return each dropout's keep pattern of the first step;
* ``cudnn`` (default True): False runs the convolutions without cuDNN
  (PyTorch's own kernels), another summation order for every one.

It returns the per-step losses and host seconds, the first step's whole
gradient (summed over the data group, before the clip) and the global
norm it was clipped by, the whole state dict after the first step and
after the last (gathered over the model group), and the K1/K3 launches
of the steps.  :func:`vocoder_steps` runs
``training.vocoder.train_vocoder`` on a rank of a data-parallel world and
returns its networks' state.  :func:`run_tasks` runs several such calls
in one world, so that one set of processes serves them all.
:func:`state_errors` compares two whole state dicts.
"""

import re
import time

import numpy as np
import torch

# parameters whose gradient is 0 in exact arithmetic: the softmax ignores
# a shift shared by every key (w_ks.bias), and a training-mode BatchNorm
# removes any bias of the conv before it.  Adam turns each run's rounding
# noise in those gradients into steps of up to the learning rate, of
# either sign, which the forward does not see; the running mean of the
# BatchNorm after such a conv follows its bias.
ZERO_GRADIENT = (r".*slf_attn\.w_ks\.bias",
                 r"postnet\.convolutions\.\d+\.0\.conv\.bias")

def _numpy_state(state):
    """A copy (the buffers change in place later) as float32 numpy."""
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in state.items()}


def acoustic_steps(rank, world, spec):
    with torch.backends.cudnn.flags(enabled=spec.get("cudnn", True),
                                    benchmark=False, deterministic=True,
                                    allow_tf32=False):
        return _acoustic_steps(spec)


def _acoustic_steps(spec):
    from fastspeech2_tpu_torch.cli.common import dtype_from_flag
    from fastspeech2_tpu_torch.models.common import Dropout
    from fastspeech2_tpu_torch.ops import cuda_attention
    from fastspeech2_tpu_torch.parallel.mesh import make_mesh
    from fastspeech2_tpu_torch.parallel.sharding import unshard_state_dict
    from fastspeech2_tpu_torch.training.loop import (
        build_training,
        rank_rows,
        save_training_state,
    )
    from fastspeech2_tpu_torch.training.step import (
        batch_to_device,
        train_step,
    )

    device = torch.device(spec.get("device", "cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(spec["data"], spec["model"])
    if not mesh.active:
        return None
    acc = spec["optim"].grad_acc_step
    model, opt = build_training(
        spec["cfg"], spec["optim"], device,
        dtype=dtype_from_flag(spec.get("dtype", "float32")), mesh=mesh,
        state={k: torch.as_tensor(v) for k, v in spec["state"].items()},
        opt_state=spec.get("opt_state"))
    model.train(spec.get("train", True))
    if not spec.get("dropout", True):
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    names = [n for n, _ in model.named_parameters()]
    first_grads = {}
    opt_step = opt.step

    def recording_step(grads, norm=None):
        if not first_grads:
            g = [t.float() for t in grads]
            first_grads["norm"] = float(
                norm if norm is not None
                else torch.sqrt(sum((t * t).sum() for t in g)))
            first_grads["grads"] = _numpy_state(unshard_state_dict(
                dict(zip(names, g)), mesh.model_rank, mesh.model,
                mesh.model_group))
        return opt_step(grads, norm=norm)

    opt.step = recording_step
    masks = []
    if spec.get("record_masks"):
        hooks = [m.register_forward_hook(
            lambda mod, inp, out: masks.append(
                (out != 0).cpu().numpy()) if len(masks) < 64 else None)
            for m in model.modules() if isinstance(m, Dropout)]
    losses, step_s, after_first = [], [], None
    start = (cuda_attention.launches + cuda_attention.launches_bf16,
             cuda_attention.bwd_launches + cuda_attention.bwd_launches_bf16)
    first = spec.get("first_step", 0)
    for i, batch in enumerate(spec["batches"]):
        t0 = time.perf_counter()
        local = batch_to_device(rank_rows(batch, mesh, acc), device)
        out = train_step(model, opt, local, first + i, grad_acc_step=acc)
        losses.append(torch.stack(list(out)).float().cpu().numpy())
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            after_first = _numpy_state(unshard_state_dict(
                model.state_dict(), mesh.model_rank, mesh.model,
                mesh.model_group))
            if spec.get("record_masks"):
                for h in hooks:
                    h.remove()
    launches = (cuda_attention.launches + cuda_attention.launches_bf16
                - start[0],
                cuda_attention.bwd_launches + cuda_attention.bwd_launches_bf16
                - start[1])
    if spec.get("save_dir"):
        save_training_state(spec["save_dir"], model, opt,
                            first + len(spec["batches"]), mesh)
    state = unshard_state_dict(model.state_dict(), mesh.model_rank,
                               mesh.model, mesh.model_group)
    return {"losses": np.stack(losses), "step_s": step_s,
            "grads": first_grads["grads"], "grad_norm": first_grads["norm"],
            "state": _numpy_state(state),
            "after_first": after_first, "masks": masks,
            "launches": launches,
            "place": (mesh.data_rank, mesh.model_rank)}


def vocoder_steps(rank, world, kwargs):
    """``train_vocoder(**kwargs, data_parallel=world)`` on this rank ->
    the generator's and the discriminators' state as numpy arrays, the
    log lines."""
    from fastspeech2_tpu_torch.training.vocoder import train_vocoder

    lines = []
    state = train_vocoder(**kwargs, data_parallel=world if world > 1
                          else None, log=lines.append)
    return {"gen": _numpy_state(state.gen.state_dict()),
            "disc": _numpy_state(state.disc.state_dict()), "log": lines}


def loop_steps(rank, world, kwargs):
    """``training.loop.train(**kwargs)`` on this rank of a (data, model)
    mesh (kwargs["data"], kwargs["model"]; kwargs["dropout"] False sets
    every dropout rate to 0) -> the log lines, the final step, whether
    this rank is the mesh's rank 0, each step's losses, the host seconds
    between updates, and the median host seconds of one preemption check
    (``parallel.mesh.agree``) after the run (None outside the mesh)."""
    from fastspeech2_tpu_torch.models.common import Dropout
    from fastspeech2_tpu_torch.parallel.mesh import agree, make_mesh
    from fastspeech2_tpu_torch.training import loop

    kwargs = dict(kwargs)
    mesh = make_mesh(kwargs.pop("data"), kwargs.pop("model"))
    build = loop.build_training

    def without_dropout(*args, **kw):
        model, opt = build(*args, **kw)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
        return model, opt

    lines, stamps, losses = [], [], []

    def hook(step, out):
        stamps.append(time.perf_counter())
        losses.append(torch.stack(list(out)))     # read after the run

    if not kwargs.pop("dropout", True):
        loop.build_training = without_dropout
    try:
        _, _, step = loop.train(**kwargs, mesh=mesh, log=lines.append,
                                step_hook=hook)
    finally:
        loop.build_training = build
    checks = []
    for _ in range(20 if mesh.active else 0):
        t0 = time.perf_counter()
        agree(False, mesh)
        checks.append(time.perf_counter() - t0)
    return {"log": lines, "step": step, "main": mesh.is_main,
            "losses": [t.float().cpu().numpy() for t in losses],
            "step_s": np.diff(stamps).tolist(),
            "agree_s": float(np.median(checks)) if checks else None}


def run_tasks(rank, world, tasks):
    """[(function name in this module, argument)] -> their results on this
    rank, in order (None where this rank sat outside a task's mesh)."""
    return [globals()[name](rank, world, arg) for name, arg in tasks]


def state_errors(got, ref, tol):
    """Two whole state dicts -> {"share": the share of parameter elements
    (ZERO_GRADIENT ones apart) off by more than ``tol`` of their tensor's
    largest |value| (floored at 1e-2), "far": the largest |difference| of
    those elements, "zero_gradient": the ZERO_GRADIENT parameters' largest
    |difference|, "running_var" and "running_mean": the largest error of
    a BatchNorm statistic over its tensor's largest |value| (floored at
    1e-2)}.  Adam divides each gradient element by its own size, so an
    element whose gradient sits at the summation noise may step either
    way: "far" is then bounded by the steps' learning rates."""
    out = dict.fromkeys(("share", "far", "zero_gradient", "running_var",
                         "running_mean"), 0.0)
    off = total = 0
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        diff = np.abs(got[k] - r)
        scale = max(float(np.abs(r).max()), 1e-2)
        if k.endswith(("running_var", "running_mean")):
            kind = "running_var" if k.endswith("var") else "running_mean"
            out[kind] = max(out[kind], float(diff.max()) / scale)
        elif any(re.fullmatch(p, k) for p in ZERO_GRADIENT):
            out["zero_gradient"] = max(out["zero_gradient"],
                                       float(diff.max()))
        else:
            far = diff > tol * scale
            off += int(far.sum())
            total += diff.size
            if far.any():
                out["far"] = max(out["far"], float(diff[far].max()))
    out["share"] = off / max(total, 1)
    return out
