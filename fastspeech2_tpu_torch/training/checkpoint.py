"""Checkpoints of the port's training state (the port's counterpart of
``fastspeech2_tpu/training/checkpoint.py`` and ``train_state.py``).

One ``torch.save`` file per saved step, ``<ckpt_path>/<step>.pth.tar``
(the upstream reference's name), holding the model's state dict
(parameters and the PostNet's BatchNorm buffers), the optimizer's state
and the step, so ``--restore_step`` resumes the model and the Noam
schedule together.  The JAX package's orbax checkpoints (directories
``<ckpt_path>/<step>/``) are not read: their layout needs orbax, which the
port does not use.
"""

import os
import re

import torch

_NAME = re.compile(r"^(\d+)\.pth\.tar$")


def checkpoint_path(ckpt_dir, step):
    return os.path.join(ckpt_dir, f"{int(step)}.pth.tar")


def save_checkpoint(ckpt_dir, model, optimizer, step):
    """Write ``<ckpt_dir>/<step>.pth.tar`` atomically; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    state = {"model": model.state_dict(), "step": int(step),
             "optimizer": None if optimizer is None
             else optimizer.state_dict()}
    tmp = path + ".partial"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(ckpt_dir, step):
    """The dict :func:`save_checkpoint` wrote for ``step``."""
    path = checkpoint_path(ckpt_dir, step)
    if not os.path.exists(path):
        orbax = os.path.join(ckpt_dir, str(int(step)))
        if os.path.isdir(orbax):
            raise ValueError(
                f"{orbax} is an orbax checkpoint of the JAX package; the "
                "PyTorch port reads only its own <step>.pth.tar checkpoints")
        raise FileNotFoundError(f"no checkpoint for step {step}: {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(ckpt_dir, step, model, optimizer=None):
    """Load the model (strictly) and, when given, the optimizer from the
    checkpoint of ``step``; returns the saved step."""
    state = load_checkpoint(ckpt_dir, step)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        if state["optimizer"] is None:
            raise ValueError(f"checkpoint {step} holds no optimizer state")
        optimizer.load_state_dict(state["optimizer"])
    return state["step"]


def latest_step(ckpt_dir):
    """The highest step with a checkpoint in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir))
             if m]
    return max(steps) if steps else None
