"""Checkpoints of the port's training state (the port's counterpart of
``fastspeech2_tpu/training/checkpoint.py`` and ``train_state.py``).

One ``torch.save`` file per saved step, ``<ckpt_path>/<step>.pth.tar``
(the upstream reference's name).  The acoustic trainer's holds the
model's state dict (parameters and the PostNet's BatchNorm buffers), the
optimizer's state and the step, so ``--restore_step`` resumes the model
and the Noam schedule together.  The vocoder trainer's
(:func:`save_vocoder_checkpoint`) holds the generator's and the
discriminators' state dicts, both optimizers' states (counts included),
the step and the generator's config.  The JAX package's orbax checkpoints
(directories ``<ckpt_path>/<step>/``) are not read: their layout needs
orbax, which the port does not use.
"""

import os
import re

import torch

_NAME = re.compile(r"^(\d+)\.pth\.tar$")


def checkpoint_path(ckpt_dir, step):
    return os.path.join(ckpt_dir, f"{int(step)}.pth.tar")


def save_checkpoint(ckpt_dir, model, optimizer, step):
    """Write ``<ckpt_dir>/<step>.pth.tar`` atomically; returns its path."""
    return save_checkpoint_state(
        ckpt_dir, model.state_dict(),
        None if optimizer is None else optimizer.state_dict(), step)


def save_checkpoint_state(ckpt_dir, model_state, optimizer_state, step):
    """:func:`save_checkpoint` from the two state dicts (a sharded trainer
    gathers them first)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    return _save(path, {"model": model_state, "step": int(step),
                        "optimizer": optimizer_state})


def _save(path, state):
    tmp = path + ".partial"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def save_vocoder_checkpoint(out_dir, state, step):
    """Write the vocoder train state (``training.vocoder.VocoderTrainState``)
    as ``<out_dir>/<step>.pth.tar`` atomically: ``generator``,
    ``discriminators``, ``gen_optimizer``, ``disc_optimizer``, ``step`` and
    ``generator_config`` (from which ``synthesis.vocoder.get_vocoder``
    rebuilds the generator); returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    return _save(checkpoint_path(out_dir, step), {
        "generator": state.gen.state_dict(),
        "discriminators": state.disc.state_dict(),
        "gen_optimizer": state.gen_opt.state_dict(),
        "disc_optimizer": state.disc_opt.state_dict(),
        "step": int(step), "generator_config": state.generator_config})


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


def latest_step(ckpt_dir):
    """The highest step with a checkpoint in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir))
             if m]
    return max(steps) if steps else None
