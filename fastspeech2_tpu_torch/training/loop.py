"""Training orchestration (port of ``fastspeech2_tpu/training/loop.py``).

Builds the model and optimizer, runs :func:`training.step.train_step` over
bucketed batches and does the periodic duties: the loss line every
log_step, a validation pass every val_step, a checkpoint every save_step,
a checkpoint on SIGTERM/SIGUSR1 (preemption) and at the end.  Lines go to
``log`` and to ``<log_path>/{train,val}/log.txt``.

Not ported yet: the synth_step duty (``synth_one_sample``'s figure and
audio), TensorBoard output and ``profile_dir``.  ``scan_step > 1`` (the JAX
package's device-resident scan over K steps) runs the per-step path, whose
numerics are the same (fastspeech2_tpu/training/step.py:122-140).
"""

import os
import signal
import threading
import time

import numpy as np
import torch

from fastspeech2_tpu_torch.configs.config import (
    FastSpeech2Config,
    OptimConfig,
    StepConfig,
)
from fastspeech2_tpu_torch.data.dataset import BucketedLoader, FeatureDataset
from fastspeech2_tpu_torch.data.prefetch import PrefetchIterator
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_tpu_torch.training.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from fastspeech2_tpu_torch.training.optim import NoamAdam
from fastspeech2_tpu_torch.training.step import (
    TRAIN_SEED,
    batch_to_device,
    eval_step,
    train_step,
)

LOSS_NAMES = ("Total Loss", "Mel Loss", "Mel PostNet Loss", "Pitch Loss",
              "Energy Loss", "Duration Loss")


def loss_line(prefix, vals):
    """'<prefix>, Total Loss: x, Mel Loss: x, ...' as the JAX loop logs."""
    return prefix + ", " + ", ".join(
        f"{n}: {v:.4f}" for n, v in zip(LOSS_NAMES, vals))


class _TextLog:
    """Appends lines to <path>/log.txt."""

    def __init__(self, path):
        os.makedirs(path, exist_ok=True)
        self.path = os.path.join(path, "log.txt")

    def message(self, text):
        with open(self.path, "a") as f:
            f.write(text + "\n")


def init_training(preprocess_config, model_config, train_config,
                  restore_step=0, device="cuda", seed=TRAIN_SEED,
                  dtype=torch.float32):
    """-> (model, cfg, optim_cfg, optimizer), the model on ``device`` at
    the compute ``dtype`` with weights drawn from ``seed`` or restored from
    ``restore_step``."""
    cfg = FastSpeech2Config.build(preprocess_config, model_config)
    optim_cfg = OptimConfig.build(train_config)
    # a step is reproducible on the card: cuDNN takes its deterministic
    # convolution algorithms, untuned (its float32 weight-gradient
    # algorithms may otherwise sum in another order from run to run)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = FastSpeech2(cfg, dtype=dtype)
    model.to(device)
    optimizer = NoamAdam(model.parameters(), optim_cfg, cfg.encoder_hidden)
    if restore_step:
        restore_checkpoint(train_config["path"]["ckpt_path"], restore_step,
                           model, optimizer)
    return model, cfg, optim_cfg, optimizer


def evaluate(model, val_dataset, batch_size, cfg, device):
    """Sample-weighted mean validation losses in eval mode, the loader's
    duplicate rows left out (fastspeech2_tpu/training/loop.py:538-551)."""
    loader = BucketedLoader(val_dataset, batch_size=batch_size, group_size=1,
                            shuffle=False, drop_last=False,
                            max_mel_len=cfg.max_seq_len)
    was_training = model.training
    model.eval()
    sums = np.zeros(6)
    count = 0
    try:
        for batch in loader.epoch(0):
            n = batch.get("valid_count", batch["texts"].shape[0])
            losses = eval_step(model, batch_to_device(batch, device), n)
            sums += np.asarray(torch.stack(list(losses)).tolist()) * n
            count += n
    finally:
        model.train(was_training)
    return (sums / max(count, 1)).tolist()


def train(preprocess_config, model_config, train_config, restore_step=0,
          dtype=torch.float32, max_steps=None, log=print, device="cuda",
          step_hook=None):
    """The reference's main() loop (train.py:21-169) on ``device`` at the
    compute ``dtype`` (parameters and optimizer state stay float32).

    step_hook: called as step_hook(step, losses) after every update (for
    measurements).  Returns (model, optimizer, step).
    """
    device = torch.device(device)
    steps = StepConfig.build(train_config)
    total_step = min(steps.total_step, max_steps or steps.total_step)
    model, cfg, optim_cfg, optimizer = init_training(
        preprocess_config, model_config, train_config, restore_step,
        device=device, dtype=dtype)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"Number of FastSpeech2 Parameters: {n_params}")

    dataset = FeatureDataset("train.txt", preprocess_config)
    bucket_cfg = train_config.get("bucket", {})
    loader = BucketedLoader(
        dataset, batch_size=optim_cfg.batch_size, group_size=4,
        shuffle=True, drop_last=True, max_mel_len=cfg.max_seq_len,
        text_bucket=bucket_cfg.get("text", 32),
        mel_bucket=bucket_cfg.get("mel", 160))
    val_dataset = FeatureDataset("val.txt", preprocess_config)
    logger = _TextLog(os.path.join(train_config["path"]["log_path"],
                                   "train"))
    val_logger = _TextLog(os.path.join(train_config["path"]["log_path"],
                                       "val"))
    ckpt_dir = train_config["path"]["ckpt_path"]

    acc = optim_cfg.grad_acc_step
    if optim_cfg.batch_size % acc:
        raise ValueError(f"batch_size {optim_cfg.batch_size} must be "
                         f"divisible by grad_acc_step {acc}")
    scan_step = int(train_config["step"].get("scan_step", 1))
    if scan_step > 1:
        log(f"scan_step {scan_step}: the port runs the per-step path (the "
            "same numerics, one update per batch)")
    if steps.synth_step <= total_step:
        log("synth_step: the synthesized-sample duty is not ported yet; "
            "skipped")

    preempted = threading.Event()

    def _on_preempt(signum, frame):
        log(f"Received signal {signum}: checkpointing at the next step "
            "boundary")
        preempted.set()

    installed = []
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            installed.append((sig, signal.signal(sig, _on_preempt)))

    t0 = t_rate = time.time()
    frames_done = 0

    def run_duties(step, losses, frames):
        nonlocal frames_done, t_rate
        frames_done += frames
        if step % steps.log_step == 0:
            vals = torch.stack(list(losses)).tolist()
            now = time.time()
            rate = frames_done / max(now - t_rate, 1e-6)
            frames_done, t_rate = 0, now
            msg = loss_line(f"Step {step}/{total_step}", vals)
            log(msg + f" ({now - t0:.1f}s, {rate:.0f} mel frames/s)")
            logger.message(msg)
        if step % steps.val_step == 0:
            vals = evaluate(model, val_dataset, optim_cfg.batch_size, cfg,
                            device)
            msg = loss_line(f"Validation Step {step}", vals)
            log(msg)
            val_logger.message(msg)
        if step % steps.save_step == 0:
            save_checkpoint(ckpt_dir, model, optimizer, step)
            log(f"Saved checkpoint at step {step}")

    mel_bf16 = bool(train_config.get("transfer", {}).get("mel_bf16",
                                                         False))

    def to_device(batch):
        return batch, batch_to_device(batch, device, mel_bf16)

    step = restore_step
    epoch = epoch_batches = 0
    model.train()
    try:
        while step < total_step and not preempted.is_set():
            if epoch and epoch_batches == 0:
                raise ValueError(
                    f"train.txt gives no batch of {optim_cfg.batch_size} "
                    "(the loader drops the last partial batch)")
            epoch_batches = 0
            for batch, device_batch in PrefetchIterator(
                    loader.epoch(epoch), depth=2, transform=to_device):
                if step >= total_step:
                    break
                if preempted.is_set():
                    save_checkpoint(ckpt_dir, model, optimizer, step)
                    log(f"Preemption checkpoint saved at step {step}")
                    break
                losses = train_step(model, optimizer, device_batch, step,
                                    grad_acc_step=acc)
                step += 1
                epoch_batches += 1
                if step_hook is not None:
                    step_hook(step, losses)
                run_duties(step, losses, int(batch["mel_lens"].sum()))
            epoch += 1
    finally:
        for sig, prev in installed:
            signal.signal(sig, prev)
    save_checkpoint(ckpt_dir, model, optimizer, step)
    return model, optimizer, step

