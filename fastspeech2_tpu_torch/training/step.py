"""Train and eval steps (port of ``fastspeech2_tpu/training/step.py``).

``train_step`` is the JAX ``make_train_step``'s function: forward, the six
losses, backward, gradients averaged over ``grad_acc_step`` micro-batches
(the PostNet's running statistics carried from one micro-batch to the
next), one optimizer update.  It runs the model in the mode the caller
set: the training loop sets ``model.train()``; the parity tests run it in
eval mode, where it is deterministic.  Dropout masks come from a
``torch.Generator`` on the batch's device seeded from the training seed,
the step and the micro-batch, as the JAX step folds its key on the step,
so a resumed run draws the same masks.
"""

import torch

from fastspeech2_tpu_torch.models.common import set_dropout_generator
from fastspeech2_tpu_torch.models.loss import LossOutput, fastspeech2_loss

TRAIN_SEED = 1234
BATCH_KEYS = ("speakers", "texts", "src_lens", "mels", "mel_lens",
              "pitches", "energies", "durations")


def batch_to_device(batch, device, mel_bf16=False):
    """The model's arrays of a loader batch -> tensors on ``device``
    (integer arrays as int64, float arrays as float32; with ``mel_bf16``
    the mels rounded to bfloat16 on the host and sent as bfloat16, train.yaml
    ``transfer: {mel_bf16: true}``, fastspeech2_tpu/training/loop.py:263-276)."""
    out = {}
    for key in BATCH_KEYS:
        t = torch.as_tensor(batch[key])
        if not t.is_floating_point():
            t = t.long()
        else:
            t = t.to(torch.bfloat16 if mel_bf16 and key == "mels"
                     else torch.float32)
        out[key] = t.to(device, non_blocking=True)
    return out


def apply_model(model, cfg, batch, row_keep=None):
    """Teacher-forced forward + losses -> (LossOutput, FastSpeech2Output).
    Mels that arrive as bfloat16 are upcast to float32 on the device first:
    the loss targets are float32 (fastspeech2_tpu/training/step.py:20-24)."""
    if batch["mels"].dtype != torch.float32:
        batch = dict(batch, mels=batch["mels"].float())
    out = model(batch["speakers"], batch["texts"], batch["src_lens"],
                mel_lens=batch["mel_lens"],
                max_mel_len=batch["mels"].shape[1],
                p_targets=batch["pitches"], e_targets=batch["energies"],
                d_targets=batch["durations"])
    losses = fastspeech2_loss(cfg, out, batch["mels"], batch["pitches"],
                              batch["energies"], batch["durations"],
                              row_keep=row_keep)
    return losses, out


def dropout_seed(step, micro=0):
    """A generator seed for (the training seed, step, micro-batch)."""
    return ((TRAIN_SEED * 1_000_003 + step) * 1_009 + micro) % (1 << 63)


def train_step(model, optimizer, batch, step, grad_acc_step=1):
    """One optimizer update from ``batch`` (tensors on the model's device);
    ``step`` is the number of updates done before this one.  Returns the
    LossOutput, averaged over the micro-batches, as detached tensors."""
    cfg = model.cfg
    params = optimizer.params
    B = batch["texts"].shape[0]
    if B % grad_acc_step:
        raise ValueError(f"batch size {B} is not divisible by grad_acc_step "
                         f"{grad_acc_step}")
    micro_b = B // grad_acc_step
    device = batch["texts"].device
    grads = None
    loss_sum = None
    for i in range(grad_acc_step):
        micro = {k: v[i * micro_b:(i + 1) * micro_b] for k, v in batch.items()}
        gen = torch.Generator(device=device)
        gen.manual_seed(dropout_seed(step, i))
        set_dropout_generator(model, gen)
        losses, _ = apply_model(model, cfg, micro)
        g = torch.autograd.grad(losses.total, params, allow_unused=True)
        g = [torch.zeros_like(p) if gi is None else gi
             for gi, p in zip(g, params)]
        vals = torch.stack([v.detach() for v in losses])
        if grads is None:
            grads, loss_sum = g, vals
        else:
            grads = [a + b for a, b in zip(grads, g)]
            loss_sum = loss_sum + vals
    if grad_acc_step > 1:
        grads = [g / grad_acc_step for g in grads]
        loss_sum = loss_sum / grad_acc_step
    optimizer.step(grads)
    return LossOutput(*loss_sum.unbind(0))


@torch.no_grad()
def eval_step(model, batch, valid_count=None):
    """Teacher-forced losses in the model's current mode (the caller sets
    ``model.eval()``); ``valid_count`` rows are real, the rest are the
    loader's duplicates of the last row and are left out of every mean."""
    row_keep = None
    if valid_count is not None:
        b = batch["texts"].shape[0]
        row_keep = torch.arange(b, device=batch["texts"].device) < valid_count
    losses, _ = apply_model(model, model.cfg, batch, row_keep=row_keep)
    return losses
