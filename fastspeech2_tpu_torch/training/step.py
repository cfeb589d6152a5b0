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

Under the model's ``parallel.Mesh`` the batch is this rank's rows of each
micro-batch.  The losses are this rank's shares of the whole micro-batch's
means (``models/loss.py``): their gradients are summed over the data group
in one collective, so every rank applies the one-process update on the
whole batch.  The clip takes the global norm over both groups: the sharded
parameters' squares summed over the model group, the replicated ones
counted once.  The dropout seed adds the data rank, so data ranks draw
different masks for their different rows, while the ranks of one model
group draw the same masks on the same replicated activations.
"""

import torch

from fastspeech2_tpu_torch.models.common import set_dropout_generator
from fastspeech2_tpu_torch.models.loss import LossOutput, fastspeech2_loss
from fastspeech2_tpu_torch.parallel.comm import all_reduce, all_reduce_flat
from fastspeech2_tpu_torch.parallel.sharding import split_dim

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


def apply_model(model, cfg, batch, row_keep=None, data_group=None):
    """Teacher-forced forward + losses -> (LossOutput, FastSpeech2Output).
    Mels that arrive as bfloat16 are upcast to float32 on the device first:
    the loss targets are float32 (fastspeech2_tpu/training/step.py:20-24).
    ``data_group``: the losses are this rank's shares (models/loss.py)."""
    if batch["mels"].dtype != torch.float32:
        batch = dict(batch, mels=batch["mels"].float())
    out = model(batch["speakers"], batch["texts"], batch["src_lens"],
                mel_lens=batch["mel_lens"],
                max_mel_len=batch["mels"].shape[1],
                p_targets=batch["pitches"], e_targets=batch["energies"],
                d_targets=batch["durations"])
    losses = fastspeech2_loss(cfg, out, batch["mels"], batch["pitches"],
                              batch["energies"], batch["durations"],
                              row_keep=row_keep, data_group=data_group)
    return losses, out


def dropout_seed(step, micro=0, data_rank=0):
    """A generator seed for (the training seed, step, micro-batch, data
    rank); data rank 0 draws what a one-process run draws."""
    seed = ((TRAIN_SEED * 1_000_003 + step) * 1_009 + micro) % (1 << 63)
    return seed ^ (data_rank * 0x9E3779B97F4A7C15 % (1 << 63))


def global_grad_norm(model, grads, mesh):
    """The norm of the whole model's gradient from this rank's shard:
    split parameters' squares summed over the model group, replicated
    ones counted once."""
    split = [split_dim(name) is not None
             for name, _ in model.named_parameters()]
    zero = grads[0].new_zeros(())
    sq_split = sum(((g.float() * g.float()).sum()
                    for g, s in zip(grads, split) if s), zero)
    sq_repl = sum(((g.float() * g.float()).sum()
                   for g, s in zip(grads, split) if not s), zero)
    return torch.sqrt(all_reduce(sq_split, mesh.model_group) + sq_repl)


def train_step(model, optimizer, batch, step, grad_acc_step=1):
    """One optimizer update from ``batch`` (tensors on the model's device;
    under the model's mesh, this rank's rows); ``step`` is the number of
    updates done before this one.  Returns the LossOutput, averaged over
    the micro-batches, as detached tensors (the whole batch's, on every
    rank of a mesh)."""
    cfg, mesh = model.cfg, model.mesh
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
        gen.manual_seed(dropout_seed(step, i, mesh.data_rank))
        set_dropout_generator(model, gen)
        losses, _ = apply_model(model, cfg, micro,
                                data_group=mesh.data_group)
        g = torch.autograd.grad(losses.total, params, allow_unused=True)
        g = [torch.zeros_like(p) if gi is None else gi
             for gi, p in zip(g, params)]
        vals = torch.stack([v.detach() for v in losses])
        if grads is None:
            grads, loss_sum = g, vals
        else:
            grads = [a + b for a, b in zip(grads, g)]
            loss_sum = loss_sum + vals
    if mesh.data > 1:
        grads = all_reduce_flat(grads, mesh.data_group)
        loss_sum = all_reduce(loss_sum, mesh.data_group)
    if grad_acc_step > 1:
        grads = [g / grad_acc_step for g in grads]
        loss_sum = loss_sum / grad_acc_step
    norm = global_grad_norm(model, grads, mesh) if mesh.model > 1 else None
    optimizer.step(grads, norm=norm)
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
