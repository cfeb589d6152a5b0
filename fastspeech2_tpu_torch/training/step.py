"""Train and eval steps (port of ``fastspeech2_tpu/training/step.py``).

``train_step`` is the JAX ``make_train_step``'s function: forward, the six
losses, backward, gradients averaged over ``grad_acc_step`` micro-batches
(the PostNet's running statistics carried from one micro-batch to the
next), one optimizer update.  It runs the model in the mode the caller
set: the training loop sets ``model.train()``; the parity tests run it in
eval mode, where it is deterministic.  Dropout masks come from a
``torch.Generator`` on the batch's device, one a micro-batch, kept across
steps and seeded at each from the training seed, the step and the
micro-batch, as the JAX step folds its key on the step, so a resumed run
draws the same masks.

A step is the host's set-up (the generators seeded, the optimizer's
count advanced and its scalars written to the device) and then
:func:`step_body`, the device's part.  ``make_scanned_train_step``, the
counterpart of the JAX function of that name, runs scan mode's steps as
replays of a CUDA graph of that body, one per shape group.

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

import time
import weakref

import torch

from fastspeech2_tpu_torch.models.common import set_dropout_generator
from fastspeech2_tpu_torch.models.loss import LossOutput, fastspeech2_loss
from fastspeech2_tpu_torch.ops import cuda_attention, cuda_ffn, cuda_resblock
from fastspeech2_tpu_torch.ops.device_cache import keep_read
from fastspeech2_tpu_torch.parallel.comm import all_reduce, all_reduce_flat
from fastspeech2_tpu_torch.parallel.sharding import split_dim

TRAIN_SEED = 1234
# model -> {(device, micro-batch): its kept dropout generator}
_GENERATORS = weakref.WeakKeyDictionary()
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


def dropout_generators(model, device, n, step):
    """The generators of ``model``'s ``n`` micro-batches on ``device``,
    each seeded for ``step`` as a fresh one would be (:func:`dropout_seed`).
    They are made once and kept across steps: a CUDA graph of the step
    draws from the generators its capture saw, at the seed and offset they
    hold when it replays."""
    kept = _GENERATORS.setdefault(model, {})
    gens = []
    for i in range(n):
        gen = kept.get((device, i))
        if gen is None:
            gen = kept[(device, i)] = torch.Generator(device=device)
        gen.manual_seed(dropout_seed(step, i, model.mesh.data_rank))
        gens.append(gen)
    return gens


def _check_batch(batch, grad_acc_step):
    B = batch["texts"].shape[0]
    if B % grad_acc_step:
        raise ValueError(f"batch size {B} is not divisible by grad_acc_step "
                         f"{grad_acc_step}")


def step_body(model, optimizer, batch, generators):
    """The device's part of one update, after the host's set-up (the
    generators seeded, ``optimizer.advance()``): forward, losses and
    gradients of each micro-batch (one generator each), the data group's
    sum, the mean over micro-batches, the clip and Adam update -> the [6]
    losses, averaged over the micro-batches.  Nothing here reads a value
    back to the host or rebinds state, so this is what a CUDA graph of the
    step holds (:func:`make_scanned_train_step`)."""
    cfg, mesh = model.cfg, model.mesh
    params = optimizer.params
    acc = len(generators)
    micro_b = batch["texts"].shape[0] // acc
    grads = None
    loss_sum = None
    for i, gen in enumerate(generators):
        micro = {k: v[i * micro_b:(i + 1) * micro_b] for k, v in batch.items()}
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
    if acc > 1:
        grads = [g / acc for g in grads]
        loss_sum = loss_sum / acc
    norm = global_grad_norm(model, grads, mesh) if mesh.model > 1 else None
    optimizer.update(grads, norm=norm)
    return loss_sum


def train_step(model, optimizer, batch, step, grad_acc_step=1):
    """One optimizer update from ``batch`` (tensors on the model's device;
    under the model's mesh, this rank's rows); ``step`` is the number of
    updates done before this one.  Returns the LossOutput, averaged over
    the micro-batches, as detached tensors (the whole batch's, on every
    rank of a mesh)."""
    _check_batch(batch, grad_acc_step)
    gens = dropout_generators(model, batch["texts"].device, grad_acc_step,
                              step)
    optimizer.advance()
    return LossOutput(*step_body(model, optimizer, batch, gens).unbind(0))


def kernel_counts():
    """-> {kernel: its wrapper's launch count so far}, each dtype instance
    apart (the kernels a train step and its duties can run)."""
    return {"K1": cuda_attention.launches,
            "K1_bf16": cuda_attention.launches_bf16,
            "K2": cuda_ffn.launches, "K2_bf16": cuda_ffn.launches_bf16,
            "K3": cuda_attention.bwd_launches,
            "K3_bf16": cuda_attention.bwd_launches_bf16,
            "K4": cuda_resblock.launches}


class _StepGraph:
    """A captured step of one shape group: the graph, its losses output,
    the cached constants it reads, the launches its capture recorded and
    its replays."""

    def __init__(self, graph, losses, constants, launches):
        self.graph = graph
        self.losses = losses
        self.constants = constants
        self.launches = launches
        self.replays = 0


class ScannedTrainStep:
    """Scan mode's steps: :func:`make_scanned_train_step`'s result.

    Called as ``scanned(group, stack, index, step)``: one update on batch
    ``index`` of shape group ``group``'s ``stack`` ({key: [n, ...] tensor},
    ``training/loop.py::stack_group``), ``step`` being the updates done
    before it -> the LossOutput, as copies.  The batch is copied device to
    device into the group's static inputs, the generators are reseeded and
    ``optimizer.advance()`` writes the step's scalars; then :func:`step_body`
    runs on the static inputs.

    On a CUDA device that body is a CUDA graph, one per shape group, made
    the first time the group is drawn: its first step runs eagerly on a
    side stream (the warm-up: it builds the kernels, sets up cuBLAS and
    cuDNN on that stream and makes the position tables, and it is this
    step, so nothing is undone), then the body is captured on that stream;
    every later step of the group replays the graph.  The graphs share one
    memory pool and one side stream, since no two replay at once, and the
    losses are copied out after each replay.  The dropout generators are
    registered with each graph, which reads their seed and offset when it
    replays, so a replay draws the masks of a fresh generator with the
    step's seed.  A capture that fails raises.  On the CPU the body runs
    eagerly on the static inputs.

    The wrappers count their launches in Python, once at capture:
    :meth:`launches` is each graph's capture count times its replays, and
    ``captured_launches`` sums what the captures counted without running
    anything (the warm-up steps' launches are real ones)."""

    def __init__(self, model, optimizer, grad_acc_step=1):
        self.model = model
        self.optimizer = optimizer
        self.acc = grad_acc_step
        self.device = optimizer.params[0].device
        self.inputs = {}      # group -> static batch
        self.graphs = {}      # group -> _StepGraph
        self.pool = None
        self.stream = None
        self.capture_seconds = 0.0
        self.captured_launches = dict.fromkeys(kernel_counts(), 0)

    def __call__(self, group, stack, index, step):
        static = self.inputs.get(group)
        if static is None:
            _check_batch({k: v[0] for k, v in stack.items()}, self.acc)
            static = self.inputs[group] = {k: torch.empty_like(v[0])
                                           for k, v in stack.items()}
        for k, v in stack.items():
            static[k].copy_(v[index])
        gens = dropout_generators(self.model, self.device, self.acc, step)
        self.optimizer.advance()
        graph = self.graphs.get(group)
        if self.device.type != "cuda":
            losses = step_body(self.model, self.optimizer, static, gens)
        elif graph is None:
            losses = self._capture(group, static, gens)
        else:
            graph.graph.replay()
            graph.replays += 1
            losses = graph.losses
        return LossOutput(*losses.clone().unbind(0))

    def _capture(self, group, static, gens):
        """The warm-up step, then the capture -> the warm-up's losses."""
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError("a CUDA graph of the train step needs "
                               "torch.cuda.CUDAGraph.register_generator_state"
                               " (PyTorch 2.4 or later) for its dropout")
        t0 = time.perf_counter()
        dev = self.device
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
            self.pool = torch.cuda.graph_pool_handle()
        side, current = self.stream, torch.cuda.current_stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            losses = step_body(self.model, self.optimizer, static, gens)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for gen in gens:
            graph.register_generator_state(gen)
        before = kernel_counts()
        with keep_read() as constants, torch.cuda.graph(
                graph, pool=self.pool, stream=side,
                capture_error_mode="thread_local"):
            out = step_body(self.model, self.optimizer, static, gens)
        after = kernel_counts()
        current.wait_stream(side)
        launches = {k: after[k] - before[k] for k in after}
        for k, n in launches.items():
            self.captured_launches[k] += n
        self.graphs[group] = _StepGraph(graph, out, constants, launches)
        self.capture_seconds += time.perf_counter() - t0
        return losses

    def launches(self):
        """-> {kernel: launches the graphs' replays made}."""
        return {k: sum(g.launches[k] * g.replays
                       for g in self.graphs.values())
                for k in self.captured_launches}

    def pool_bytes(self):
        """The bytes of the card's memory the graphs' pool holds."""
        if self.pool is None:
            return 0
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) == tuple(self.pool))


def make_scanned_train_step(model, optimizer, grad_acc_step=1):
    """Scan mode's step runner, the port's counterpart of the JAX package's
    ``make_scanned_train_step`` (fastspeech2_tpu/training/step.py:122-151,
    K steps in one compiled dispatch over the device-resident stacks): on a
    card each step is a replay of a CUDA graph of :func:`step_body`, the
    body :func:`train_step` runs, so the host stays out of the step, and
    the numerics are the eager step's bit for bit (:class:`ScannedTrainStep`).
    ``training/loop.py::_train_scanned`` uses it with one process on a
    card; on the CPU and under a process group it runs ``train_step``
    eagerly instead."""
    return ScannedTrainStep(model, optimizer, grad_acc_step)


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
