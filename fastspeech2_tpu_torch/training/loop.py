"""Training orchestration (port of ``fastspeech2_tpu/training/loop.py``).

Builds the model and optimizer, runs :func:`training.step.train_step` over
bucketed batches and does the periodic duties: the loss line and the
TensorBoard scalars every log_step, one synthesized sample every
synth_step (:func:`synth_one_sample`: the mel figure and, with a vocoder,
the reconstructed and synthesized wavs), a validation pass every val_step
(with one validation sample's figure), a checkpoint every save_step, a
checkpoint on SIGTERM/SIGUSR1 (preemption) and at the end.  Lines go to
``log`` and to ``<log_path>/{train,val}/log.txt``; figures, audio and
scalars to TensorBoard through :class:`utils.logging.TrainLogger`.
``profile_dir`` records a ``torch.profiler`` trace of the 11th to 20th
steps of the run.
``step.scan_step`` > 1 is the JAX package's scan mode
(fastspeech2_tpu/training/loop.py:429-535; the schedule in
``training/scan.py``): epoch 0's batches, grouped by shape, go to the
device once as stacks; K steps a dispatch (the gcd of scan_step and the
duty periods below total_step) each take a batch of one group's stack in
the JAX loop's order and run the eager ``train_step``; the duties run
once a dispatch, on the group's first batch.  K <= 1, or an epoch over
``step.scan_hbm_budget_mb``, logs the JAX line and takes the per-step path.

Data and tensor parallel (``mesh``, ``parallel/``): one process per rank,
each building the same loader from the same seed and taking its
contiguous rows of every micro-batch of the same global batch.  Under an
initialised world of N ranks and no mesh given, the data axis is
gcd(micro-batch, N) and the model axis 1, as the JAX loop lays its mesh
(fastspeech2_tpu/training/loop.py:69-78); ranks beyond the mesh idle.
Tensor parallel is reached, as in the JAX package, only by passing
``mesh=parallel.make_mesh(data, model)``.  Every rank runs the duties'
forwards (a sharded model needs its whole model group), rank 0 alone
draws the figures, vocodes the samples and writes log.txt, TensorBoard
and the checkpoints, which hold the whole model whatever the layout.
The preemption flag is agreed over the grid at every step (every
dispatch in scan mode), on the host (``parallel.mesh.agree``).
"""

import math
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
from fastspeech2_tpu_torch.parallel.mesh import SINGLE, agree, make_mesh
from fastspeech2_tpu_torch.parallel.sharding import (
    shard_optimizer_state,
    shard_state_dict,
    unshard_optimizer_state,
    unshard_state_dict,
)
from fastspeech2_tpu_torch.training import scan
from fastspeech2_tpu_torch.training.checkpoint import (
    load_checkpoint,
    save_checkpoint_state,
)
from fastspeech2_tpu_torch.training.optim import NoamAdam
from fastspeech2_tpu_torch.training.step import (
    BATCH_KEYS,
    TRAIN_SEED,
    batch_to_device,
    eval_step,
    train_step,
)
from fastspeech2_tpu_torch.utils.logging import TrainLogger

LOSS_NAMES = ("Total Loss", "Mel Loss", "Mel PostNet Loss", "Pitch Loss",
              "Energy Loss", "Duration Loss")


def loss_line(prefix, vals):
    """'<prefix>, Total Loss: x, Mel Loss: x, ...' as the JAX loop logs."""
    return prefix + ", " + ", ".join(
        f"{n}: {v:.4f}" for n, v in zip(LOSS_NAMES, vals))


def init_training(preprocess_config, model_config, train_config,
                  restore_step=0, device="cuda", seed=TRAIN_SEED,
                  dtype=torch.float32, mesh=SINGLE):
    """-> (model, cfg, optim_cfg, optimizer), the model on ``device`` at
    the compute ``dtype`` with weights drawn from ``seed`` or restored from
    ``restore_step`` (:func:`build_training`)."""
    cfg = FastSpeech2Config.build(preprocess_config, model_config)
    optim_cfg = OptimConfig.build(train_config)
    saved = (load_checkpoint(train_config["path"]["ckpt_path"], restore_step)
             if restore_step else None)
    if saved and saved["optimizer"] is None:
        raise ValueError(f"checkpoint {restore_step} holds no optimizer "
                         "state")
    model, optimizer = build_training(
        cfg, optim_cfg, device, seed, dtype, mesh,
        state=saved["model"] if saved else None,
        opt_state=saved["optimizer"] if saved else None)
    return model, cfg, optim_cfg, optimizer


def build_training(cfg, optim_cfg, device="cuda", seed=TRAIN_SEED,
                   dtype=torch.float32, mesh=SINGLE, state=None,
                   opt_state=None):
    """-> (model, optimizer).  The whole model's weights are drawn from
    ``seed``, or taken from ``state`` (a whole state dict), on every rank
    and then cut to this rank's shard of the ``mesh``; the optimizer
    starts fresh or from ``opt_state`` (a whole optimizer state dict)."""
    # a step is reproducible on the card: cuDNN takes its deterministic
    # convolution algorithms, untuned (its float32 weight-gradient
    # algorithms may otherwise sum in another order from run to run)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = FastSpeech2(cfg, dtype=dtype)
        whole = state if state is not None else model.state_dict()
        if mesh.size > 1:
            model = FastSpeech2(cfg, dtype=dtype, mesh=mesh)
    if state is not None or mesh.size > 1:
        model.load_state_dict(shard_state_dict(whole, mesh.model_rank,
                                               mesh.model))
    model.to(device)
    optimizer = NoamAdam(model.parameters(), optim_cfg, cfg.encoder_hidden)
    if opt_state is not None:
        optimizer.load_state_dict(shard_optimizer_state(
            opt_state, _param_names(model), mesh.model_rank, mesh.model))
    return model, optimizer


def _param_names(model):
    return [name for name, _ in model.named_parameters()]


def save_training_state(ckpt_dir, model, optimizer, step, mesh=SINGLE):
    """The whole model's checkpoint of ``step``, gathered from the model
    group's shards and written by rank 0 of the mesh alone."""
    state = unshard_state_dict(model.state_dict(), mesh.model_rank,
                               mesh.model, mesh.model_group)
    opt_state = unshard_optimizer_state(
        optimizer.state_dict(), _param_names(model), mesh.model_rank,
        mesh.model, mesh.model_group)
    if mesh.is_main:
        save_checkpoint_state(ckpt_dir, state, opt_state, step)


def default_mesh(optim_cfg):
    """The JAX loop's mesh: over an initialised world of N ranks, a data
    axis of gcd(micro-batch, N) and a model axis of 1; one process
    otherwise."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return SINGLE
    micro = max(optim_cfg.batch_size // max(optim_cfg.grad_acc_step, 1), 1)
    return make_mesh(data=math.gcd(micro, dist.get_world_size()), model=1)


def rank_rows(batch, mesh, grad_acc_step):
    """This rank's rows of a loader batch: its contiguous 1/data of each
    of the ``grad_acc_step`` micro-batches, in order (the host-only
    fields too), so that train_step's micro-batches are this rank's
    shares of the global ones."""
    if mesh.data == 1:
        return batch
    B = batch["texts"].shape[0]
    micro = B // grad_acc_step
    if micro % mesh.data:
        raise ValueError(f"micro-batch {micro} does not split over a data "
                         f"axis of {mesh.data}")
    n = micro // mesh.data
    idx = np.concatenate([np.arange(i * micro + mesh.data_rank * n,
                                    i * micro + (mesh.data_rank + 1) * n)
                          for i in range(grad_acc_step)])
    return {k: (v[idx] if isinstance(v, np.ndarray) and v.ndim
                and v.shape[0] == B else
                [v[i] for i in idx] if isinstance(v, list) else v)
            for k, v in batch.items()}


def train_loader(preprocess_config, train_config, cfg, batch_size):
    """train.txt's shuffled, bucketed loader, the last partial batch
    dropped (train.yaml ``bucket: {text, mel}``, default 32 and 160)."""
    bucket_cfg = train_config.get("bucket", {})
    return BucketedLoader(
        FeatureDataset("train.txt", preprocess_config), batch_size=batch_size,
        group_size=4, shuffle=True, drop_last=True,
        max_mel_len=cfg.max_seq_len, text_bucket=bucket_cfg.get("text", 32),
        mel_bucket=bucket_cfg.get("mel", 160))


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


def synth_one_sample(model, batch, preprocess_config, vocoder=None,
                     log=print, figure=True):
    """The first row of a loader batch through the model in eval mode,
    teacher-forced on its durations, pitch and energy (reference
    utils/tools.py:109-161; fastspeech2_tpu/training/loop.py:101-160) ->
    (figure of the synthesized and ground-truth mels, the reconstructed
    wav, the synthesized wav).

    The wavs are None without a vocoder.  The figure is None with
    ``figure`` False (a rank that writes nothing runs the forward alone,
    for its model group's collectives), and, with one line saying so,
    where matplotlib is not installed: that is the only failure this
    function absorbs.  A fault of the forward or the vocoder raises.
    """
    from fastspeech2_tpu_torch.synthesis.plotting import (
        expand_by_duration,
        plot_mel,
        plot_stats,
    )
    from fastspeech2_tpu_torch.synthesis.vocoder import vocoder_infer

    device = next(model.parameters()).device
    row = batch_to_device({k: batch[k][:1] for k in BATCH_KEYS}, device)
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            out = model(row["speakers"], row["texts"], row["src_lens"],
                        mel_lens=row["mel_lens"],
                        max_mel_len=batch["mels"].shape[1],
                        p_targets=row["pitches"], e_targets=row["energies"],
                        d_targets=row["durations"])
    finally:
        model.train(was_training)
    mel_len = int(out.mel_len[0])
    src_len = int(batch["src_lens"][0])
    mel_pred = out.postnet_mel[0, :mel_len].float().cpu().numpy().T
    mel_target = np.asarray(batch["mels"][0, :mel_len], np.float32).T
    duration = batch["durations"][0, :src_len]
    pp = preprocess_config["preprocessing"]
    pitch = batch["pitches"][0]
    energy = batch["energies"][0]
    if pp["pitch"]["feature"] == "phoneme_level":
        pitch = expand_by_duration(pitch[:src_len], duration)
    else:
        pitch = pitch[:mel_len]
    if pp["energy"]["feature"] == "phoneme_level":
        energy = expand_by_duration(energy[:src_len], duration)
    else:
        energy = energy[:mel_len]
    fig = None
    if figure:
        try:
            fig = plot_mel(
                [(mel_pred, pitch, energy), (mel_target, pitch, energy)],
                plot_stats(preprocess_config),
                ["Synthesized Spectrogram", "Ground-Truth Spectrogram"])
        except ImportError:
            log("matplotlib is not installed: the synthesized sample's mel "
                "figure is not drawn")

    wav_reconstruction = wav_prediction = None
    if vocoder is not None:
        wav_reconstruction = vocoder_infer(
            row["mels"], vocoder, preprocess_config, lengths=[mel_len])[0]
        # upcast first, as the JAX loop does: a bfloat16 mel would reach
        # MelGAN's division by ln 10 and Griffin-Lim's exp in bfloat16
        wav_prediction = vocoder_infer(
            out.postnet_mel[:1].float(), vocoder, preprocess_config,
            lengths=[mel_len])[0]
    return fig, wav_reconstruction, wav_prediction


def log_sample(logger, tag, sample, sampling_rate):
    """A synth_one_sample result to the logger: the figure under ``tag``,
    the wavs under ``tag``_reconstructed and ``tag``_synthesized."""
    fig, wav_rec, wav_pred = sample
    if fig is not None:
        from matplotlib import pyplot as plt

        logger.figure(tag, fig)
        plt.close(fig)
    if wav_rec is not None:
        logger.audio(f"{tag}_reconstructed", wav_rec.astype(np.float32),
                     sampling_rate)
        logger.audio(f"{tag}_synthesized", wav_pred.astype(np.float32),
                     sampling_rate)


def _silent(*_):
    pass


def _no_batch(batch_size):
    return ValueError(f"train.txt gives no batch of {batch_size} (the "
                      "loader drops the last partial batch)")


def stack_group(batches, mesh, acc, device, mel_bf16=False):
    """A shape group's loader batches -> {key: [n, rows, ...] tensor on
    ``device``}: this rank's rows of each batch (:func:`rank_rows`), in
    ``batch_to_device``'s dtypes, as the JAX loop shards its stacks over
    the data axis (fastspeech2_tpu/training/loop.py:486-494)."""
    rows = [rank_rows(b, mesh, acc) for b in batches]
    return batch_to_device({k: np.stack([r[k] for r in rows])
                            for k in BATCH_KEYS}, device, mel_bf16)


def _train_scanned(scan_step, step, total_step, steps, loader, model,
                   optimizer, acc, mesh, device, mel_bf16, budget_bytes,
                   run_duties, preempted, step_hook, profile_dir, log):
    """Scan mode (fastspeech2_tpu/training/loop.py::_train_scanned,
    :429-535) from ``step`` -> the step it stopped at: at total_step, at a
    dispatch's end on preemption, or where it started when scan mode does
    not apply (K <= 1, or epoch 0 over the budget; the JAX line says
    which).  Each step of a dispatch indexes a stack on the device (no
    host-to-device copy) and runs the eager ``train_step``; the duties
    run once a dispatch, on the group's first batch, with the last step's
    losses and the dispatch's summed mel frames."""
    K = scan.dispatch_steps(scan_step, (steps.log_step, steps.synth_step,
                                        steps.val_step, steps.save_step),
                            total_step)
    if K <= 1:
        log(scan.INCOMPATIBLE_LINE)
        return step
    groups = scan.gather_epoch(loader.epoch(0), budget_bytes, mel_bf16)
    if groups is None:
        log(scan.budget_line(budget_bytes))
        return step
    if not groups:
        raise _no_batch(loader.batch_size)
    stacks = [stack_group(g, mesh, acc, device, mel_bf16) for g in groups]
    frames = [np.array([int(b["mel_lens"].sum()) for b in g])
              for g in groups]
    log(f"scan mode: {sum(map(len, groups))} batches in {len(groups)} shape "
        f"group(s) device-resident, {K} steps/dispatch")
    nbytes = sum(t.numel() * t.element_size()
                 for s in stacks for t in s.values())
    log(f"scan mode stacks: {nbytes} bytes on {device}")
    if profile_dir:
        log("scan mode records no profile (as the JAX package's scanned "
            f"path): {profile_dir} stays empty")
    plan = scan.Schedule([len(g) for g in groups], step)
    while step < total_step:
        if agree(preempted.is_set(), mesh):
            preempted.set()
            break
        gi, idx = plan.draw(min(K, total_step - step))
        for i in idx:
            batch = {k: v[int(i)] for k, v in stacks[gi].items()}
            losses = train_step(model, optimizer, batch, step,
                                grad_acc_step=acc)
            step += 1
            if step_hook is not None:
                step_hook(step, losses)
        run_duties(step, losses, groups[gi][0], int(frames[gi][idx].sum()))
    return step


class _NullLogger:
    """The logger of a rank other than 0: writes nothing."""

    def message(self, text):
        pass

    def scalars(self, step, losses):
        pass

    def figure(self, tag, fig, step=None):
        pass

    def audio(self, tag, wav, sampling_rate, step=None):
        pass

    def close(self):
        pass


def _start_profiler():
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _write_trace(prof, profile_dir, log):
    """Stop the profiler of steps 11-20 (the JAX loop's window,
    fastspeech2_tpu/training/loop.py:409-415) and write its Chrome trace."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace_steps_11-20.json")
    prof.export_chrome_trace(path)
    log(f"Profile of steps 11-20 written to {path}")


def train(preprocess_config, model_config, train_config, restore_step=0,
          dtype=torch.float32, max_steps=None, log=print, device="cuda",
          step_hook=None, vocoder=None, profile_dir=None, mesh=None):
    """The reference's main() loop (train.py:21-169) on ``device`` at the
    compute ``dtype`` (parameters and optimizer state stay float32).

    step_hook: called as step_hook(step, losses) after every update (for
    measurements).  vocoder: the synth_step duty's (None: the figure
    only, as the JAX train CLI runs it).  profile_dir: where the trace of
    the run's 11th to 20th steps goes (none in scan mode, as in the JAX
    package).  mesh: this rank's
    ``parallel.Mesh`` (default: :func:`default_mesh`).  Returns (model,
    optimizer, step); (None, None, restore_step) on a rank outside the
    mesh.
    """
    device = torch.device(device)
    steps = StepConfig.build(train_config)
    total_step = min(steps.total_step, max_steps or steps.total_step)
    if mesh is None:
        mesh = default_mesh(OptimConfig.build(train_config))
    if not mesh.active:
        log(f"outside the (data {mesh.data}, model {mesh.model}) mesh: "
            "this rank stays idle")
        return None, None, restore_step
    if not mesh.is_main:
        log = _silent
    model, cfg, optim_cfg, optimizer = init_training(
        preprocess_config, model_config, train_config, restore_step,
        device=device, dtype=dtype, mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"Number of FastSpeech2 Parameters: {n_params}")

    loader = train_loader(preprocess_config, train_config, cfg,
                          optim_cfg.batch_size)
    val_dataset = FeatureDataset("val.txt", preprocess_config)
    log_path = train_config["path"]["log_path"]
    logger = (TrainLogger(os.path.join(log_path, "train"), log)
              if mesh.is_main else _NullLogger())
    val_logger = (TrainLogger(os.path.join(log_path, "val"), _silent)
                  if mesh.is_main else _NullLogger())
    ckpt_dir = train_config["path"]["ckpt_path"]

    acc = optim_cfg.grad_acc_step
    if optim_cfg.batch_size % acc:
        raise ValueError(f"batch_size {optim_cfg.batch_size} must be "
                         f"divisible by grad_acc_step {acc}")
    scan_step = int(train_config["step"].get("scan_step", 1))
    sampling_rate = preprocess_config["preprocessing"]["audio"][
        "sampling_rate"]
    profiler = None

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

    def run_duties(step, losses, batch, frames):
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
            logger.scalars(step, vals)
        if step % steps.synth_step == 0:
            log_sample(logger, f"Training/step_{step}_{batch['ids'][0]}",
                       synth_one_sample(model, batch, preprocess_config,
                                        vocoder if mesh.is_main else None,
                                        log, figure=mesh.is_main),
                       sampling_rate)
        if step % steps.val_step == 0:
            vals = evaluate(model, val_dataset, optim_cfg.batch_size, cfg,
                            device)
            msg = loss_line(f"Validation Step {step}", vals)
            log(msg)
            val_logger.message(msg)
            val_logger.scalars(step, vals)
            if len(val_dataset):
                # one validation sample's figure (reference
                # evaluate.py:57-84); the JAX loop vocodes it too and logs
                # no wav, so it goes without the vocoder here
                val_batch = next(iter(BucketedLoader(
                    val_dataset, batch_size=1, group_size=1, shuffle=False,
                    drop_last=False, max_mel_len=cfg.max_seq_len).epoch(0)))
                log_sample(val_logger,
                           f"Validation/step_{step}_{val_batch['ids'][0]}",
                           synth_one_sample(model, val_batch,
                                            preprocess_config, None, log,
                                            figure=mesh.is_main),
                           sampling_rate)
        if step % steps.save_step == 0:
            save_training_state(ckpt_dir, model, optimizer, step, mesh)
            log(f"Saved checkpoint at step {step}")

    mel_bf16 = bool(train_config.get("transfer", {}).get("mel_bf16",
                                                         False))

    def to_device(batch):
        return batch, batch_to_device(rank_rows(batch, mesh, acc), device,
                                      mel_bf16)

    step = restore_step
    epoch = epoch_batches = 0
    model.train()
    try:
        if scan_step > 1:
            budget_mb = float(train_config["step"].get("scan_hbm_budget_mb",
                                                       8192))
            step = _train_scanned(
                scan_step, step, total_step, steps, loader, model, optimizer,
                acc, mesh, device, mel_bf16, int(budget_mb * 2 ** 20),
                run_duties, preempted, step_hook, profile_dir, log)
        while step < total_step and not preempted.is_set():
            if epoch and epoch_batches == 0:
                raise _no_batch(optim_cfg.batch_size)
            epoch_batches = 0
            for batch, device_batch in PrefetchIterator(
                    loader.epoch(epoch), depth=2, transform=to_device):
                if step >= total_step:
                    break
                if agree(preempted.is_set(), mesh):
                    preempted.set()
                    save_training_state(ckpt_dir, model, optimizer, step,
                                        mesh)
                    log(f"Preemption checkpoint saved at step {step}")
                    break
                if profile_dir and step - restore_step == 10:
                    profiler = _start_profiler()
                losses = train_step(model, optimizer, device_batch, step,
                                    grad_acc_step=acc)
                step += 1
                if profiler is not None and step - restore_step == 20:
                    _write_trace(profiler, profile_dir, log)
                    profiler = None
                epoch_batches += 1
                if step_hook is not None:
                    step_hook(step, losses)
                run_duties(step, losses, batch, int(batch["mel_lens"].sum()))
            epoch += 1
    finally:
        if profiler is not None:    # the run ended inside the window
            profiler.stop()
        for sig, prev in installed:
            signal.signal(sig, prev)
    save_training_state(ckpt_dir, model, optimizer, step, mesh)
    logger.close()
    val_logger.close()
    return model, optimizer, step

