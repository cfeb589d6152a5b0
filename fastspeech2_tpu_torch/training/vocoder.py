"""HiFi-GAN vocoder training (port of ``fastspeech2_tpu/training/vocoder.py``):
the losses, the optimizer, the two-network GAN step, its samplers, scan
mode and the training loop.

The objective is HiFi-GAN's:

  L_D = sum_k E[(1 - D_k(y))^2] + E[D_k(y_hat)^2]          (LSGAN)
  L_G = sum_k E[(1 - D_k(y_hat))^2] + 2 * L_FM + mel_weight * L_mel
  L_FM = the sum over every feature map of mean |feat(y) - feat(y_hat)|
  L_mel = mean |mel(y) - mel(y_hat)|

One step updates the discriminators on the detached y_hat, then the
generator through the *updated* discriminators, as the JAX step does
(``:107-242``).  Both networks train with AdamW (b1 0.8, b2 0.99, eps
1e-8, weight decay 1e-4 on every parameter, biases included) on a
staircase exponential learning-rate decay (:class:`VocoderAdamW`).

The generator trains with its plain ResBlocks (``fused=False``): K4 is
inference-only, and the JAX trainer pins its ResBlocks to XLA too
(``:472-476``).  The discriminators' convolutions, the STFTs and the
optimizer are cuDNN, cuFFT and PyTorch calls on the card: none of them is
a Pallas kernel in the JAX package.  The augmentation draws come from a
``torch.Generator`` keyed on (seed, step) (:func:`augmentation_draws`), not
from JAX's threefry stream: the two packages draw different numbers by
design, and the tests pass JAX's draws in.

Data parallel (``data_parallel`` N, ``:541-560``): N ranks of an
initialised ``torch.distributed`` world, one process each, hold the same
networks (the same seed) and draw the same global batch from the same
sampler; rank r trains on rows [r B/N, (r+1) B/N) of it, and on its rows
of the step's augmentation draws, which are made for the whole batch.
Each loss is a mean over equal shares, so the gradients are averaged over
the ranks (one all-reduce per network per step) and every rank applies
the one-process update.  Scan mode splits its [K, B] schedule by columns,
as the JAX loop shards it ``P(None, "data")``.
"""

import math
import os
import random

import numpy as np
import torch

from fastspeech2_tpu_torch.audio.stft import MelSpectrogram
from fastspeech2_tpu_torch.audio.wav import load_wav
from fastspeech2_tpu_torch.models.hifigan_disc import HiFiGANDiscriminators
from fastspeech2_tpu_torch.parallel.comm import all_reduce, all_reduce_flat
from fastspeech2_tpu_torch.synthesis.vocoder import (
    build_generator,
    generator_from_jax_params,
)
from fastspeech2_tpu_torch.training.checkpoint import (
    latest_step,
    load_checkpoint,
    save_vocoder_checkpoint,
)
from fastspeech2_tpu_torch.training.optim import AdamW
from fastspeech2_tpu_torch.utils.device import resolve_device

LOSS_NAMES = ("disc", "gen", "gen_adv", "gen_fm", "gen_mel")


class VocoderAdamW(AdamW):
    """``optax.adamw(sched, b1, b2)`` with optax's eps 1e-8 and weight decay
    1e-4 (``:58-65``; :class:`training.optim.AdamW`).  ``sched`` is the
    staircase ``exponential_decay(lr, steps_per_epoch, lr_decay)``,
    evaluated at the count *before* the update, in float32 as optax
    computes it."""

    def __init__(self, params, learning_rate=2e-4, betas=(0.8, 0.99),
                 lr_decay=0.999, steps_per_epoch=1000, eps=1e-8,
                 weight_decay=1e-4):
        super().__init__(params, betas=betas, eps=eps,
                         weight_decay=weight_decay)
        self.learning_rate = learning_rate
        self.lr_decay = lr_decay
        self.steps_per_epoch = steps_per_epoch

    def schedule(self, count):
        """The staircase learning rate at ``count`` updates done, float32
        arithmetic as in optax -> a Python float."""
        f32 = np.float32
        if count <= 0:
            return float(f32(self.learning_rate))
        p = np.floor(f32(count) / f32(self.steps_per_epoch))
        return float(f32(self.learning_rate)
                     * np.power(f32(self.lr_decay), f32(p)))


def discriminator_loss(real_scores, fake_scores):
    loss = 0.0
    for dr, dg in zip(real_scores, fake_scores):
        loss = loss + torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2)
    return loss


def generator_adv_loss(fake_scores):
    loss = 0.0
    for dg in fake_scores:
        loss = loss + torch.mean((1.0 - dg) ** 2)
    return loss


def feature_loss(real_fmaps, fake_fmaps):
    loss = 0.0
    for fr_list, fg_list in zip(real_fmaps, fake_fmaps):
        for fr, fg in zip(fr_list, fg_list):
            loss = loss + torch.mean(torch.abs(fr - fg))
    return 2.0 * loss


def resample_segments(wav_ext, rates, out_len):
    """Per-element linear-interpolation speed perturbation: wav_ext
    [B, S_ext], rates [B] -> [B, out_len] with out[b, i] = wav_ext[b, i *
    rates[b]], the index clamped at S_ext - 2 (``:90-104``)."""
    s_ext = wav_ext.shape[1]
    pos = (torch.arange(out_len, dtype=torch.float32,
                        device=wav_ext.device)[None, :] * rates[:, None])
    idx0 = torch.clamp(torch.floor(pos).long(), 0, s_ext - 2)
    frac = pos - idx0.float()
    lo = torch.gather(wav_ext, 1, idx0)
    hi = torch.gather(wav_ext, 1, idx0 + 1)
    return lo * (1.0 - frac) + hi * frac


def augmentation_draws(seed, step, batch_size, aug_gain_db=0.0,
                       aug_speed=None):
    """The per-element draws of one step, on the CPU from a
    ``torch.Generator`` keyed on (seed, step), so a resumed run replays
    them -> {"gain_db": [B] in U[-d, d] or None, "rates": [B] in U[lo, hi]
    or None}.  The JAX step draws them from threefry
    (``fold_in(PRNGKey(seed), step)``, ``:161-177``): other numbers of the
    same distributions."""
    g = torch.Generator().manual_seed(
        ((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    draws = {"gain_db": None, "rates": None}
    if aug_speed is not None:
        lo, hi = aug_speed
        draws["rates"] = torch.rand(batch_size, generator=g) * (hi - lo) + lo
    if aug_gain_db:
        draws["gain_db"] = ((torch.rand(batch_size, generator=g) * 2.0 - 1.0)
                            * aug_gain_db)
    return draws


class VocoderTrainState:
    """The generator, the discriminators, their optimizers, the number of
    steps done, and the generator's config (the upstream config.json
    schema, ``arch: melgan`` for MelGAN), from which a loader rebuilds the
    topology."""

    def __init__(self, gen, disc, gen_opt, disc_opt, generator_config,
                 step=0):
        self.gen, self.disc = gen, disc
        self.gen_opt, self.disc_opt = gen_opt, disc_opt
        self.generator_config = generator_config
        self.step = step


def make_vocoder_train_step(gen, disc, mel_fn, mel_weight=45.0,
                            external_mel=False, gen_input_scale=1.0,
                            adv_warmup=0, aug_gain_db=0.0, aug_speed=None,
                            out_segment=None, aug_seed=0, data_group=None,
                            data_rank=0, data_size=1):
    """-> ``step(state, wav, mel=None, draws=None) -> (state, losses)``,
    which updates ``state`` in place.

    wav: [B, S] ground-truth segments, S a multiple of the hop (S =
    out_segment * aug_speed[1] with speed augmentation); mel
    (external_mel only): [B, S // hop, n_mels] log-e generator input, for
    example acoustic-model predictions.  ``draws``: the step's
    augmentation draws (:func:`augmentation_draws` of (aug_seed,
    state.step) when None).

    gen_input_scale rescales the generator input only (1/ln 10 for MelGAN,
    which takes log10 mels); the mel-L1 target stays log-e.  For the first
    ``adv_warmup`` steps the discriminators, their optimizer state and
    count included, keep their values and the generator trains on
    mel_weight * L_mel alone (the adversarial and feature-matching losses
    are still reported).  Gain augmentation scales each segment by
    g = 10^(U[-d, d]/20); an external log-e mel shifts by ln g.  Speed
    augmentation resamples each segment and needs the mel computed in the
    step (external_mel=False).  The losses are 0-d tensors on the card,
    {disc, gen, gen_adv, gen_fm, gen_mel}, read by the caller when it
    logs.

    With a ``data_group`` of ``data_size`` ranks, ``wav`` (and ``mel``)
    are this rank's ``data_rank``-th share of the global batch; the draws
    are made for the global batch and this share taken; gradients and
    losses are averaged over the group (module docstring)."""
    hop = mel_fn.hop_length
    scale = 1.0 / data_size
    if aug_speed is not None and external_mel:
        raise ValueError("aug_speed needs in-graph mels "
                         "(external_mel=False); use gain-only "
                         "augmentation with external mels")
    gen_params = list(gen.parameters())
    disc_params = list(disc.parameters())

    def mel_of(wav, n_frames):
        return mel_fn(wav)[0][:, :, :n_frames]

    def step(state, wav, mel=None, draws=None):
        if draws is None and (aug_speed is not None or aug_gain_db):
            b = wav.shape[0]
            draws = augmentation_draws(aug_seed, state.step, b * data_size,
                                       aug_gain_db, aug_speed)
            draws = {k: None if v is None
                     else v[data_rank * b:(data_rank + 1) * b]
                     for k, v in draws.items()}
        if aug_speed is not None:
            wav = resample_segments(wav, draws["rates"].to(wav.device),
                                    out_segment)
        gain_log = None
        if aug_gain_db:
            gain = 10.0 ** (draws["gain_db"].to(wav.device) / 20.0)
            wav = wav * gain[:, None]
            gain_log = torch.log(gain)
        n_frames = wav.shape[1] // hop
        if external_mel:
            mel_in = mel
            if gain_log is not None:
                # raw log-e mels shift additively under gain
                mel_in = mel_in + gain_log[:, None, None]
        else:
            with torch.no_grad():
                mel_in = mel_of(wav, n_frames).transpose(1, 2)
        if gen_input_scale != 1.0:
            mel_in = mel_in * gen_input_scale
        # one generator forward serves both updates: the JAX step's two
        # applications of the same parameters give the same y_hat
        y_hat = gen(mel_in)
        in_warmup = state.step < adv_warmup

        # discriminators, on the detached y_hat (held during warmup)
        with torch.set_grad_enabled(not in_warmup):
            _, real_scores = disc(wav)
            _, fake_scores = disc(y_hat.detach())
            d_loss = discriminator_loss(real_scores, fake_scores)
        if not in_warmup:
            state.disc_opt.step(all_reduce_flat(
                torch.autograd.grad(d_loss, disc_params), data_group, scale))

        # generator, through the updated discriminators; the gradient goes
        # to the generator's parameters only
        with torch.no_grad():
            real_fmaps, _ = disc(wav)
            mel_target = mel_of(wav, n_frames)
        with torch.set_grad_enabled(not in_warmup):
            fake_fmaps, fake_scores = disc(
                y_hat.detach() if in_warmup else y_hat)
            adv = generator_adv_loss(fake_scores)
            fm = feature_loss(real_fmaps, fake_fmaps)
        mel_l1 = torch.mean(torch.abs(mel_of(y_hat, n_frames) - mel_target))
        total = mel_weight * mel_l1
        if not in_warmup:
            total = (adv + fm) + total
        state.gen_opt.step(all_reduce_flat(
            torch.autograd.grad(total, gen_params), data_group, scale))
        state.step += 1
        losses = torch.stack([v.detach() for v in
                              (d_loss, total, adv, fm, mel_l1)])
        if data_group is not None:
            losses = all_reduce(losses, data_group) * scale
        return state, dict(zip(LOSS_NAMES, losses.unbind(0)))

    return step


def make_scanned_vocoder_step(inner, segment_size, hop, external_mel):
    """K GAN steps over a device-resident bank (``:245-276``) ->
    ``scanned(state, bank, mel_bank, clips, starts) -> (state, losses)``
    with each loss stacked over the K steps.

    bank: the zero-padded corpus [N, L] on the card (+ mel_bank
    [N, F, n_mels] with external mels); clips, starts: [K, B] clip indices
    and segment starts in samples.  Each step gathers its segments on the
    card, the start clamped to [0, L - length] as JAX's dynamic_slice
    clamps it.  On the card this is a Python loop of K steps."""

    def gather(source, idx, start, length):
        start = torch.clamp(start, 0, source.shape[1] - length)
        pos = start[:, None] + torch.arange(length, device=source.device)
        return source[idx[:, None], pos]

    def scanned(state, bank, mel_bank, clips, starts):
        seq = {k: [] for k in LOSS_NAMES}
        for c, s in zip(clips, starts):
            seg = gather(bank, c, s, segment_size)
            if external_mel:
                mel = gather(mel_bank, c, s // hop, segment_size // hop)
                state, losses = inner(state, seg, mel)
            else:
                state, losses = inner(state, seg)
            for k, v in losses.items():
                seq[k].append(v)
        return state, {k: torch.stack(v) for k, v in seq.items()}

    return scanned


class FinetuneSampler:
    """Aligned (wav, mel) segment pairs from a preprocessed corpus
    (``:279-356``), drawn with ``random.Random(seed)`` in the JAX sampler's
    call order, so both packages draw the same segments.

    Needs ``preprocessing.audio.save_trimmed_wav: true`` at preprocess time
    (wav/<spk>-wav-<base>.npy, exactly n_frames*hop samples) and, for
    mel_source "pred" or "mixed", an export_mels run (mel_pred/).  "mixed"
    holds both the GT-mel and the predicted-mel pairs, so each draw picks
    either."""

    def __init__(self, preprocessed_path, segment_size=8192, hop_length=256,
                 mel_source="pred", seed=0, split=None):
        import glob

        self.segment_size = segment_size
        self.hop = hop_length
        self.n_frames = segment_size // hop_length
        mel_dirs = {"pred": ["mel_pred"], "gt": ["mel"],
                    "mixed": ["mel", "mel_pred"]}[mel_source]
        allowed = None
        if split:
            # only the utterances a metadata file names (leave-one-out)
            allowed = set()
            with open(os.path.join(preprocessed_path, split)) as f:
                for line in f:
                    parts = line.rstrip("\n").split("|")
                    if len(parts) >= 2:
                        allowed.add(f"{parts[1]}-wav-{parts[0]}.npy")
        self.pairs = []
        for mel_dir in mel_dirs:
            for wav_path in sorted(glob.glob(
                    os.path.join(preprocessed_path, "wav", "*-wav-*.npy"))):
                if allowed is not None and \
                        os.path.basename(wav_path) not in allowed:
                    continue
                mel_path = os.path.join(
                    preprocessed_path, mel_dir,
                    os.path.basename(wav_path).replace("-wav-", "-mel-"))
                if os.path.exists(mel_path):
                    self.pairs.append((wav_path, mel_path))
        if not self.pairs:
            raise FileNotFoundError(
                f"no aligned wav/{'|'.join(mel_dirs)} pairs under "
                f"{preprocessed_path} (preprocess with save_trimmed_wav: "
                "true"
                + (" and run export_mels_cli"
                   if mel_source != "gt" else "")
                + ")")
        self._rng = random.Random(seed)
        self._cache = {}

    def _load(self, pair):
        if pair not in self._cache:
            wav = np.load(pair[0]).astype(np.float32)
            mel = np.load(pair[1]).astype(np.float32)
            n = min(len(wav) // self.hop, mel.shape[0])
            self._cache[pair] = (wav[: n * self.hop], mel[:n])
        return self._cache[pair]

    def sample(self, batch_size):
        n_mels = self._load(self.pairs[0])[1].shape[1]
        wav_out = np.zeros((batch_size, self.segment_size), np.float32)
        mel_out = np.zeros((batch_size, self.n_frames, n_mels), np.float32)
        for b in range(batch_size):
            wav, mel = self._load(self._rng.choice(self.pairs))
            n = mel.shape[0]
            if n > self.n_frames:
                f = self._rng.randrange(n - self.n_frames)
                mel_out[b] = mel[f: f + self.n_frames]
                wav_out[b] = wav[f * self.hop: (f + self.n_frames) * self.hop]
            else:
                mel_out[b, :n] = mel
                wav_out[b, : n * self.hop] = wav
        return wav_out, mel_out


def _random_segments(rng, load, paths, segment_size, batch_size):
    out = np.zeros((batch_size, segment_size), np.float32)
    for b in range(batch_size):
        wav = load(rng.choice(paths))
        if len(wav) > segment_size:
            start = rng.randrange(len(wav) - segment_size)
            out[b] = wav[start:start + segment_size]
        else:
            out[b, :len(wav)] = wav
    return out


class TrimmedWavSampler:
    """Random fixed-length segments of a preprocessed corpus's trimmed
    wavs, restricted by ``split`` as :class:`FinetuneSampler` is
    (mel_source "gt_wav": the input mel is computed in the step, so speed
    augmentation stays consistent with it)."""

    def __init__(self, preprocessed_path, segment_size=8192, seed=0,
                 split=None):
        inner = FinetuneSampler(preprocessed_path, segment_size,
                                mel_source="gt", seed=seed, split=split)
        self.segment_size = segment_size
        self.paths = [w for w, _ in inner.pairs]
        self._rng = random.Random(seed)
        self._cache = {}

    def _load(self, path):
        if path not in self._cache:
            self._cache[path] = np.load(path).astype(np.float32)
        return self._cache[path]

    def sample(self, batch_size):
        return _random_segments(self._rng, self._load, self.paths,
                                self.segment_size, batch_size)


class SegmentSampler:
    """Random fixed-length waveform segments from a directory of .wav files
    (<root>/<speaker>/*.wav, as the raw preprocessing corpus)."""

    def __init__(self, wav_dir, segment_size=8192, sampling_rate=22050,
                 seed=0):
        self.segment_size = segment_size
        self.paths = []
        for dirpath, _, files in os.walk(wav_dir):
            for f in sorted(files):
                if f.endswith(".wav"):
                    self.paths.append(os.path.join(dirpath, f))
        if not self.paths:
            raise FileNotFoundError(f"no .wav under {wav_dir}")
        self.sampling_rate = sampling_rate
        self._rng = random.Random(seed)
        self._cache = {}

    def _load(self, path):
        if path not in self._cache:
            wav, _ = load_wav(path, target_sr=self.sampling_rate)
            self._cache[path] = np.asarray(wav, np.float32)
        return self._cache[path]

    def sample(self, batch_size):
        return _random_segments(self._rng, self._load, self.paths,
                                self.segment_size, batch_size)


def scan_dispatch(scan_step, log_step, save_step):
    """K, the steps per scanned dispatch: gcd(gcd(scan_step, log_step),
    save_step), so that logs and checkpoints fall on dispatch ends;
    raises when K <= 1."""
    K = math.gcd(math.gcd(scan_step, log_step), save_step)
    if K <= 1:
        raise ValueError(
            f"scan_step {scan_step} shares no factor with log_step "
            f"{log_step} / save_step {save_step}")
    return K


def scan_schedule(rng, k, batch_size, hi, external_mel, hop):
    """One dispatch's [k, B] clip indices and segment starts in samples,
    drawn from the ``np.random.RandomState`` ``rng`` as the JAX loop draws
    them (``:681-689``); hi: each clip's largest start (in frames with
    external mels, whose starts are frame-aligned)."""
    clips = rng.randint(0, len(hi), (k, batch_size))
    starts = (rng.random_sample((k, batch_size))
              * (hi[clips] + 1)).astype(np.int64)
    if external_mel:
        starts = starts * hop
    return clips.astype(np.int64), starts


def _to_device(x, device):
    x = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x


def _log_line(i, total_steps, vals):
    return (f"Vocoder step {i}/{total_steps}: "
            + ", ".join(f"{k}={v:.4f}" for k, v in vals.items()))


def train_vocoder(wav_dir, out_dir, *, total_steps=1000, batch_size=16,
                  segment_size=8192, sampling_rate=22050,
                  learning_rate=2e-4, lr_decay=0.999, steps_per_epoch=1000,
                  log_step=100, save_step=1000, generator_config=None,
                  discriminator_config=None,
                  n_mel_channels=80, mel_fmax=8000.0, seed=0,
                  finetune_from=None, mel_source="pred", split=None,
                  init_generator_params=None, data_parallel=None,
                  scan_step=1, mel_weight=45.0, adv_warmup=0,
                  aug_gain_db=0.0, aug_speed=None, device="cuda",
                  log=print):
    """Train (or fine-tune) a vocoder generator against the MPD and MSD
    (``:428-601``) -> the :class:`VocoderTrainState` at the end.

    generator_config: the generator's keys of the upstream config.json
    schema; ``arch: melgan`` trains MelGAN (its input scaled by 1/ln 10),
    ``gen_istft_n_fft`` the iSTFT generator, else the parity HiFi-GAN.
    wav_dir: from-scratch training on raw .wav segments; finetune_from: a
    preprocessed corpus with trimmed wavs, its mels taken from mel_source
    ("pred", "gt", "mixed"), or computed in the step for "gt_wav".  The
    networks start from a seeded PyTorch init (the JAX package's Flax init
    draws other numbers); init_generator_params (the generator's Flax
    params, a numpy tree) warm-starts the generator.  A checkpoint in
    out_dir wins: training resumes from the newest one.  Every log_step
    steps one line reports the losses; every save_step steps (and at the
    end) ``<out_dir>/<step>.pth.tar`` is written.  scan_step > 1 runs the
    device-resident bank of :func:`make_scanned_vocoder_step`.
    ``data_parallel`` N > 1 trains on this rank's share of each batch in an
    initialised world of N ranks (module docstring); rank 0 alone logs and
    writes checkpoints."""
    group, rank, n_ranks = None, 0, 1
    if data_parallel and data_parallel > 1:
        import torch.distributed as dist

        if batch_size % data_parallel:
            raise ValueError(
                f"batch_size {batch_size} not divisible by "
                f"data_parallel {data_parallel}")
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != data_parallel:
            raise ValueError(
                f"data_parallel {data_parallel} needs a torch.distributed "
                f"world of {data_parallel} ranks (torchrun --nproc_per_node "
                f"{data_parallel}), found {world}")
        group, rank, n_ranks = dist.group.WORLD, dist.get_rank(), world
        if rank:
            log = _silent
    device = resolve_device(device)
    # a step is reproducible on the card: cuDNN takes its deterministic
    # convolution algorithms, untuned (training/loop.py:init_training)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    config = dict(generator_config or {}, num_mels=n_mel_channels)
    gen_input_scale = (1.0 / float(np.log(10.0))
                       if config.get("arch") == "melgan" else 1.0)
    mel_fn = MelSpectrogram(
        hop_length=256, n_mel_channels=n_mel_channels,
        sampling_rate=sampling_rate, mel_fmax=mel_fmax)
    hop = mel_fn.hop_length
    external_mel = finetune_from is not None and mel_source != "gt_wav"
    if aug_speed is not None and external_mel:
        raise ValueError(
            "aug_speed needs the input mel computed in-graph: use "
            "mel_source='gt_wav' (or from-scratch --wav_dir mode); "
            "external mels support gain augmentation only")
    # speed perturbation reads longer source segments, resampled to
    # segment_size at rates up to aug_speed[1]
    seg_ext = segment_size
    if aug_speed is not None:
        seg_ext = int(math.ceil(segment_size * aug_speed[1]))

    if external_mel:
        sampler = FinetuneSampler(finetune_from, segment_size, hop,
                                  mel_source, seed, split=split)
    elif finetune_from is not None:
        sampler = TrimmedWavSampler(finetune_from, seg_ext, seed,
                                    split=split)
    else:
        sampler = SegmentSampler(wav_dir, seg_ext, sampling_rate, seed)
    # the JAX trainer initialises its networks on one batch of the
    # sampler: drawn here too, so step i trains on the same segments
    sampler.sample(batch_size)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gen = build_generator(config, fused=False)
        disc = HiFiGANDiscriminators(**(discriminator_config or {}))
    if init_generator_params is not None:
        gen.load_state_dict(generator_from_jax_params(
            init_generator_params, config))
    gen.to(device).train()
    disc.to(device).train()

    def optimizer(module):
        return VocoderAdamW(module.parameters(), learning_rate,
                            lr_decay=lr_decay,
                            steps_per_epoch=steps_per_epoch)

    state = VocoderTrainState(gen, disc, optimizer(gen), optimizer(disc),
                              config)
    start_step = latest_step(out_dir)
    if start_step is not None:
        saved = load_checkpoint(out_dir, start_step)
        gen.load_state_dict(saved["generator"])
        disc.load_state_dict(saved["discriminators"])
        state.gen_opt.load_state_dict(saved["gen_optimizer"])
        state.disc_opt.load_state_dict(saved["disc_optimizer"])
        state.step = saved["step"]
        log(f"Resumed vocoder training from step {start_step}")
    else:
        start_step = 0

    step_fn = make_vocoder_train_step(
        gen, disc, mel_fn, mel_weight=mel_weight, external_mel=external_mel,
        gen_input_scale=gen_input_scale, adv_warmup=adv_warmup,
        aug_gain_db=aug_gain_db, aug_speed=aug_speed,
        out_segment=segment_size, aug_seed=seed, data_group=group,
        data_rank=rank, data_size=n_ranks)
    os.makedirs(out_dir, exist_ok=True)
    share = batch_size // n_ranks
    rows = slice(rank * share, (rank + 1) * share)

    def save(i):
        if rank == 0:
            save_vocoder_checkpoint(out_dir, state, i)

    if scan_step > 1:
        return _train_vocoder_scanned(
            scan_step, state, step_fn, start_step, total_steps, batch_size,
            segment_size, hop, sampler, external_mel, log_step, save,
            save_step, seed, seg_ext, device, log, rows)

    for i in range(start_step + 1, total_steps + 1):
        if external_mel:
            wav, mel = sampler.sample(batch_size)
            state, losses = step_fn(state, _to_device(wav[rows], device),
                                    _to_device(mel[rows], device))
        else:
            wav = _to_device(sampler.sample(batch_size)[rows], device)
            state, losses = step_fn(state, wav)
        if i % log_step == 0 or i == total_steps:
            log(_log_line(i, total_steps,
                          {k: float(v) for k, v in losses.items()}))
        if i % save_step == 0 or i == total_steps:
            save(i)
    return state


def _silent(*_):
    pass


def _train_vocoder_scanned(scan_step, state, step_fn, start_step,
                           total_steps, batch_size, segment_size, hop,
                           sampler, external_mel, log_step, save, save_step,
                           seed, seg_ext, device, log, rows):
    """Training over a zero-padded device-resident bank of the whole corpus
    (``:604-704``): K = :func:`scan_dispatch` steps per dispatch, clips and
    starts from ``np.random.RandomState(seed + start_step)``
    (:func:`scan_schedule`) for the global batch, this rank's ``rows``
    (columns of the schedule) trained on, the losses of a dispatch's last
    step logged; ``save(i)`` writes the checkpoint of step i."""
    K = scan_dispatch(scan_step, log_step, save_step)
    if external_mel:
        items = [sampler._load(p) for p in sampler.pairs]
        wavs = [w for w, _ in items]
        mels = [m for _, m in items]
        n_frames_seg = segment_size // hop
        f_max = max(max(m.shape[0] for m in mels), n_frames_seg)
        mel_bank = np.zeros((len(mels), f_max, mels[0].shape[1]),
                            np.float32)
        for i, m in enumerate(mels):
            mel_bank[i, : m.shape[0]] = m
        l_max = f_max * hop
        # frame-aligned start ranges (starts are multiples of hop)
        hi = np.array([max(m.shape[0] - n_frames_seg, 0) for m in mels])
    else:
        wavs = [sampler._load(p) for p in sampler.paths]
        l_max = max(max(len(w) for w in wavs), seg_ext)
        mel_bank = np.zeros((1, 1, 1), np.float32)     # unused
        hi = np.array([max(len(w) - seg_ext, 0) for w in wavs])
    bank = np.zeros((len(wavs), l_max), np.float32)
    for i, w in enumerate(wavs):
        bank[i, : len(w)] = w
    bank_dev = torch.as_tensor(bank, device=device)
    mel_bank_dev = torch.as_tensor(mel_bank, device=device)
    log(f"vocoder scan mode: {len(wavs)} clips ({bank.nbytes / 1e6:.0f} MB"
        f"{' + mel bank' if external_mel else ''}) device-resident, "
        f"{K} steps/dispatch")
    scanned = make_scanned_vocoder_step(step_fn, seg_ext, hop, external_mel)

    rng = np.random.RandomState(seed + start_step)
    i = start_step
    while i < total_steps:
        k = min(K, total_steps - i)
        clips, starts = scan_schedule(rng, k, batch_size, hi, external_mel,
                                      hop)
        state, seq = scanned(state, bank_dev, mel_bank_dev,
                             torch.as_tensor(clips[:, rows], device=device),
                             torch.as_tensor(starts[:, rows], device=device))
        i += k
        if i % log_step == 0 or i == total_steps:
            log(_log_line(i, total_steps,
                          {kk: float(v[-1]) for kk, v in seq.items()}))
        if i % save_step == 0 or i == total_steps:
            save(i)
    return state
