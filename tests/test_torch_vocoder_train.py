"""PyTorch port, vocoder training, against the JAX package on the CPU: the
MPD and MSD, the three losses, ``resample_segments`` and the gain shift,
the AdamW optimizer against ``optax.adamw``, one and three GAN steps from
the same parameters (in-graph mels, external mels, MelGAN's input scale,
across the ``adv_warmup`` boundary, augmentation with JAX's draws passed
in), the samplers and the scan schedule, and the train_vocoder CLI of both
packages on a tmp corpus.

Sizes are the JAX tests' (``tests/test_vocoder_train.py:28-46``): 2048-
sample segments, a tiny discriminator and generator, 8 mels.  Inputs come
from numpy seeds; the port's networks take the JAX initialiser's
parameters (``utils/params_io.py``).  Each test states its tolerance.
"""

import functools
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastspeech2_tpu.audio.stft import MelSpectrogram as JaxMelSpectrogram
from fastspeech2_tpu.models.hifigan import HiFiGANGenerator as JaxHiFiGAN
from fastspeech2_tpu.models.hifigan_disc import (
    HiFiGANDiscriminators as JaxDiscriminators,
)
from fastspeech2_tpu.models.hifigan_istft import (
    HiFiGANiSTFTGenerator as JaxHiFiGANiSTFT,
)
from fastspeech2_tpu.models.melgan import MelGANGenerator as JaxMelGAN
from fastspeech2_tpu.training import vocoder as jax_voc
from fastspeech2_tpu_torch.audio.stft import MelSpectrogram
from fastspeech2_tpu_torch.models.hifigan_disc import HiFiGANDiscriminators
from fastspeech2_tpu_torch.synthesis.vocoder import build_generator
from fastspeech2_tpu_torch.training import vocoder as voc
from fastspeech2_tpu_torch.utils.params_io import (
    discriminators_from_jax_params,
    hifigan_from_jax_params,
    melgan_from_jax_params,
)

SEG = 2048  # 8 mel frames at hop 256
N_MELS = 8
TINY_DISC = dict(periods=(2, 3), n_scales=2, period_channels=(4, 8),
                 scale_layers=((8, 15, 1, 1), (16, 41, 4, 4), (16, 5, 1, 1)))
TINY_HIFIGAN = dict(upsample_rates=(8, 8, 2, 2),
                    upsample_kernel_sizes=(16, 16, 4, 4),
                    upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                    resblock_dilation_sizes=((1, 3),))
TINY_ISTFT = dict(upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
                  upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                  resblock_dilation_sizes=((1, 3),), gen_istft_n_fft=16,
                  gen_istft_hop_size=4)
TINY_MELGAN = dict(upsample_rates=(8, 8, 2, 2), ngf=4, n_residual_layers=1)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_disc_and_port(spec_items):
    """The JAX discriminators of a spec (a tuple of its items), their
    initial parameters (from a 1013-sample wav: the parameters do not
    depend on its length) and the port's copy.  Memoized."""
    spec = dict(spec_items)
    jdisc = JaxDiscriminators(**spec)
    params = _numpy(jax.jit(jdisc.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 1013)))["params"])
    disc = HiFiGANDiscriminators(**spec)
    disc.load_state_dict(discriminators_from_jax_params(
        params, spec.get("periods", (2, 3, 5, 7, 11))))
    return jdisc, params, disc


def _to_port_layout(fmap):
    """A JAX channels-last feature map -> the port's channels-first."""
    a = np.asarray(fmap)
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a.transpose(0, 2, 1)


@pytest.mark.parametrize("spec,T", [(TINY_DISC, SEG), ({}, 1013)],
                         ids=["tiny", "default"])
def test_discriminators_match_jax(spec, T):
    """fmaps and scores of the MPD and MSD, tolerance 1e-5 of the largest
    |value| of each tensor.  The default spec runs at T = 1013, a multiple
    of none of the periods, so every MPD branch pads (the flipped tail
    includes the last sample).  Measured: 4.5e-07 (tiny), 2.2e-06
    (default)."""
    wav = np.random.default_rng(1).uniform(-0.5, 0.5, (2, T)).astype(
        np.float32)
    jdisc, params, disc = _jax_disc_and_port(tuple(spec.items()))
    ref_f, ref_s = jax.jit(jdisc.apply)({"params": params}, wav)
    with torch.no_grad():
        got_f, got_s = disc(torch.from_numpy(wav))
    n_branches = len(spec.get("periods", (2, 3, 5, 7, 11))) + spec.get(
        "n_scales", 3)
    assert len(got_f) == len(ref_f) == len(got_s) == n_branches
    worst = 0.0
    for rf, gf, rs, gs in zip(ref_f, got_f, ref_s, got_s):
        assert len(rf) == len(gf)
        for r, g in list(zip(rf, gf)) + [(rs, gs)]:
            r = _to_port_layout(r) if np.ndim(r) > 2 else np.asarray(r)
            assert g.shape == r.shape
            err = np.abs(g.numpy() - r).max() / np.abs(r).max()
            worst = max(worst, err)
    assert worst <= 1e-5, worst


def test_discriminator_group_order_and_pad():
    """A grouped conv's [k, in/g, out] kernel maps to [out, in/g, k],
    group for group (the output channels of group j read input channels
    j*in/g..(j+1)*in/g - 1 in both packages, so the weight is the kernel
    transposed, nothing reordered); the MPD pad appends the reversed
    tail, last sample included."""
    _, params, disc = _jax_disc_and_port(())
    w = disc.msd.discriminators[0].convs[1].weight
    assert w.shape == (128, 32, 41)
    ref = np.asarray(params["msd"]["scale_0"]["conv_1"]["kernel"])
    np.testing.assert_array_equal(w.detach().numpy(), ref.transpose(2, 1, 0))
    branch = disc.mpd.discriminators[3]                  # period 7
    assert branch.period == 7
    got = []
    branch.convs[0].register_forward_hook(
        lambda m, a, o: got.append(a[0].clone()))
    with torch.no_grad():
        branch(torch.arange(10.0)[None])
    # 10 samples -> pad 4: [0..9] + [9, 8, 7, 6]
    np.testing.assert_array_equal(
        got[0].reshape(-1).numpy(),
        np.concatenate([np.arange(10.0), [9, 8, 7, 6]]))


def _scores(rng, shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_losses_match_jax():
    """At the optimum (D(real) = 1, D(fake) = 0; D(fake) = 1 for the
    adversarial loss; equal feature maps) the losses are exactly 0; away
    from it they match the JAX losses to 1e-6 relative.  Measured: 0
    (bitwise) for all three."""
    one = [torch.ones(2, 5), torch.ones(2, 7)]
    zero = [torch.zeros(2, 5), torch.zeros(2, 7)]
    assert float(voc.discriminator_loss(one, zero)) == 0.0
    assert float(voc.generator_adv_loss(one)) == 0.0
    assert float(voc.generator_adv_loss(zero)) == 2.0
    f = [[torch.ones(2, 3, 4)], [torch.ones(2, 6)]]
    assert float(voc.feature_loss(f, f)) == 0.0

    rng = np.random.default_rng(0)
    shapes = [(2, 33), (2, 17, 3), (2, 64)]
    real, fake = _scores(rng, shapes), _scores(rng, shapes)
    fr = [_scores(rng, [(2, 4, 8), (2, 8, 3)]), _scores(rng, [(2, 16, 5)])]
    fg = [_scores(rng, [(2, 4, 8), (2, 8, 3)]), _scores(rng, [(2, 16, 5)])]
    t = lambda xs: [torch.from_numpy(x) for x in xs]      # noqa: E731
    pairs = [
        (voc.discriminator_loss(t(real), t(fake)),
         jax_voc.discriminator_loss(real, fake)),
        (voc.generator_adv_loss(t(fake)), jax_voc.generator_adv_loss(fake)),
        (voc.feature_loss([t(x) for x in fr], [t(x) for x in fg]),
         jax_voc.feature_loss(fr, fg)),
    ]
    for got, ref in pairs:
        assert float(ref) > 0.1
        assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))


def test_resample_segments_and_gain_shift_match_jax():
    """resample_segments (clamped at the edge for rates that overrun) is
    equal to the JAX function's to 1e-6; the gain factor and its log, and
    the additive shift of the log-e mel under gain, to 1e-6.  Measured:
    resample 0 (bitwise), gain 0, shift 1.8e-07 relative to the mel's
    largest |value| where the mel is above the clamp."""
    rng = np.random.default_rng(3)
    wav = rng.uniform(-0.8, 0.8, (4, 2300)).astype(np.float32)
    rates = np.array([0.9, 1.0, 1.1, 1.3], np.float32)
    ref = np.asarray(jax_voc.resample_segments(jnp.asarray(wav),
                                               jnp.asarray(rates), SEG))
    got = voc.resample_segments(torch.from_numpy(wav),
                                torch.from_numpy(rates), SEG).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert got[2, 0] == wav[2, 0] and got[1, 100] == wav[1, 100]

    db = rng.uniform(-6.0, 6.0, 4).astype(np.float32)
    gain = 10.0 ** (torch.from_numpy(db) / 20.0)
    ref_gain = 10.0 ** (jnp.asarray(db) / 20.0)
    np.testing.assert_allclose(gain.numpy(), np.asarray(ref_gain),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(torch.log(gain).numpy(),
                               np.asarray(jnp.log(ref_gain)), atol=1e-6)
    mel_fn = MelSpectrogram(n_mel_channels=N_MELS)
    seg = torch.from_numpy(wav[:, :SEG])
    base = mel_fn(seg)[0]
    shifted = mel_fn(seg * gain[:, None])[0]
    above = (base > -8.0) & (shifted > -8.0)
    diff = (shifted - base - torch.log(gain)[:, None, None])[above]
    assert above.float().mean() > 0.9
    assert diff.abs().max() <= 1e-6 * base.abs().max()


def test_optimizer_matches_optax_adamw():
    """2,100 updates at steps_per_epoch 1000 (two staircase drops of the
    learning rate) against ``optax.adamw`` with the JAX trainer's
    settings: the learning rates equal, the parameters within 1e-6 of
    their largest |value|.  Measured: 6.6e-08 (181 of 425 elements
    differ in their last bits)."""
    rng = np.random.default_rng(0)
    shapes = [(16, 8, 3), (16,), (5, 1, 5, 1)]
    params = [rng.standard_normal(s).astype(np.float32) * 0.3
              for s in shapes]
    opt, sched = jax_voc.make_vocoder_optimizer(2e-4, steps_per_epoch=1000)
    jparams = [jnp.asarray(p) for p in params]
    jstate = opt.init(jparams)

    @jax.jit
    def jstep(p, s, g):
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    tparams = [torch.tensor(p) for p in params]
    topt = voc.VocoderAdamW(tparams, 2e-4, steps_per_epoch=1000)
    for count in (0, 1, 999, 1000, 1001, 1999, 2000, 2099):
        assert topt.schedule(count) == float(np.float32(sched(count))), count
    for i in range(2100):
        grads = [rng.standard_normal(s).astype(np.float32) * 1e-2
                 for s in shapes]
        jparams, jstate = jstep(jparams, jstate,
                                [jnp.asarray(g) for g in grads])
        topt.step([torch.from_numpy(g) for g in grads])
    assert topt.count == 2100
    for got, ref in zip(tparams, jparams):
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-6, err


# ---------------------------------------------------------------- GAN step

def _wav_batch(seed, n=2, length=SEG):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / 22050.0
    f0 = rng.uniform(150.0, 500.0, (n, 1))
    return (0.4 * np.sin(2 * np.pi * f0 * t)
            + 0.05 * rng.standard_normal((n, length))).astype(np.float32)


CASES = {
    "in_graph": dict(gen="hifigan"),
    "external_mel": dict(gen="istft", external_mel=True),
    "melgan": dict(gen="melgan"),
    "adv_warmup": dict(gen="hifigan", adv_warmup=2),
    "augmented": dict(gen="hifigan", aug_gain_db=6.0, aug_speed=(0.9, 1.1)),
}


def _generators(kind):
    if kind == "melgan":
        return (JaxMelGAN(**TINY_MELGAN, n_mel_channels=N_MELS),
                dict(TINY_MELGAN, arch="melgan"), melgan_from_jax_params)
    if kind == "istft":
        return (JaxHiFiGANiSTFT(**TINY_ISTFT, n_mel_channels=N_MELS),
                TINY_ISTFT, lambda p: hifigan_from_jax_params(p, 2, 1))
    return (JaxHiFiGAN(**TINY_HIFIGAN, n_mel_channels=N_MELS,
                       resblock_backend="xla"),
            TINY_HIFIGAN, lambda p: hifigan_from_jax_params(p, 4, 1))


@functools.lru_cache(maxsize=None)
def _gan_setup(case):
    """The same tiny generator and discriminators in both packages, from
    the JAX initialiser -> (the JAX trajectory: losses and state after
    each of 3 steps, a port step function, its initial state (a copy to
    keep), each step's inputs, the generator's map to the port, and the
    JAX draws of a step).  Memoized: the 1- and 3-step cases share one
    JAX compilation and trajectory."""
    opts = CASES[case]
    jgen, config, to_port = _generators(opts["gen"])
    external = opts.get("external_mel", False)
    aug_speed = opts.get("aug_speed")
    seg_in = int(np.ceil(SEG * aug_speed[1])) if aug_speed else SEG
    wavs = [_wav_batch(10 + i, length=seg_in) for i in range(3)]
    jdisc = JaxDiscriminators(**TINY_DISC)
    jmel = JaxMelSpectrogram(n_mel_channels=N_MELS)
    mel0 = jmel(jnp.asarray(wavs[0][:, :SEG]))[0][:, :, :SEG // 256]
    mel0 = mel0.transpose(0, 2, 1)
    gparams = _numpy(jax.jit(jgen.init)(jax.random.PRNGKey(0), mel0)[
        "params"])
    dparams = _numpy(jax.jit(jdisc.init)(jax.random.PRNGKey(1),
                                         jnp.asarray(wavs[0][:, :SEG]))[
        "params"])
    scale = 1.0 / float(np.log(10.0)) if opts["gen"] == "melgan" else 1.0
    kw = dict(mel_weight=45.0, external_mel=external, gen_input_scale=scale,
              adv_warmup=opts.get("adv_warmup", 0),
              aug_gain_db=opts.get("aug_gain_db", 0.0), aug_speed=aug_speed,
              out_segment=SEG, aug_seed=5)
    mels = [np.random.default_rng(20 + i).uniform(
        -8.0, 0.0, (2, SEG // 256, N_MELS)).astype(np.float32)
        for i in range(3)] if external else [None] * 3
    gopt, _ = jax_voc.make_vocoder_optimizer(2e-4)
    dopt, _ = jax_voc.make_vocoder_optimizer(2e-4)
    jstate = jax_voc.VocoderTrainState.create(gparams, dparams, gopt, dopt)
    jstep = jax.jit(jax_voc.make_vocoder_train_step(
        jgen, jdisc, jmel, gopt, dopt, **kw))
    trajectory = []
    for i in range(3):
        jstate, jlosses = jstep(jstate, *[jnp.asarray(x) for x in
                                          (wavs[i], mels[i])
                                          if x is not None])
        trajectory.append((jlosses, jstate))

    def port_state():
        gen = build_generator(dict(config, num_mels=N_MELS), fused=False)
        gen.load_state_dict(to_port(gparams))
        disc = HiFiGANDiscriminators(**TINY_DISC)
        disc.load_state_dict(discriminators_from_jax_params(dparams, (2, 3)))
        state = voc.VocoderTrainState(
            gen, disc, voc.VocoderAdamW(gen.parameters()),
            voc.VocoderAdamW(disc.parameters()), config)
        step = voc.make_vocoder_train_step(
            gen, disc, MelSpectrogram(n_mel_channels=N_MELS), **kw)
        return step, state

    return (trajectory, port_state, wavs, mels, to_port,
            lambda i: _jax_draws(5, i, 2, kw["aug_gain_db"], aug_speed))


def _jax_draws(seed, step, n, aug_gain_db, aug_speed):
    """The JAX step's own augmentation draws (``:161-177``) at ``step``."""
    if not (aug_gain_db or aug_speed):
        return None
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    g_rng, s_rng = jax.random.split(rng)
    draws = {"gain_db": None, "rates": None}
    if aug_speed is not None:
        draws["rates"] = torch.tensor(np.asarray(jax.random.uniform(
            s_rng, (n,), minval=aug_speed[0], maxval=aug_speed[1])))
    if aug_gain_db:
        draws["gain_db"] = torch.tensor(np.asarray(jax.random.uniform(
            g_rng, (n,), minval=-aug_gain_db, maxval=aug_gain_db)))
    return draws


# the five losses, relative to each loss (absolute below 1e-3), and the
# parameters after the steps, relative to each tensor's largest |value|
LOSS_RTOL = 1e-4
PARAM_RTOL = 1e-4


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gan_steps_match_jax(case, n_steps):
    """One and three GAN steps from the same parameters and inputs in both
    packages: the losses to LOSS_RTOL and both networks' parameters to
    PARAM_RTOL.  The augmented case passes the JAX step's draws in.  The
    float32 convolutions sum in other orders, and Adam's first updates
    are ~lr * sign(g), which magnifies the gradients' last bits.  The
    parameter error is relative to each tensor's largest |value|, floored
    at 1e-3 (the zero-initialised biases move by ~lr a step).  Measured
    over the 3 steps: losses 2.7e-07; parameters 2.1e-06 (in-graph), 1.3e-06
    (external mels), 7.6e-06 (MelGAN), 1.2e-06 (warmup), 6.9e-05
    (augmented: a bias of the generator; the largest absolute error of any
    weight is 6.0e-07)."""
    trajectory, port_state, wavs, mels, to_port, draws = _gan_setup(case)
    step, state = port_state()
    for i in range(n_steps):
        jlosses, jstate = trajectory[i]
        args = [torch.from_numpy(wavs[i])] + (
            [torch.from_numpy(mels[i])] if mels[i] is not None else [])
        state, losses = step(state, *args, draws=draws(i))
        assert list(losses) == list(jlosses) == list(voc.LOSS_NAMES)
        for k in voc.LOSS_NAMES:
            got, ref = float(losses[k]), float(jlosses[k])
            assert np.isfinite(got)
            assert abs(got - ref) <= LOSS_RTOL * max(abs(ref), 1e-3), \
                (case, i, k, got, ref)
    assert state.step == int(jstate.step) == n_steps
    warm = CASES[case].get("adv_warmup", 0)
    assert state.disc_opt.count == int(
        jstate.disc_opt_state[0].count) == max(n_steps - warm, 0)
    assert state.gen_opt.count == n_steps
    for module, ref in ((state.gen, to_port(_numpy(jstate.gen_params))),
                        (state.disc, discriminators_from_jax_params(
                            _numpy(jstate.disc_params), (2, 3)))):
        got = module.state_dict()
        assert set(got) == set(ref)
        for k in ref:
            r = ref[k].numpy()
            err = np.abs(got[k].numpy() - r).max() / max(np.abs(r).max(),
                                                         1e-3)
            assert err <= PARAM_RTOL, (case, k, err)


def test_warmup_holds_discriminators_and_their_count():
    """During adv_warmup the discriminators' parameters and optimizer
    state stay exactly as they were; the generator moves."""
    _, port_state, wavs, _, _, _ = _gan_setup("adv_warmup")
    step, state = port_state()
    before = {k: v.clone() for k, v in state.disc.state_dict().items()}
    gen_before = {k: v.clone() for k, v in state.gen.state_dict().items()}
    for i in range(2):
        step(state, torch.from_numpy(wavs[i]))
    assert state.disc_opt.count == 0
    assert all(torch.equal(before[k], v)
               for k, v in state.disc.state_dict().items())
    assert not all(torch.equal(gen_before[k], v)
                   for k, v in state.gen.state_dict().items())
    step(state, torch.from_numpy(wavs[2]))
    assert state.disc_opt.count == 1


def test_augmentation_draws_are_keyed_on_seed_and_step():
    a = voc.augmentation_draws(0, 3, 4, 6.0, (0.9, 1.1))
    b = voc.augmentation_draws(0, 3, 4, 6.0, (0.9, 1.1))
    c = voc.augmentation_draws(0, 4, 4, 6.0, (0.9, 1.1))
    assert torch.equal(a["rates"], b["rates"])
    assert torch.equal(a["gain_db"], b["gain_db"])
    assert not torch.equal(a["rates"], c["rates"])
    assert a["rates"].min() >= 0.9 and a["rates"].max() <= 1.1
    assert a["gain_db"].abs().max() <= 6.0
    assert voc.augmentation_draws(0, 0, 4) == {"gain_db": None,
                                                "rates": None}
    with pytest.raises(ValueError, match="aug_speed needs in-graph mels"):
        voc.make_vocoder_train_step(
            None, None, MelSpectrogram(n_mel_channels=N_MELS),
            external_mel=True, aug_speed=(0.9, 1.1))


# ------------------------------------------------------- samplers and scan

def _feature_corpus(root, n=4, hop=256, n_mels=N_MELS):
    """A preprocessed corpus of trimmed wavs with gt and predicted mels,
    clip i of 20 + 9 * i frames, and a train.txt naming all but one."""
    rng = np.random.default_rng(7)
    for d in ("wav", "mel", "mel_pred"):
        os.makedirs(os.path.join(root, d))
    names = []
    for i in range(n):
        frames = 20 + 9 * i
        base = f"clip{i}"
        names.append(base)
        np.save(os.path.join(root, "wav", f"spk-wav-{base}.npy"),
                rng.uniform(-0.5, 0.5, frames * hop).astype(np.float32))
        for d in ("mel", "mel_pred"):
            np.save(os.path.join(root, d, f"spk-mel-{base}.npy"),
                    rng.uniform(-8, 0, (frames, n_mels)).astype(np.float32))
    with open(os.path.join(root, "train.txt"), "w") as f:
        for base in names[1:]:
            f.write(f"{base}|spk|{{a}}|a\n")
    return names


def _wav_corpus(root, n=2, seconds=1.0):
    from fastspeech2_tpu_torch.audio.wav import save_wav

    os.makedirs(os.path.join(root, "spk0"))
    t = np.arange(int(22050 * seconds)) / 22050.0
    for i in range(n):
        save_wav(os.path.join(root, "spk0", f"u{i}.wav"),
                 (0.5 * np.sin(2 * np.pi * (220.0 + 110 * i) * t)).astype(
                     np.float32), 22050)


@pytest.mark.parametrize("source", ["pred", "gt", "mixed"])
def test_samplers_draw_the_same_segments_as_jax(tmp_path, source):
    """FinetuneSampler (with and without ``split``), TrimmedWavSampler and
    SegmentSampler: five batches each, bit for bit equal to the JAX
    samplers' from the same seed."""
    corpus, wavs = str(tmp_path / "corpus"), str(tmp_path / "wavs")
    _feature_corpus(corpus)
    _wav_corpus(wavs)
    for split in (None, "train.txt"):
        ref = jax_voc.FinetuneSampler(corpus, SEG, 256, source, 3, split)
        got = voc.FinetuneSampler(corpus, SEG, 256, source, 3, split)
        assert got.pairs == ref.pairs
        for _ in range(5):
            for a, b in zip(got.sample(4), ref.sample(4)):
                np.testing.assert_array_equal(a, b)
    pairs = [(jax_voc.TrimmedWavSampler(corpus, 3000, 4, "train.txt"),
              voc.TrimmedWavSampler(corpus, 3000, 4, "train.txt")),
             (jax_voc.SegmentSampler(wavs, SEG, 22050, 5),
              voc.SegmentSampler(wavs, SEG, 22050, 5))]
    for ref, got in pairs:
        assert got.paths == ref.paths
        for _ in range(5):
            np.testing.assert_array_equal(got.sample(3), ref.sample(3))


def test_scan_dispatch_and_schedule():
    """K = gcd(gcd(scan_step, log_step), save_step), raising at K <= 1; a
    dispatch's clips and starts are the JAX loop's draws from
    RandomState(seed + start_step) (``:681-689``), written out here as
    the JAX loop writes them; starts are frame-aligned with external
    mels."""
    assert voc.scan_dispatch(4, 100, 1000) == 4
    assert voc.scan_dispatch(8, 4, 1000) == 4
    with pytest.raises(ValueError, match="shares no factor"):
        voc.scan_dispatch(3, 100, 1000)
    hi = np.array([10, 0, 31])
    for external in (False, True):
        rng, ref_rng = (np.random.RandomState(7) for _ in range(2))
        for k in (4, 2):
            clips, starts = voc.scan_schedule(rng, k, 5, hi, external, 256)
            ref_clips = ref_rng.randint(0, len(hi), (k, 5))
            ref_starts = (ref_rng.random_sample((k, 5))
                          * (hi[ref_clips] + 1)).astype(np.int64)
            if external:
                ref_starts = ref_starts * 256
            np.testing.assert_array_equal(clips, ref_clips)
            np.testing.assert_array_equal(starts, ref_starts)


# --------------------------------------------------------------------- CLI

CLI_CONFIG = {
    "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
    "resblock_dilation_sizes": [[1, 3]], "segment_size": SEG,
    "num_mels": N_MELS, "learning_rate": 2e-4, "batch_size": 2,
    "discriminator": {"periods": [2, 3], "n_scales": 2,
                      "period_channels": [4, 8],
                      "scale_layers": [[8, 15, 1, 1], [16, 41, 4, 4],
                                       [16, 5, 1, 1]]},
}
LOG_LINE = re.compile(r"^Vocoder step (\d+)/(\d+): disc=(\S+), gen=(\S+), "
                      r"gen_adv=(\S+), gen_fm=(\S+), gen_mel=(\S+)$")


def _run_both(monkeypatch, argv, tmp_path, name):
    """The JAX and the port CLI's main on ``argv`` with out_dirs
    <tmp>/<name>_{jax,torch} -> (JAX result, JAX lines, port result, port
    lines)."""
    from fastspeech2_tpu.cli.train_vocoder_cli import main as jax_main
    from fastspeech2_tpu_torch.cli.train_vocoder_cli import main

    results = []
    for pkg, run, module in (("jax", jax_main, jax_voc),
                             ("torch", main, voc)):
        lines = []
        inner = module.train_vocoder

        def logged(*a, **kw):
            kw["log"] = lines.append
            return inner(*a, **kw)

        monkeypatch.setattr(module, "train_vocoder", logged)
        extra = ["--device", "cpu"] if pkg == "torch" else []
        results += [run(argv + ["--out_dir", str(tmp_path / f"{name}_{pkg}")]
                        + extra), lines]
        monkeypatch.setattr(module, "train_vocoder", inner)
    return results


def _steps(lines):
    found = [LOG_LINE.match(ln) for ln in lines]
    rows = [m.groups() for m in found if m]
    assert all(np.isfinite(float(v)) for r in rows for v in r[2:])
    return [(int(r[0]), int(r[1])) for r in rows]


def test_cli_logs_resumes_and_warm_starts_like_jax(tmp_path, monkeypatch):
    """3 steps on a wav corpus through both CLIs, then a rerun to 5 steps
    on the same out_dirs: the same log lines (step numbers, loss names,
    finite values; the values differ, the networks start from each
    package's own initialiser), the same resume line, a checkpoint at
    each end.  --init_gen_npz (the JAX snapshot layout) at learning rate
    0: the port's trained generator is exactly the snapshot; a snapshot
    without 'params' exits with the JAX CLI's message."""
    from fastspeech2_tpu.utils.params_io import save_variables_npz

    _wav_corpus(str(tmp_path / "wavs"))
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(CLI_CONFIG))
    base = ["--wav_dir", str(tmp_path / "wavs"), "--config", str(cfg),
            "--log_step", "1"]
    jstate, jlines, state, lines = _run_both(
        monkeypatch, base + ["--total_steps", "3", "--save_step", "3"],
        tmp_path, "run")
    assert _steps(lines) == _steps(jlines) == [(1, 3), (2, 3), (3, 3)]
    assert state.step == int(jstate.step) == 3
    assert os.path.exists(tmp_path / "run_torch" / "3.pth.tar")
    jstate, jlines, state, lines = _run_both(
        monkeypatch, base + ["--total_steps", "5", "--save_step", "5"],
        tmp_path, "run")
    assert lines[0] == jlines[0] == "Resumed vocoder training from step 3"
    assert _steps(lines) == _steps(jlines) == [(4, 5), (5, 5)]
    assert state.step == int(jstate.step) == 5
    assert state.gen_opt.count == state.disc_opt.count == 5
    assert os.path.exists(tmp_path / "run_torch" / "5.pth.tar")

    gen = JaxHiFiGAN(**{k: tuple(tuple(x) if isinstance(x, list) else x
                                  for x in v) if isinstance(v, list) else v
                        for k, v in CLI_CONFIG.items()
                        if k in ("upsample_rates", "upsample_kernel_sizes",
                                 "upsample_initial_channel",
                                 "resblock_kernel_sizes",
                                 "resblock_dilation_sizes")},
                     n_mel_channels=N_MELS)
    npz = str(tmp_path / "gen.npz")
    save_variables_npz(npz, jax.jit(gen.init)(jax.random.PRNGKey(7),
                                             jnp.zeros((1, 8, N_MELS))))
    from fastspeech2_tpu_torch.cli.train_vocoder_cli import main
    from fastspeech2_tpu_torch.utils.params_io import load_variables_npz

    state = main(base + ["--total_steps", "1", "--save_step", "1",
                         "--init_gen_npz", npz, "--learning_rate", "0",
                         "--out_dir", str(tmp_path / "warm"),
                         "--device", "cpu"])
    snapshot = hifigan_from_jax_params(load_variables_npz(npz), 4, 1)
    for k, v in state.gen.state_dict().items():
        torch.testing.assert_close(v, snapshot[k], rtol=0, atol=0)
    with pytest.raises(SystemExit, match="no 'params' collection"):
        bad = str(tmp_path / "bad.npz")
        np.savez(bad, **{"other/x": np.zeros(2, np.float16)})
        main(base + ["--out_dir", str(tmp_path / "bad"), "--init_gen_npz",
                     bad, "--device", "cpu"])


def test_cli_scan_mode_matches_jax_schedule(tmp_path, monkeypatch):
    """--scan_step 2 over 4 steps (log every 2, save at 4) through both
    CLIs on a preprocessed corpus with external mels: the same scan-mode
    line, the same device bank (bitwise), the same clips and frame-aligned
    starts of each dispatch (bitwise), and a log line at steps 2 and 4."""
    import fastspeech2_tpu.utils.jit_cache as jit_cache

    corpus = str(tmp_path / "corpus")
    _feature_corpus(corpus)
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(CLI_CONFIG))
    dispatches = {"jax": [], "torch": []}
    inner_jit = jit_cache.cached_jit

    def recording_jit(key, build):
        fn = inner_jit(key, build)
        if key[0] != "voc_scanned_step":
            return fn

        def run(state, bank, mel_bank, clips, starts):
            dispatches["jax"].append([np.asarray(x) for x in
                                      (bank, mel_bank, clips, starts)])
            return fn(state, bank, mel_bank, clips, starts)
        return run

    inner_scan = voc.make_scanned_vocoder_step

    def recording_scan(*args):
        scanned = inner_scan(*args)

        def run(state, bank, mel_bank, clips, starts):
            dispatches["torch"].append([x.numpy() for x in
                                        (bank, mel_bank, clips, starts)])
            return scanned(state, bank, mel_bank, clips, starts)
        return run

    monkeypatch.setattr(jit_cache, "cached_jit", recording_jit)
    monkeypatch.setattr(voc, "make_scanned_vocoder_step", recording_scan)
    jstate, jlines, state, lines = _run_both(
        monkeypatch, ["--finetune_from", corpus, "--mel_source", "mixed",
                      "--config", str(cfg), "--total_steps", "4",
                      "--log_step", "2", "--save_step", "4",
                      "--scan_step", "2"], tmp_path, "scan")
    assert lines[0] == jlines[0]
    assert lines[0].startswith("vocoder scan mode: 8 clips")
    assert _steps(lines) == _steps(jlines) == [(2, 4), (4, 4)]
    assert state.step == int(jstate.step) == 4
    assert len(dispatches["torch"]) == len(dispatches["jax"]) == 2
    for got, ref in zip(dispatches["torch"], dispatches["jax"]):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    assert os.path.exists(tmp_path / "scan_torch" / "4.pth.tar")
