"""PyTorch port, acoustic training: each training module held against the
JAX package on the same numpy inputs and weights, at a tiny size.

Dropout masks cannot match across frameworks (the two draw different
random bits), so the model-level parity tests run in eval mode, where the
forward is deterministic: the whole model's gradients and a 3-step
optimizer trajectory.  The JAX side reaches its Pallas kernels in
interpret mode (attention and FFN backends ``pallas_interpret``), so the
gradients run through K3's and K2's TPU formulas.  Train mode is covered
where it is deterministic: the PostNet's masked BatchNorm, and
tests/test_torch_model.py::test_training_mode_is_refused.

Tolerances: loss and Noam values 1e-6 (float32 sums of a few hundred
terms); one optimizer update 1e-6 absolute on O(1) parameters; the
BatchNorm 1e-5; the whole model's gradients 1e-4 of each tensor's largest
|gradient| (float32 through ~10 layers and their transposes, sums in
another order); the 3-step trajectory 1e-4 relative on the losses and
1e-4 of each tensor's largest |value| on the parameters (with a bfloat16
first moment, the few elements whose stored moment rounds one bfloat16
step apart are held to 2^-7 of the summed learning rates).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from fastspeech2_tpu.configs.config import OptimConfig as JaxOptimConfig
from fastspeech2_tpu.data import dataset as jax_dataset
from fastspeech2_tpu.data.synthetic import (
    generate_corpus as jax_generate_corpus,
)
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JaxFastSpeech2
from fastspeech2_tpu.models.fastspeech2 import (
    FastSpeech2Output as JaxFastSpeech2Output,
)
from fastspeech2_tpu.models.loss import fastspeech2_loss as jax_loss
from fastspeech2_tpu.models.postnet import _MaskedBatchNorm
from fastspeech2_tpu.training.optim import make_optimizer
from fastspeech2_tpu.training.optim import noam_schedule as jax_noam
from fastspeech2_tpu.training.step import _apply_model
from fastspeech2_tpu_torch.cli import synthesize_cli, train_cli
from fastspeech2_tpu_torch.configs.config import FastSpeech2Config, OptimConfig
from fastspeech2_tpu_torch.data import dataset
from fastspeech2_tpu_torch.data.synthetic import (
    generate_corpus,
    synthetic_preprocess_config,
)
from fastspeech2_tpu_torch.models.common import Dropout
from fastspeech2_tpu_torch.models.fastspeech2 import (
    FastSpeech2,
    FastSpeech2Output,
)
from fastspeech2_tpu_torch.models.loss import fastspeech2_loss
from fastspeech2_tpu_torch.models.postnet import MaskedBatchNorm
from fastspeech2_tpu_torch.training.checkpoint import latest_step
from fastspeech2_tpu_torch.training.optim import NoamAdam, noam_schedule
from fastspeech2_tpu_torch.training.step import train_step
from fastspeech2_tpu_torch.utils.params_io import from_jax_params
from helpers import init_variables, synthetic_batch, tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "LJSpeech10")
VOCODER = os.path.join(REPO, "weights", "vocoder_gen_mixed60k.npz")

# warm-up 4 and an anneal at step 2 so three updates walk the schedule;
# a clip threshold the tiny model's gradients exceed
OPTIM = dict(batch_size=3, betas=(0.9, 0.98), eps=1e-9, weight_decay=0.0,
             grad_clip_thresh=0.5, grad_acc_step=1, warm_up_step=4,
             anneal_steps=(2,), anneal_rate=0.3, mu_dtype="bfloat16")


def _numpy_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(jax.device_get(tree))


def _port_config(jax_cfg):
    fields = FastSpeech2Config.__dataclass_fields__
    return FastSpeech2Config(**{f: getattr(jax_cfg, f) for f in fields})


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)).long()
            if np.issubdtype(np.asarray(v).dtype, np.integer)
            else torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    """A tiny JAX model on the Pallas interpret backends, its weights (with
    random BatchNorm statistics) in the port, and three batches."""
    jax_cfg = tiny_config(max_seq_len=48, attention_backend="pallas_interpret",
                          ffn_backend="pallas_interpret")
    jax_model = JaxFastSpeech2(jax_cfg)
    batches = [synthetic_batch(jax_cfg, B=3, P=10, T=40, seed=s)
               for s in (1, 2, 3)]
    variables = _numpy_tree(init_variables(jax_model, batches[0]))
    rng = np.random.RandomState(0)
    for stats in variables["batch_stats"]["postnet"].values():
        stats["mean"] = (0.2 * rng.randn(*stats["mean"].shape)).astype(
            np.float32)
        stats["var"] = (1.0 + 0.2 * rng.uniform(-1, 1, stats["var"].shape)
                        ).astype(np.float32)
    cfg = _port_config(jax_cfg)

    def loss(params, batch):
        losses, _, _ = _apply_model(jax_model, jax_cfg, params,
                                    variables["batch_stats"], batch, None,
                                    train=False)
        return losses.total, losses

    # one compile serves every batch (they share their shapes)
    grad_fn = jax.jit(jax.grad(loss, has_aux=True))
    return grad_fn, jax_cfg, variables, cfg, batches


def _port_model(cfg, variables):
    model = FastSpeech2(cfg)
    model.load_state_dict(from_jax_params(variables, cfg))
    return model.eval()


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_scaled_close(got, ref, tol, name):
    # the floor: a gradient that is 0 in exact arithmetic (the key
    # projection's bias: softmax ignores a shift shared by every key) is
    # ~1e-8 of rounding noise in both packages
    scale = max(float(np.abs(ref).max()), 1e-2)
    np.testing.assert_allclose(got, ref, atol=tol * scale, rtol=0,
                               err_msg=name)


def test_eval_mode_gradients_match_jax(setup):
    grad_fn, _, variables, cfg, batches = setup
    batch = batches[0]
    grads, ref_losses = grad_fn(variables["params"], _jnp(batch))
    ref = from_jax_params({"params": _numpy_tree(grads)}, cfg)

    model = _port_model(cfg, variables)
    t = _tensors(batch)
    out = model(t["speakers"], t["texts"], t["src_lens"],
                mel_lens=t["mel_lens"], max_mel_len=t["mels"].shape[1],
                p_targets=t["pitches"], e_targets=t["energies"],
                d_targets=t["durations"])
    losses = fastspeech2_loss(cfg, out, t["mels"], t["pitches"],
                              t["energies"], t["durations"])
    losses.total.backward()
    np.testing.assert_allclose(
        [float(v.detach()) for v in losses], [float(v) for v in ref_losses],
        rtol=1e-6, atol=0)
    n = 0
    for name, p in model.named_parameters():
        _assert_scaled_close(p.grad.numpy(), ref[name].numpy(), 1e-4, name)
        n += 1
    assert n == len(ref) - 3 * cfg.postnet_n_convolutions  # BN buffers


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_eval_mode_trajectory_matches_jax_optimizer(setup, mu_dtype):
    """With a bfloat16 first moment, an element whose float32 moment lies
    within rounding of a bfloat16 rounding boundary may be stored one
    bfloat16 step apart in the two packages; its later updates then differ
    by up to 2^-8 of a step.  Such elements (at most 0.5%) are held to
    2^-7 of the summed learning rates instead."""
    grad_fn, jax_cfg, variables, cfg, batches = setup
    optim = dict(OPTIM, mu_dtype=mu_dtype)
    optimizer, schedule = make_optimizer(JaxOptimConfig(**optim),
                                         jax_cfg.encoder_hidden)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    opt_state = optimizer.init(params)
    ref_losses = []
    for batch in batches:
        grads, losses = grad_fn(params, _jnp(batch))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ref_losses.append([float(v) for v in losses])
    ref = from_jax_params({"params": _numpy_tree(params)}, cfg)
    lr_sum = sum(float(schedule(i)) for i in range(len(batches)))

    model = _port_model(cfg, variables)
    opt = NoamAdam(model.parameters(), OptimConfig(**optim),
                   cfg.encoder_hidden)
    got_losses = [[float(v) for v in train_step(model, opt, _tensors(b), i)]
                  for i, b in enumerate(batches)]
    np.testing.assert_allclose(got_losses, ref_losses, rtol=1e-4, atol=0)
    flipped = total = 0
    for name, p in model.named_parameters():
        if name.endswith("slf_attn.w_ks.bias"):
            # its gradient is 0 in exact arithmetic (the softmax ignores a
            # shift shared by every key), so Adam turns each package's
            # rounding noise into full-size steps of either sign; the
            # forward does not depend on it
            continue
        got, want = p.detach().numpy(), ref[name].numpy()
        diff = np.abs(got - want)
        close = diff <= 1e-4 * max(float(np.abs(want).max()), 1e-2)
        if mu_dtype == "float32":
            assert close.all(), (name, float(diff.max()))
        else:
            assert (diff[~close] <= 2 ** -7 * lr_sum).all(), name
            flipped += int((~close).sum())
        total += diff.size
    assert flipped <= 0.005 * total
    assert opt.mu[0].dtype == getattr(torch, mu_dtype)


def test_grad_accumulation_averages_micro_batches(setup):
    """grad_acc_step 2 on a batch of 4 (eval mode, deterministic): the
    update is the one from the mean of the two halves' gradients, and the
    losses are the halves' mean, as the JAX step's scan computes them."""
    _, jax_cfg, variables, cfg, _ = setup
    batch = _tensors(synthetic_batch(jax_cfg, B=4, P=10, T=40, seed=9))
    model = _port_model(cfg, variables)
    opt = NoamAdam(model.parameters(), OptimConfig(**OPTIM),
                   cfg.encoder_hidden)
    got = train_step(model, opt, batch, 0, grad_acc_step=2)

    ref_model = _port_model(cfg, variables)
    params = list(ref_model.parameters())
    grads, totals = [], []
    for half in (slice(0, 2), slice(2, 4)):
        micro = {k: v[half] for k, v in batch.items()}
        out = ref_model(micro["speakers"], micro["texts"], micro["src_lens"],
                        mel_lens=micro["mel_lens"], max_mel_len=40,
                        p_targets=micro["pitches"],
                        e_targets=micro["energies"],
                        d_targets=micro["durations"])
        losses = fastspeech2_loss(cfg, out, micro["mels"], micro["pitches"],
                                  micro["energies"], micro["durations"])
        grads.append(torch.autograd.grad(losses.total, params))
        totals.append(float(losses.total))
    ref_opt = NoamAdam(params, OptimConfig(**OPTIM), cfg.encoder_hidden)
    ref_opt.step([(a + b) / 2 for a, b in zip(*grads)])
    assert float(got.total) == pytest.approx(sum(totals) / 2, rel=1e-6)
    for a, b in zip(model.parameters(), params):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("keep", [None, [True, True, False, True]])
def test_masked_batchnorm_train_mode_matches_jax(keep):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, 5).astype(np.float32) * 2 + 0.5
    keep_np = (None if keep is None
               else np.asarray(keep * 3, bool).reshape(2, 6))
    bn = _MaskedBatchNorm(features=5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"scale": rng.rand(5).astype(np.float32) + 0.5,
              "bias": rng.randn(5).astype(np.float32)}
    stats = {"mean": rng.randn(5).astype(np.float32),
             "var": rng.rand(5).astype(np.float32) + 0.5}
    ref, mutated = bn.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        use_running_average=False,
        keep=None if keep_np is None else jnp.asarray(keep_np),
        mutable=["batch_stats"])
    assert set(variables["batch_stats"]) == {"mean", "var"}

    port = MaskedBatchNorm(5)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(params["scale"]))
        port.bias.copy_(torch.from_numpy(params["bias"]))
        port.running_mean.copy_(torch.from_numpy(stats["mean"]))
        port.running_var.copy_(torch.from_numpy(stats["var"]))
    port.train()
    got = port(torch.from_numpy(x),
               None if keep_np is None else torch.from_numpy(keep_np))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)
    new = mutated["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(new["mean"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(new["var"]), atol=1e-5, rtol=0)
    assert int(port.num_batches_tracked) == 1


@pytest.mark.parametrize("level", ["phoneme_level", "frame_level"])
@pytest.mark.parametrize("row_keep", [None, [True, False, True]])
def test_loss_matches_jax(level, row_keep):
    jax_cfg = tiny_config(pitch_feature_level=level,
                          energy_feature_level=level)
    rng = np.random.RandomState(3)
    B, P, T, Tc, M = 3, 7, 20, 16, jax_cfg.n_mel_channels
    V = P if level == "phoneme_level" else Tc
    src_len, mel_len = np.array([7, 4, 6]), np.array([16, 9, 12])
    fields = dict(
        mel=rng.randn(B, Tc, M), postnet_mel=rng.randn(B, Tc, M),
        pitch_prediction=rng.randn(B, V), energy_prediction=rng.randn(B, V),
        log_duration_prediction=rng.randn(B, P))
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    fields.update(
        duration_rounded=np.zeros((B, P), np.int32),
        src_pad_mask=np.arange(P)[None] >= src_len[:, None],
        mel_pad_mask=np.arange(Tc)[None] >= mel_len[:, None],
        src_len=src_len.astype(np.int32), mel_len=mel_len.astype(np.int32))
    # mel targets longer than the (decoder-truncated) output: cut to Tc
    targets = (rng.randn(B, T, M).astype(np.float32),
               rng.randn(B, V).astype(np.float32),
               rng.randn(B, V).astype(np.float32),
               rng.randint(0, 6, size=(B, P)).astype(np.int32))
    keep = None if row_keep is None else np.asarray(row_keep)
    ref = jax_loss(jax_cfg, JaxFastSpeech2Output(
        **{k: jnp.asarray(v) for k, v in fields.items()}),
        *(jnp.asarray(t) for t in targets),
        row_keep=None if keep is None else jnp.asarray(keep))
    got = fastspeech2_loss(
        _port_config(jax_cfg), FastSpeech2Output(
            **{k: torch.from_numpy(np.asarray(v)) for k, v in fields.items()}),
        *(torch.from_numpy(t) for t in targets),
        row_keep=None if keep is None else torch.from_numpy(keep))
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in ref], rtol=1e-6, atol=0)


def test_noam_schedule_matches_jax():
    args = (256, 4000, (300000, 400000, 500000), 0.3)
    ref, got = jax_noam(*args), noam_schedule(*args)
    # step 1, the end of warm-up, and past each anneal step
    for count in (0, 3999, 4000, 300000, 400000, 500001):
        np.testing.assert_allclose(float(got(count)), float(ref(count)),
                                   rtol=1e-6, atol=0)


def test_optimizer_updates_match_optax():
    """Three updates on the same gradients: clipping active, the first
    moment stored as bfloat16 between updates."""
    rng = np.random.RandomState(11)
    shapes = [(4, 3), (3,), (5, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * 2).astype(np.float32) for s in shapes]
             for _ in range(3)]
    optimizer, _ = make_optimizer(JaxOptimConfig(**OPTIM), 16)
    jp = [jnp.asarray(p) for p in params]
    state = optimizer.init(jp)
    port_params = [torch.from_numpy(p.copy()) for p in params]
    opt = NoamAdam(port_params, OptimConfig(**OPTIM), 16)
    for g in grads:
        updates, state = optimizer.update([jnp.asarray(x) for x in g], state,
                                          jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(x) for x in g])
        for a, b in zip(port_params, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)
    assert np.sqrt(sum((x ** 2).sum() for x in grads[0])) > 0.5  # clipped


def test_loader_batches_match_jax(tmp_path):
    corpus = str(tmp_path / "corpus")
    jax_generate_corpus(corpus, n_utterances=14, seed=5, val_size=3,
                        n_mels=8)
    other = str(tmp_path / "port_corpus")
    generate_corpus(other, n_utterances=14, seed=5, val_size=3, n_mels=8)
    for name in ("train.txt", "val.txt", "stats.json"):
        with open(os.path.join(corpus, name)) as a, \
                open(os.path.join(other, name)) as b:
            assert a.read() == b.read()
    pre = synthetic_preprocess_config(corpus, n_mels=8)
    kw = dict(batch_size=3, group_size=2, shuffle=True, drop_last=False,
              seed=4, text_bucket=8, mel_bucket=32, max_mel_len=64)
    ref = jax_dataset.BucketedLoader(
        jax_dataset.FeatureDataset("train.txt", pre), **kw)
    got = dataset.BucketedLoader(dataset.FeatureDataset("train.txt", pre),
                                 **kw)
    for epoch in (0, 1):
        pairs = list(zip(ref.epoch(epoch), got.epoch(epoch), strict=True))
        assert len(pairs) == 4
        for rb, gb in pairs:
            assert rb.keys() == gb.keys()
            for key in rb:
                np.testing.assert_array_equal(np.asarray(gb[key]),
                                              np.asarray(rb[key]))


def test_dropout_rate_scaling_and_reproducible_masks():
    x = torch.ones(200, 500)
    drop = Dropout(0.2)
    drop.eval()
    assert drop(x) is x
    drop.train()
    drop.generator = torch.Generator().manual_seed(17)
    y = drop(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.8))
    drop.generator = torch.Generator().manual_seed(17)
    again = drop(x)
    drop.generator = torch.Generator().manual_seed(18)
    other = drop(x)
    assert torch.equal(y, again)
    assert not torch.equal(y, other)


def _tiny_workspace(tmp_path, n_mels=8, total_step=4, val_size=4):
    corpus = str(tmp_path / "corpus")
    generate_corpus(corpus, n_utterances=12 + val_size, seed=3,
                    val_size=val_size, n_mels=n_mels)
    with open(f"{CONFIG}/model.yaml") as f:
        model_cfg = yaml.safe_load(f)
    model_cfg["transformer"].update(encoder_layer=1, decoder_layer=1,
                                    encoder_hidden=16, decoder_hidden=16,
                                    conv_filter_size=32)
    model_cfg["variance_predictor"]["filter_size"] = 16
    model_cfg["variance_embedding"]["n_bins"] = 16
    model_cfg["max_seq_len"] = 64
    model_cfg["postnet"] = {"embedding_dim": 16, "kernel_size": 5,
                            "n_convolutions": 3}
    with open(f"{CONFIG}/train.yaml") as f:
        train_cfg = yaml.safe_load(f)
    train_cfg["path"] = {k: str(tmp_path / k) for k in
                         ("ckpt_path", "log_path", "result_path")}
    train_cfg["optimizer"]["batch_size"] = 4
    train_cfg["step"].update(total_step=total_step, log_step=1, val_step=2,
                             save_step=2, synth_step=1000)
    train_cfg["bucket"] = {"text": 8, "mel": 32}
    paths = []
    for name, cfg in (("preprocess", synthetic_preprocess_config(
            corpus, n_mels=n_mels)), ("model", model_cfg),
            ("train", train_cfg)):
        path = tmp_path / f"{name}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        paths += [f"-{name[0]}", str(path)]
    return paths, train_cfg


def test_train_cli_logs_checkpoints_and_resumes(tmp_path, capsys):
    args, train_cfg = _tiny_workspace(tmp_path)
    model, _, step = train_cli.main(args + ["--device", "cpu",
                                            "--max_steps", "2"])
    out = capsys.readouterr().out
    assert step == 2
    assert "Step 1/2, Total Loss: " in out and "Step 2/2, " in out
    assert "Validation Step 2, Total Loss: " in out
    assert "Saved checkpoint at step 2" in out
    ckpt = train_cfg["path"]["ckpt_path"]
    assert latest_step(ckpt) == 2
    log = os.path.join(train_cfg["path"]["log_path"], "train", "log.txt")
    assert open(log).read().count("Total Loss") == 2

    _, opt, step = train_cli.main(args + ["--device", "cpu",
                                          "--restore_step", "-1"])
    out = capsys.readouterr().out
    assert "Resuming from step 2" in out
    assert "Step 3/4, " in out and "Step 4/4, " in out
    assert "Step 2/4" not in out
    assert step == 4 and opt.count == 4
    assert latest_step(ckpt) == 4
    with pytest.raises(SystemExit, match="float32"):
        train_cli.main(args + ["--device", "cpu", "--dtype", "bfloat16"])


def test_synthesize_from_a_port_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    args, train_cfg = _tiny_workspace(tmp_path, n_mels=80, total_step=2)
    train_cli.main(args + ["--device", "cpu"])
    wavs, out, paths = synthesize_cli.main(
        ["--mode", "single", "--text", "hello world", *args,
         "--restore_step", "2", "--vocoder_ckpt", VOCODER,
         "--device", "cpu", "--result_path", str(tmp_path / "result")])
    mel_len = int(out.mel_len[0])
    assert torch.isfinite(out.postnet_mel).all()
    assert wavs[0].shape == (mel_len * 256,)
    assert os.path.exists(paths[0])
    with pytest.raises(FileNotFoundError, match="no checkpoint for step 3"):
        synthesize_cli.main(
            ["--mode", "single", "--text", "hello", *args,
             "--restore_step", "3", "--vocoder_ckpt", VOCODER,
             "--device", "cpu"])


def test_config_dropout_and_optim_fields_match_jax():
    from fastspeech2_tpu.configs.config import (
        FastSpeech2Config as JaxFastSpeech2Config,
    )

    with open(f"{CONFIG}/train.yaml") as f:
        train_cfg = yaml.safe_load(f)
    assert dataclasses.asdict(OptimConfig.build(train_cfg)) == \
        dataclasses.asdict(JaxOptimConfig.build(train_cfg))
    defaults = JaxFastSpeech2Config()
    assert (FastSpeech2Config().encoder_dropout,
            FastSpeech2Config().vp_dropout) == (defaults.encoder_dropout,
                                                defaults.vp_dropout)


def test_evaluate_cli_matches_jax_cli(tmp_path, capsys):
    """Both evaluate CLIs on the same npz weights and synthetic val set
    (5 utterances at batch 4: the second batch is 1 real row and 3
    duplicates, left out of the means); float32 forwards, 1e-4."""
    from fastspeech2_tpu.cli.evaluate_cli import main as jax_main
    from fastspeech2_tpu.configs.config import (
        FastSpeech2Config as JaxFastSpeech2Config,
    )
    from fastspeech2_tpu.configs.config import load_yaml_configs
    from fastspeech2_tpu.utils.params_io import save_variables_npz
    from fastspeech2_tpu_torch.cli import evaluate_cli

    args, train_cfg = _tiny_workspace(tmp_path, val_size=5)
    pre, model_cfg, _ = load_yaml_configs(*args[1::2])
    jax_cfg = JaxFastSpeech2Config.build(pre, model_cfg)
    variables = dict(init_variables(JaxFastSpeech2(jax_cfg),
                                    synthetic_batch(jax_cfg, seed=6), seed=6))
    npz = str(tmp_path / "acoustic.npz")
    save_variables_npz(npz, variables)
    ref = jax_main(args + ["--weights_npz", npz])
    got = evaluate_cli.main(args + ["--weights_npz", npz, "--device", "cpu"])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0)
    assert "Validation Step 0, Total Loss: " in capsys.readouterr().out

    train_cli.main(args + ["--device", "cpu", "--max_steps", "2"])
    trained = evaluate_cli.main(args + ["--restore_step", "2",
                                        "--device", "cpu"])
    assert np.isfinite(trained).all() and trained != got


def test_evaluate_cli_reads_a_reference_torch_ckpt(tmp_path):
    """--torch_ckpt, through the loader the synthesize CLI shares: a
    .pth.tar written by the JAX package's exporter gives the JAX evaluate
    CLI's losses (1e-4) and the port's --weights_npz losses exactly."""
    from fastspeech2_tpu.cli.evaluate_cli import main as jax_main
    from fastspeech2_tpu.configs.config import (
        FastSpeech2Config as JaxFastSpeech2Config,
    )
    from fastspeech2_tpu.configs.config import load_yaml_configs
    from fastspeech2_tpu.convert.to_torch import save_torch_checkpoint
    from fastspeech2_tpu.utils.params_io import (
        load_variables_npz,
        save_variables_npz,
    )
    from fastspeech2_tpu_torch.cli import evaluate_cli

    args, _ = _tiny_workspace(tmp_path)
    pre, model_cfg, _ = load_yaml_configs(*args[1::2])
    jax_cfg = JaxFastSpeech2Config.build(pre, model_cfg)
    npz = str(tmp_path / "acoustic.npz")
    save_variables_npz(npz, dict(init_variables(
        JaxFastSpeech2(jax_cfg), synthetic_batch(jax_cfg, seed=7), seed=7)))
    # the checkpoint holds the snapshot's (fp16-rounded) values
    ckpt = str(tmp_path / "reference.pth.tar")
    save_torch_checkpoint(ckpt, load_variables_npz(npz), jax_cfg)
    ref = jax_main(args + ["--torch_ckpt", ckpt])
    got = evaluate_cli.main(args + ["--torch_ckpt", ckpt, "--device", "cpu"])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0)
    from_npz = evaluate_cli.main(args + ["--weights_npz", npz,
                                         "--device", "cpu"])
    assert got == from_npz
