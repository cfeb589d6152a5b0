"""PyTorch port, data and tensor parallel (``parallel/``, the sharded FFT
blocks, the whole-batch statistics, ``--data_parallel`` for the vocoder
trainer and the serving replicas), on the CPU.

The ranks are processes started with ``spawn`` by
``parallel/launch.run_ranks``, over gloo, meeting through a FileStore
under the test's tmp directory; their functions live in
``fastspeech2_tpu_torch/tools/parallel_steps.py``, which imports no JAX.
One 4-rank world runs every acoustic task of this file (the ranks beyond
a task's mesh sit it out) and one 2-rank world the GAN tasks; the JAX
references are computed here, in the parent.  Each world is joined with
a timeout.

The tiny model of tests/helpers.py (2 heads, FFN 32) on batches whose
rows differ in mel_len and whose halves differ in valid frames, so a
mean of per-rank means, a per-rank BatchNorm or a per-rank max mel length
would show.  Tolerances, float32: the six losses 1e-5 relative; the
first step's gradient (summed over the data group, before the clip) 1e-5
of each tensor's largest |value| (floored at 1e-3 of the whole
gradient's largest); its global norm 1e-5 relative; parameters and the
BatchNorm running statistics 1e-5 of each tensor's largest |value|,
floored at 1e-2, but for at most 0.1% of the elements after the first
step and 3% after the third, which may be off by up to twice the summed
learning rates: an Adam step is at most about its rate, and Adam divides
each gradient element by its own size, so an element whose gradient sits
at the summation noise steps either way (the gradients are held to
1e-5; 4 of 26,619 elements after one step at dp 2); the parameters whose
gradient is 0 in exact arithmetic (``parallel_steps.ZERO_GRADIENT``:
w_ks.bias and the PostNet convs' biases before a training-mode
BatchNorm) within the same twice the summed learning rates; the running means after the first step, whose BatchNorm saw the
same biases, to 1e-5, and after the last to 1e-5 plus 0.2 x steps x the
summed learning rates.  Against the JAX
package (eval mode, as tests/test_torch_train.py's trajectory): losses
1e-4 relative, parameters 1e-4 of each tensor's largest |value| (floored
at 1e-2; w_ks.bias apart).  The GAN step: parameters 1e-5 of each
tensor's largest |value| (floored at 1e-3).  Serving replicas: the int16
wavs within 1 LSB, tails included.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastspeech2_tpu.configs.config import OptimConfig as JaxOptimConfig
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JaxFastSpeech2
from fastspeech2_tpu.parallel import make_mesh as jax_make_mesh
from fastspeech2_tpu.parallel import shard_variables
from fastspeech2_tpu.training.optim import make_optimizer
from fastspeech2_tpu.training.step import _apply_model
from fastspeech2_tpu_torch.configs.config import (
    FastSpeech2Config,
    OptimConfig,
    load_yaml_configs,
)
from fastspeech2_tpu_torch.parallel import (
    SINGLE,
    Mesh,
    make_mesh,
    shard_state_dict,
    split_dim,
)
from fastspeech2_tpu_torch.parallel.launch import run_ranks
from fastspeech2_tpu_torch.tools import parallel_steps
from fastspeech2_tpu_torch.training.loop import rank_rows
from fastspeech2_tpu_torch.training.optim import noam_schedule
from fastspeech2_tpu_torch.training.step import dropout_seed
from fastspeech2_tpu_torch.utils.params_io import from_jax_params
from helpers import init_variables, synthetic_batch, tiny_config
from test_torch_serving import TEXTS, _port
from test_torch_train import _tiny_workspace
from test_torch_serving import setup as serving_setup  # noqa: F401

WORLD_TIMEOUT = 150
TOL = 1e-5
JAX_TOL = 1e-4
OPTIM = dict(batch_size=4, betas=(0.9, 0.98), eps=1e-9, weight_decay=0.0,
             grad_clip_thresh=0.5, grad_acc_step=1, warm_up_step=4,
             anneal_steps=(2,), anneal_rate=0.3, mu_dtype="float32")
LAYOUTS = {"dp2": (2, 1, 1), "tp2": (1, 2, 1), "dp2xtp2": (2, 2, 1),
           "dp2xtp2_acc2": (2, 2, 2)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread here, as in the ranks: the suite runs beside
    other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.array(jax.device_get(tree))


def _port_config(jax_cfg):
    fields = FastSpeech2Config.__dataclass_fields__
    return FastSpeech2Config(**{f: getattr(jax_cfg, f) for f in fields})


def _batches(jax_cfg, B, seeds):
    out = []
    for s in seeds:
        b = synthetic_batch(jax_cfg, B=B, P=10, T=40, seed=s)
        halves = np.split(b["mel_lens"], 2)
        # rows of different lengths, halves of different valid counts
        assert len(set(b["mel_lens"].tolist())) > 1
        assert halves[0].sum() != halves[1].sum()
        out.append(b)
    return out


@pytest.fixture(scope="module")
def setup():
    jax_cfg = tiny_config(max_seq_len=48)
    cfg = _port_config(jax_cfg)
    batches = _batches(jax_cfg, 4, (11, 12, 13))
    acc_batches = _batches(jax_cfg, 8, (21, 22, 23))
    # a copy of the memoised initial variables: nothing here may donate
    # the arrays tests/helpers.py keeps
    variables = _numpy_tree(init_variables(JaxFastSpeech2(jax_cfg),
                                           batches[0]))
    rng = np.random.RandomState(0)
    for stats in variables["batch_stats"]["postnet"].values():
        stats["mean"] = (0.2 * rng.randn(*stats["mean"].shape)).astype(
            np.float32)
        stats["var"] = (1.0 + 0.2 * rng.uniform(-1, 1, stats["var"].shape)
                        ).astype(np.float32)
    state = {k: v.numpy() for k, v in from_jax_params(variables, cfg).items()}
    optim = OptimConfig(**OPTIM)
    base = dict(cfg=cfg, optim=optim, state=state, batches=batches,
                dropout=False)
    return dict(jax_cfg=jax_cfg, cfg=cfg, variables=variables, state=state,
                optim=optim, base=base, batches=batches,
                acc_batches=acc_batches)


def _spec(setup, layout, **kw):
    data, model, acc = LAYOUTS[layout]
    spec = dict(setup["base"], data=data, model=model)
    if acc > 1:
        spec.update(optim=OptimConfig(**dict(OPTIM, batch_size=8,
                                             grad_acc_step=acc)),
                    batches=setup["acc_batches"])
    spec.update(kw)
    return spec


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    """One 4-rank world running every acoustic task; the one-process runs
    of the same specs here, and the checkpoint the resume tasks read."""
    tmp = tmp_path_factory.mktemp("parallel")
    one = {name: parallel_steps.acoustic_steps(
        0, 1, _spec(setup, name, data=1, model=1)) for name in LAYOUTS}
    # the one-process run's checkpoint after 2 steps, for a resume at
    # dp 2 x tp 2
    ckpt_one = str(tmp / "ckpt_one")
    parallel_steps.acoustic_steps(0, 1, dict(
        setup["base"], data=1, model=1, batches=setup["batches"][:2],
        save_dir=ckpt_one))
    saved = torch.load(os.path.join(ckpt_one, "2.pth.tar"),
                       weights_only=True)
    tasks = [("acoustic_steps", _spec(setup, name)) for name in LAYOUTS]
    tasks += [("acoustic_steps", _spec(setup, "dp2xtp2", dropout=True,
                                       record_masks=True))] * 2
    tasks += [("acoustic_steps", _spec(setup, "dp2xtp2", train=False)),
              ("acoustic_steps", _spec(
                  setup, "dp2xtp2", batches=setup["batches"][:2],
                  save_dir=str(tmp / "ckpt_dp2xtp2"))),
              ("acoustic_steps", _spec(
                  setup, "dp2xtp2", batches=setup["batches"][2:],
                  state={k: v.numpy() for k, v in saved["model"].items()},
                  opt_state=saved["optimizer"], first_step=2))]
    # the train loop at dp 2 x tp 2 on a tiny synthetic corpus: 4 steps,
    # validation and checkpoints every 2
    argv, _ = _tiny_workspace(tmp / "loop")
    configs = load_yaml_configs(*argv[1::2])
    tasks.append(("loop_steps", dict(
        preprocess_config=configs[0], model_config=configs[1],
        train_config=configs[2], data=2, model=2, device="cpu")))
    # the train loop in scan mode (train.yaml's scan_step 500, log_step 2:
    # K = 2) at dp 2, dropout 0, and in one process here
    scan_configs = load_yaml_configs(*_tiny_workspace(tmp / "scan")[0][1::2])
    scan_configs[2]["step"].update(log_step=2, val_step=4, save_step=4)

    def scan_loop(name, data):
        train_cfg = dict(scan_configs[2], path={
            k: str(tmp / name / k) for k in ("ckpt_path", "log_path",
                                             "result_path")})
        return dict(preprocess_config=scan_configs[0],
                    model_config=scan_configs[1], train_config=train_cfg,
                    data=data, model=1, device="cpu", dropout=False)

    one["scan_loop"] = parallel_steps.loop_steps(0, 1,
                                                 scan_loop("scan_one", 1))
    tasks.append(("loop_steps", scan_loop("scan_dp2", 2)))
    ranks = run_ranks(parallel_steps.run_tasks, 4, (tasks,),
                      store_dir=str(tmp), timeout=WORLD_TIMEOUT)
    results = list(zip(*ranks))
    names = list(LAYOUTS) + ["dropout_a", "dropout_b", "eval", "save",
                             "resume_from_one", "loop", "scan_loop"]
    return dict(one=one, runs=dict(zip(names, results)), tmp=tmp,
                loop_configs=configs)


def _lr_sum(optim, cfg, n_steps):
    lr = noam_schedule(cfg.encoder_hidden, optim.warm_up_step,
                       optim.anneal_steps, optim.anneal_rate)
    return sum(float(lr(i)) for i in range(n_steps))


def _assert_state_close(got, ref, lr_sum, drift, max_share):
    """parallel_steps.state_errors within the bounds the module docstring
    gives: at most ``max_share`` of the parameter elements off by more
    than TOL, by at most 2 x ``lr_sum``, and so the ZERO_GRADIENT
    parameters; the running variances within TOL, the means within TOL +
    ``drift``."""
    err = parallel_steps.state_errors(got, ref, TOL)
    assert err["share"] <= max_share and err["far"] <= 2 * lr_sum, err
    assert err["zero_gradient"] <= 2 * lr_sum, err
    assert err["running_var"] <= TOL, err
    assert err["running_mean"] <= TOL + drift, err


def _check_against(got, ref, optim, cfg, n_steps):
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=TOL,
                               atol=0)
    floor = 1e-3 * max(np.abs(g).max() for g in ref["grads"].values())
    for k, g in ref["grads"].items():
        if any(re.fullmatch(p, k) for p in parallel_steps.ZERO_GRADIENT):
            continue
        np.testing.assert_allclose(
            got["grads"][k], g, rtol=0,
            atol=TOL * max(np.abs(g).max(), floor), err_msg=k)
    assert got["grad_norm"] == pytest.approx(ref["grad_norm"], rel=TOL)
    # after the first step the BatchNorm statistics saw the same biases
    _assert_state_close(got["after_first"], ref["after_first"],
                        _lr_sum(optim, cfg, 1), 0.0, 1e-3)
    lr_sum = _lr_sum(optim, cfg, n_steps)
    _assert_state_close(got["state"], ref["state"], lr_sum,
                        0.2 * n_steps * lr_sum, 3e-2)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_parallel_steps_match_one_process(setup, world, layout):
    """3 steps at the layout against the one-process steps on the same
    global batches (training mode, dropout 0): losses, the summed
    gradient and its clip norm, parameters and the PostNet's running
    statistics; every active rank ends with the same whole state."""
    data, model, acc = LAYOUTS[layout]
    runs = [r for r in world["runs"][layout] if r is not None]
    assert len(runs) == data * model
    assert sorted(r["place"] for r in runs) == sorted(
        (d, m) for d in range(data) for m in range(model))
    for r in runs[1:]:
        for k, v in runs[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)
    spec = _spec(setup, layout)
    _check_against(runs[0], world["one"][layout], spec["optim"],
                   setup["cfg"], 3)


def test_dropout_masks_follow_the_data_rank(world):
    """With dropout on: the ranks of one model group draw the same masks,
    the data ranks different ones, and a second run is bitwise the
    first."""
    a, b = world["runs"]["dropout_a"], world["runs"]["dropout_b"]
    by_place = {r["place"]: r for r in a}
    n = len(by_place[(0, 0)]["masks"])
    assert n > 0
    for d in range(2):
        for x, y in zip(by_place[(d, 0)]["masks"],
                        by_place[(d, 1)]["masks"]):
            np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y) for x, y in zip(
        by_place[(0, 0)]["masks"], by_place[(1, 0)]["masks"]))
    for ra, rb in zip(a, b):
        for k, v in ra["state"].items():
            np.testing.assert_array_equal(rb["state"][k], v, err_msg=k)
    assert dropout_seed(5, 1, 0) == dropout_seed(5, 1)
    assert dropout_seed(5, 1, 1) != dropout_seed(5, 1, 0)


def _jax_trajectory(setup, n_steps, mesh=None):
    """The JAX package's eval-mode steps (the trajectory machinery of
    tests/test_torch_train.py) on the global batches -> (losses,
    params), sharded over ``mesh`` when given.  The gradient and the
    optimizer's update are one jitted step: one compile, where the
    update's eager ops would compile one small program each per shape
    and sharding."""
    jax_cfg, variables = setup["jax_cfg"], setup["variables"]
    jax_model = JaxFastSpeech2(jax_cfg)
    optimizer, _ = make_optimizer(JaxOptimConfig(**OPTIM),
                                  jax_cfg.encoder_hidden)

    def loss(params, batch):
        losses, _, _ = _apply_model(jax_model, jax_cfg, params,
                                    variables["batch_stats"], batch, None,
                                    train=False)
        return losses.total, losses

    @jax.jit
    def step(params, opt_state, batch):
        grads, out = jax.grad(loss, has_aux=True)(params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, out

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    put = jnp.asarray
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        params = shard_variables({"params": params}, mesh)[0]["params"]
        sharding = NamedSharding(mesh, P("data"))
        put = lambda x: jax.device_put(np.asarray(x), sharding)  # noqa: E731
    opt_state = optimizer.init(params)
    losses = []
    for batch in setup["batches"][:n_steps]:
        params, opt_state, out = step(params, opt_state,
                                      {k: put(v) for k, v in batch.items()})
        losses.append([float(v) for v in out])
    return np.asarray(losses), from_jax_params(
        {"params": _numpy_tree(params)}, setup["cfg"])


def _assert_params_close(got, ref, tol):
    for name, want in ref.items():
        if name.endswith(("slf_attn.w_ks.bias", "running_mean",
                          "running_var", "num_batches_tracked")):
            # a gradient of 0 in exact arithmetic (above); the eval-mode
            # steps leave the BatchNorm statistics alone
            continue
        want = want.numpy()
        np.testing.assert_allclose(
            got[name], want, rtol=0,
            atol=tol * max(np.abs(want).max(), 1e-2), err_msg=name)


def test_dp_tp_matches_the_jax_trajectory(setup, world):
    """The port at dp 2 x tp 2 against the JAX package's unsharded
    eval-mode 3-step trajectory, through the same machinery as
    tests/test_torch_train.py."""
    ref_losses, ref_params = _jax_trajectory(setup, 3)
    run = world["runs"]["eval"][0]
    np.testing.assert_allclose(run["losses"], ref_losses, rtol=JAX_TOL,
                               atol=0)
    _assert_params_close(run["state"], ref_params, JAX_TOL)


def test_dp_tp_matches_a_jax_mesh_step(setup, world):
    """One step at dp 2 x tp 2 against the JAX step on make_mesh(data=4,
    model=2) over the 8 simulated devices (nothing donated)."""
    mesh = jax_make_mesh(data=4, model=2)
    ref_losses, ref_params = _jax_trajectory(setup, 1, mesh)
    run = world["runs"]["eval"][0]
    np.testing.assert_allclose(run["losses"][:1], ref_losses, rtol=JAX_TOL,
                               atol=0)
    _assert_params_close(run["after_first"], ref_params, JAX_TOL)


def test_checkpoints_resume_across_layouts(setup, world):
    """A checkpoint written at dp 2 x tp 2 holds the whole model and
    resumes in one process with the losses of an uninterrupted run; the
    one-process checkpoint resumes at dp 2 x tp 2 the same way."""
    saved = torch.load(os.path.join(world["tmp"], "ckpt_dp2xtp2",
                                    "2.pth.tar"), weights_only=True)
    assert set(saved["model"]) == set(setup["state"])
    for k, v in saved["model"].items():
        assert tuple(v.shape) == setup["state"][k].shape, k
    resumed = parallel_steps.acoustic_steps(0, 1, dict(
        setup["base"], data=1, model=1, batches=setup["batches"][2:],
        state={k: v.numpy() for k, v in saved["model"].items()},
        opt_state=saved["optimizer"], first_step=2))
    whole = world["one"]["dp2"]["losses"]
    np.testing.assert_allclose(resumed["losses"], whole[2:], rtol=TOL,
                               atol=0)
    runs = [r for r in world["runs"]["resume_from_one"] if r is not None]
    np.testing.assert_allclose(runs[0]["losses"], whole[2:], rtol=TOL,
                               atol=0)


def test_train_loop_under_dp_tp(world):
    """train() at dp 2 x tp 2: every rank trains the 4 steps (with the
    validation duty), rank 0 alone logs and writes log.txt and the
    checkpoints, and each checkpoint holds the whole model."""
    from fastspeech2_tpu_torch.configs.config import (
        FastSpeech2Config as Config,
    )
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2

    runs = world["runs"]["loop"]
    assert [r["step"] for r in runs] == [4] * 4
    assert [r["main"] for r in runs] == [True, False, False, False]
    assert any(ln.startswith("Step 4/4") for ln in runs[0]["log"])
    assert any(ln.startswith("Validation Step 4") for ln in runs[0]["log"])
    assert all(r["log"] == [] for r in runs[1:])
    pre, model_cfg, train_cfg = world["loop_configs"]
    assert sorted(os.listdir(train_cfg["path"]["ckpt_path"])) == [
        "2.pth.tar", "4.pth.tar"]
    whole = FastSpeech2(Config.build(pre, model_cfg)).state_dict()
    saved = torch.load(os.path.join(train_cfg["path"]["ckpt_path"],
                                    "4.pth.tar"), weights_only=True)
    assert {k: tuple(v.shape) for k, v in saved["model"].items()} == {
        k: tuple(v.shape) for k, v in whole.items()}
    assert len(saved["optimizer"]["mu"]) == len(list(
        FastSpeech2(Config.build(pre, model_cfg)).parameters()))
    assert os.path.exists(os.path.join(train_cfg["path"]["log_path"],
                                       "train", "log.txt"))


def test_scan_loop_under_dp_matches_one_process(world):
    """train() in scan mode at dp 2 (dropout 0): the one-process scan
    run's losses at every step, the whole batch's on both ranks; rank 0
    alone logs (the scan line among them) and writes the checkpoint."""
    runs, one = world["runs"]["scan_loop"], world["one"]["scan_loop"]
    assert [r["step"] for r in runs[:2]] == [4, 4]
    assert [r["main"] for r in runs] == [True, False, False, False]
    assert "scan mode: 3 batches in" in " ".join(one["log"])
    assert [ln.split(" device-resident")[0] for ln in runs[0]["log"]
            if ln.startswith("scan mode: ")] == [
        ln.split(" device-resident")[0] for ln in one["log"]
        if ln.startswith("scan mode: ")]
    assert any(ln.startswith("Step 4/4") for ln in runs[0]["log"])
    assert runs[1]["log"] == []
    assert len(one["losses"]) == 4
    np.testing.assert_allclose(np.stack(runs[0]["losses"]),
                               np.stack(one["losses"]), rtol=TOL, atol=0)
    np.testing.assert_array_equal(np.stack(runs[1]["losses"]),
                                  np.stack(runs[0]["losses"]))
    assert os.listdir(world["tmp"] / "scan_dp2" / "ckpt_path") == [
        "4.pth.tar"]


def test_sharding_rules_and_row_split(setup):
    """The Megatron rules on the port's names (QKV and w_1 on their
    output dim, fc and w_2 on their input dim, their biases replicated
    where the sum comes first), shards that concatenate back, each rank's
    rows of every micro-batch, and the one-process mesh."""
    state = {k: torch.as_tensor(v) for k, v in setup["state"].items()}
    dims = {k: split_dim(k) for k in state}
    assert dims["encoder.layer_stack.0.slf_attn.w_qs.weight"] == 0
    assert dims["encoder.layer_stack.0.slf_attn.w_vs.bias"] == 0
    assert dims["decoder.layer_stack.0.slf_attn.fc.weight"] == 1
    assert dims["decoder.layer_stack.0.slf_attn.fc.bias"] is None
    assert dims["decoder.layer_stack.0.pos_ffn.w_1.weight"] == 0
    assert dims["decoder.layer_stack.0.pos_ffn.w_2.weight"] == 1
    assert dims["decoder.layer_stack.0.pos_ffn.w_2.bias"] is None
    assert dims["postnet.convolutions.0.0.conv.weight"] is None
    assert sum(d is not None for d in dims.values()) == 10 * (
        setup["cfg"].encoder_layer + setup["cfg"].decoder_layer)
    shards = [shard_state_dict(state, r, 2) for r in range(2)]
    for k, v in state.items():
        if dims[k] is None:
            assert all(s[k] is v for s in shards)
        else:
            torch.testing.assert_close(
                torch.cat([s[k] for s in shards], dim=dims[k]), v,
                rtol=0, atol=0)
    batch = setup["acc_batches"][0]
    mesh = Mesh(2, 1, data_rank=1)
    rows = rank_rows(batch, mesh, 2)
    np.testing.assert_array_equal(rows["texts"],
                                  batch["texts"][[2, 3, 6, 7]])
    assert make_mesh(1, 1) is SINGLE
    with pytest.raises(ValueError, match="initialised"):
        make_mesh(2, 1)


def _gan_kwargs(root, **kw):
    from fastspeech2_tpu_torch.audio.wav import save_wav

    wavs = root / "wavs" / "spk0"
    if not wavs.exists():
        wavs.mkdir(parents=True)
        t = np.arange(22050) / 22050.0
        for i in range(2):
            save_wav(str(wavs / f"u{i}.wav"), (0.5 * np.sin(
                2 * np.pi * (220.0 + 110 * i) * t)).astype(np.float32),
                22050)
    return dict(dict(
        wav_dir=str(root / "wavs"), total_steps=2, batch_size=4,
        segment_size=2048, n_mel_channels=8,
        generator_config=dict(upsample_rates=(8, 8),
                              upsample_kernel_sizes=(16, 16),
                              upsample_initial_channel=32,
                              resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 3),),
                              gen_istft_n_fft=16, gen_istft_hop_size=4),
        discriminator_config=dict(
            periods=(2, 3), n_scales=2, period_channels=(4, 8),
            scale_layers=((8, 15, 1, 1), (16, 41, 4, 4), (16, 5, 1, 1))),
        log_step=1, save_step=2, aug_gain_db=3.0, aug_speed=(0.9, 1.1),
        device="cpu"), **kw)


@pytest.fixture(scope="module")
def gan_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gan")
    modes = {"normal": {}, "scan": dict(scan_step=2, total_steps=4,
                                        log_step=2)}
    kws = {m: _gan_kwargs(tmp, **kw) for m, kw in modes.items()}
    one = {m: parallel_steps.vocoder_steps(
        0, 1, dict(kw, out_dir=str(tmp / f"one_{m}")))
        for m, kw in kws.items()}
    tasks = [("vocoder_steps", dict(kw, out_dir=str(tmp / f"dp_{m}")))
             for m, kw in kws.items()]
    ranks = run_ranks(parallel_steps.run_tasks, 2, (tasks,),
                      store_dir=str(tmp), timeout=WORLD_TIMEOUT)
    return dict(one=one, dp=dict(zip(modes, zip(*ranks))), tmp=tmp)


@pytest.mark.parametrize("mode", ["normal", "scan"])
def test_gan_step_data_parallel_matches_one_process(gan_world, mode):
    """--data_parallel 2 with gain and speed augmentation (the draws made
    for the global batch, each rank taking its rows): the same losses
    and networks as one process; rank 0 alone logs and checkpoints."""
    one, (r0, r1) = gan_world["one"][mode], gan_world["dp"][mode]
    assert r1["log"] == []
    assert [ln.split(":")[0] for ln in r0["log"]] == \
        [ln.split(":")[0] for ln in one["log"]]
    for net in ("gen", "disc"):
        for k, want in one[net].items():
            np.testing.assert_array_equal(r0[net][k], r1[net][k])
            np.testing.assert_allclose(
                r0[net][k], want, rtol=0,
                atol=TOL * max(np.abs(want).max(), 1e-3), err_msg=k)
    last = gan_world["tmp"] / f"dp_{mode}"
    assert sorted(os.listdir(last)) == (
        ["2.pth.tar", "4.pth.tar"] if mode == "scan" else ["2.pth.tar"])


def test_gan_step_data_parallel_refuses(tmp_path):
    from fastspeech2_tpu_torch.training.vocoder import train_vocoder

    with pytest.raises(ValueError, match="not divisible by data_parallel"):
        train_vocoder(**_gan_kwargs(tmp_path, batch_size=3,
                                    out_dir=str(tmp_path / "o")),
                      data_parallel=2)
    with pytest.raises(ValueError, match="world of 2 ranks"):
        train_vocoder(**_gan_kwargs(tmp_path, out_dir=str(tmp_path / "o")),
                      data_parallel=2)


def test_serving_replicas_match_one_replica(serving_setup):
    """A Synthesizer over two CPU replicas: the batch bucket rounds up to a
    multiple of them (3 texts -> 4 rows, 2 a replica), each replica's
    PostNet sees the whole batch's max mel length, and the int16 wavs are
    the one-replica dispatch's, whole."""
    one = _port(serving_setup)
    two = _port(serving_setup, devices=["cpu", "cpu"])
    assert len(two.replicas) == 2
    assert two.replicas[1].model is not two.model
    wavs1, out1 = one.synthesize(TEXTS)
    wavs2, out2 = two.synthesize(TEXTS)
    assert out2.postnet_mel.shape[0] == out1.postnet_mel.shape[0] == 4
    np.testing.assert_array_equal(out2.mel_len.numpy(), out1.mel_len.numpy())
    for a, b in zip(wavs1, wavs2):
        assert a.shape == b.shape
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
    # a replica that zeroed from its own rows' max would change the tail
    # of its shorter rows: the rows differ in length across the replicas
    lens = out1.mel_len.numpy()
    assert lens[:2].max() != lens[2:].max()
