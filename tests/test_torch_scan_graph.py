"""PyTorch port, scan mode's step runner
(``training/step.py::make_scanned_train_step``): the step body that a CUDA
graph holds on the card, against the eager ``train_step`` and against the
JAX package's ``make_scanned_train_step``.

On the CPU the runner runs the graph's body eagerly on its static inputs,
set as the loop sets them (the batch copied in from the stack, the dropout
generators reseeded, ``NoamAdam.advance``): over 4 steps it must equal
``train_step`` fed the same batches bit for bit, losses, parameters,
buffers and moments, with dropout on.  ``NoamAdam`` must keep each
moment's storage, since a graph reads and writes it by address.  Against
JAX (dropout off in both, which cannot match across frameworks; the
PostNet's BatchNorm on batch statistics, as in training) the tolerances
are ``tests/test_torch_train.py``'s trajectory tests': 1e-4 relative on
the losses, 1e-4 of each tensor's largest |value| on the parameters and
the running statistics, but for at most 0.5% of the elements, which are
held to 2^-7 of the summed learning rates (the test says why).

The JAX imports sit inside the one test that needs them, so that the
``cuda``-marked test (a graph replay against eager ``train_step``, bit for
bit) also runs on a GPU host without JAX:

    python -m pytest tests/test_torch_scan_graph.py --noconftest -q -m cuda
"""

import copy

import numpy as np
import pytest
import torch

from fastspeech2_tpu_torch.configs.config import FastSpeech2Config, OptimConfig
from fastspeech2_tpu_torch.models.common import Dropout
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from fastspeech2_tpu_torch.training.optim import NoamAdam
from fastspeech2_tpu_torch.training.step import (
    BATCH_KEYS,
    make_scanned_train_step,
    train_step,
)

# warm-up 4 and an anneal at step 2 so four updates walk the schedule; a
# clip threshold the tiny model's gradients exceed
OPTIM = dict(batch_size=4, betas=(0.9, 0.98), eps=1e-9, weight_decay=0.0,
             grad_clip_thresh=0.5, grad_acc_step=1, warm_up_step=4,
             anneal_steps=(2,), anneal_rate=0.3)
# the stack's batches each step takes (a batch taken twice included)
INDICES = (2, 0, 1, 2)
TINY = dict(encoder_layer=2, decoder_layer=2, encoder_head=2, decoder_head=2,
            encoder_hidden=16, decoder_hidden=16, conv_filter_size=32,
            conv_kernel_size=(9, 1), vp_filter_size=16, n_bins=16,
            postnet_embedding_dim=16, postnet_n_convolutions=3,
            n_mel_channels=8, max_seq_len=64, pitch_min=-2.0, pitch_max=9.0,
            energy_min=-1.5, energy_max=8.0)


def _batch(cfg, B, P, T, seed):
    """A teacher-forced batch (tests/helpers.py::synthetic_batch's draws)."""
    rng = np.random.RandomState(seed)
    src_lens = rng.randint(P // 2, P + 1, size=B)
    texts = rng.randint(1, cfg.vocab_size - 1, size=(B, P))
    durations = rng.randint(1, 4, size=(B, P))
    for b in range(B):
        texts[b, src_lens[b]:] = 0
        durations[b, src_lens[b]:] = 0
        while durations[b].sum() > T:
            durations[b, durations[b].argmax()] -= 1
    mel_lens = durations.sum(1)
    mels = rng.randn(B, T, cfg.n_mel_channels).astype(np.float32)
    for b in range(B):
        mels[b, mel_lens[b]:] = 0.0
    return {
        "speakers": np.zeros(B, np.int32),
        "texts": texts.astype(np.int32),
        "src_lens": src_lens.astype(np.int32),
        "mels": mels,
        "mel_lens": mel_lens.astype(np.int32),
        "pitches": rng.uniform(cfg.pitch_min, cfg.pitch_max,
                               size=(B, P)).astype(np.float32),
        "energies": rng.uniform(cfg.energy_min, cfg.energy_max,
                                size=(B, P)).astype(np.float32),
        "durations": durations.astype(np.int32),
    }


def _stack(batches, device="cpu"):
    """Loader batches -> a shape group's stack, in batch_to_device's dtypes
    (integers as int64)."""
    out = {}
    for k in BATCH_KEYS:
        t = torch.from_numpy(np.stack([b[k] for b in batches]))
        out[k] = (t if t.is_floating_point() else t.long()).to(device)
    return out


def _assert_runs_equal(model_a, opt_a, model_b, opt_b):
    for (name, a), b in zip(model_a.state_dict().items(),
                            model_b.state_dict().values()):
        assert torch.equal(a, b), name
    for key in ("mu", "nu"):
        for i, (a, b) in enumerate(zip(getattr(opt_a, key),
                                       getattr(opt_b, key))):
            assert a.dtype == b.dtype and torch.equal(a, b), (key, i)
    assert opt_a.count == opt_b.count


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the tiny model's ops run faster without a pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# float32 and bfloat16 compute, one and two micro-batches, both moment
# dtypes, each in two of the four combinations
@pytest.mark.parametrize("dtype,acc,mu_dtype", [
    ("float32", 1, "float32"), ("float32", 2, "bfloat16"),
    ("bfloat16", 1, "bfloat16"), ("bfloat16", 2, "float32")])
def test_scanned_body_equals_train_step(dtype, acc, mu_dtype):
    """The runner's body on its static inputs (the CPU runs it eagerly)
    against train_step on each scheduled batch, dropout on: every step's
    losses, every parameter, buffer and moment, bit for bit."""
    cfg = FastSpeech2Config(**TINY)
    torch.manual_seed(0)
    model = FastSpeech2(cfg, dtype=getattr(torch, dtype)).train()
    ref_model = copy.deepcopy(model)
    optim = OptimConfig(**dict(OPTIM, grad_acc_step=acc, mu_dtype=mu_dtype))
    opt = NoamAdam(model.parameters(), optim, cfg.encoder_hidden)
    ref_opt = NoamAdam(ref_model.parameters(), optim, cfg.encoder_hidden)
    stack = _stack([_batch(cfg, 4, 10, 40, seed) for seed in (1, 2, 3)])
    scanned = make_scanned_train_step(model, opt, grad_acc_step=acc)
    for step, i in enumerate(INDICES):
        got = scanned(0, stack, i, step)
        want = train_step(ref_model, ref_opt,
                          {k: v[i].clone() for k, v in stack.items()}, step,
                          grad_acc_step=acc)
        assert torch.equal(torch.stack(list(got)),
                           torch.stack(list(want))), step
        assert torch.isfinite(torch.stack(list(got))).all()
    _assert_runs_equal(model, opt, ref_model, ref_opt)
    assert opt.mu[0].dtype == getattr(torch, mu_dtype)
    assert not scanned.graphs and opt.count == len(INDICES)
    # the runner's static inputs hold the last step's batch
    for k, v in stack.items():
        assert torch.equal(scanned.inputs[0][k], v[INDICES[-1]]), k


def test_noam_adam_keeps_each_moments_storage():
    """The moments and the step's scalars keep their storage across
    updates and load_state_dict (a CUDA graph reads and writes them by
    address); state_dict hands out copies; load_state_dict restores the
    values and refuses a moment of the wrong shape."""
    torch.manual_seed(3)
    params = [torch.randn(4, 3), torch.randn(5)]
    opt = NoamAdam(params, OptimConfig(**dict(OPTIM, mu_dtype="bfloat16")),
                   16)
    kept = [t.data_ptr() for t in opt.mu + opt.nu + [opt.lr, opt.c1, opt.c2]]
    for _ in range(2):
        opt.step([torch.randn_like(p) for p in params])
        assert [t.data_ptr() for t in opt.mu + opt.nu
                + [opt.lr, opt.c1, opt.c2]] == kept
    saved = opt.state_dict()
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(saved["mu"] + saved["nu"], opt.mu + opt.nu))
    after = [p.clone() for p in params]
    opt.step([torch.randn_like(p) for p in params])
    assert opt.count == 3 and not torch.equal(saved["nu"][0], opt.nu[0])
    opt.load_state_dict(saved)
    assert opt.count == 2
    assert [t.data_ptr() for t in opt.mu + opt.nu] == kept[:4]
    for key in ("mu", "nu"):
        for a, b in zip(getattr(opt, key), saved[key]):
            assert torch.equal(a, b)
    assert opt.mu[0].dtype == torch.bfloat16
    # the same update from the restored state gives the same parameters
    with torch.no_grad():
        for p, a in zip(params, after):
            p.copy_(a)
    grads = [torch.randn_like(p) for p in params]
    twin = NoamAdam([p.clone() for p in params],
                    OptimConfig(**dict(OPTIM, mu_dtype="bfloat16")), 16)
    twin.load_state_dict(saved)
    opt.step(grads)
    twin.step(grads)
    for a, b in zip(params, twin.params):
        assert torch.equal(a, b)
    bad = dict(saved, mu=[torch.zeros(3, 4)] + saved["mu"][1:])
    with pytest.raises(ValueError, match="shape"):
        opt.load_state_dict(bad)


def test_scanned_steps_match_jax_make_scanned_train_step(monkeypatch):
    """The JAX make_scanned_train_step over a stack and K = 4 indices
    against the port's scanned steps over the same stack and indices, from
    the same weights; dropout off in both (flax's Dropout replaced by the
    identity for the PostNet's fixed 0.5), float32, first moment float32.
    Over four steps a gradient element that nearly cancels carries each
    package's rounding noise, which Adam's division by its own size turns
    into a visible step: as in the trajectory tests, at most 0.5% of the
    elements may miss 1e-4 of their tensor's largest |value|, and those
    are held to 2^-7 of the summed learning rates."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from fastspeech2_tpu.configs.config import OptimConfig as JaxOptimConfig
    from fastspeech2_tpu.models.fastspeech2 import (
        FastSpeech2 as JaxFastSpeech2,
    )
    from fastspeech2_tpu.training import TrainState, make_optimizer
    from fastspeech2_tpu.training.step import (
        make_scanned_train_step as jax_make_scanned_train_step,
    )
    from fastspeech2_tpu_torch.utils.params_io import from_jax_params
    from helpers import init_variables, tiny_config

    class _NoDropout(nn.Module):
        rate: float = 0.0

        def __call__(self, x, deterministic=None, rng=None):
            return x

    monkeypatch.setattr(nn, "Dropout", _NoDropout)
    jax_cfg = tiny_config(encoder_layer=2, decoder_layer=2,
                          encoder_dropout=0.0, decoder_dropout=0.0,
                          vp_dropout=0.0,
                          attention_backend="xla", ffn_backend="xla")
    cfg = FastSpeech2Config(**{f: getattr(jax_cfg, f)
                               for f in FastSpeech2Config.__dataclass_fields__})
    batches = [_batch(cfg, 3, 10, 40, seed) for seed in (1, 2, 3)]
    jax_model = JaxFastSpeech2(jax_cfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.device_get(init_variables(jax_model, batches[0])))

    optim = dict(OPTIM, batch_size=3, mu_dtype="float32")
    optimizer, _ = make_optimizer(JaxOptimConfig(**optim),
                                  jax_cfg.encoder_hidden)
    state = TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), optimizer)
    scanned_jax = jax.jit(jax_make_scanned_train_step(
        jax_model, jax_cfg, optimizer, len(INDICES)))
    stacked = {k: jnp.asarray(np.stack([b[k] for b in batches]))
               for k in BATCH_KEYS}
    state, seq = scanned_jax(state, stacked,
                             jnp.asarray(INDICES, jnp.int32),
                             jax.random.PRNGKey(0))
    ref_losses = np.stack([np.asarray(v) for v in seq], axis=1)
    ref = from_jax_params({"params": jax.device_get(state.params),
                           "batch_stats": jax.device_get(state.batch_stats)},
                          cfg)

    model = FastSpeech2(cfg)
    model.load_state_dict(from_jax_params(variables, cfg))
    model.train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    opt = NoamAdam(model.parameters(), OptimConfig(**optim),
                   cfg.encoder_hidden)
    scanned = make_scanned_train_step(model, opt)
    stack = _stack(batches)
    got_losses = np.array([[float(v) for v in scanned(0, stack, i, step)]
                           for step, i in enumerate(INDICES)])
    np.testing.assert_allclose(got_losses, ref_losses, rtol=1e-4, atol=0)
    lr_sum = sum(float(opt.schedule(i)) for i in range(len(INDICES)))
    flipped = total = 0
    for name, got in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith("slf_attn.w_ks.bias") or (
                name.startswith("postnet.") and name.endswith(
                    ("conv.bias", "running_mean"))):
            # their gradients are 0 in exact arithmetic (the softmax
            # ignores a shift shared by every key; the training-mode
            # BatchNorm after each PostNet conv takes out its mean), so
            # Adam turns each package's rounding noise into full-size
            # steps of either sign; the BatchNorm's running mean takes up
            # its conv's bias
            continue
        want = ref[name].numpy()
        diff = np.abs(got.numpy() - want)
        close = diff <= 1e-4 * max(float(np.abs(want).max()), 1e-2)
        assert (diff[~close] <= 2 ** -7 * lr_sum).all(), name
        flipped += int((~close).sum())
        total += diff.size
    assert flipped <= 0.005 * total and total > 10000


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_replay_equals_eager_train_step(dtype):
    """On the card: two shape groups' graphs, each captured at its group's
    first step and replayed after, against train_step on the same batches,
    dropout on: every step's losses, every parameter, buffer and moment
    bit for bit; each graph's capture holds the model's K1 and K3
    launches and replays count them."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from fastspeech2_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = FastSpeech2Config(encoder_layer=1, decoder_layer=2,
                            max_seq_len=256, n_mel_channels=16)
    torch.manual_seed(0)
    model = FastSpeech2(cfg, dtype=getattr(torch, dtype)).to(device).train()
    ref_model = copy.deepcopy(model)
    optim = OptimConfig(**dict(OPTIM, mu_dtype="bfloat16"))
    opt = NoamAdam(model.parameters(), optim, cfg.encoder_hidden)
    ref_opt = NoamAdam(ref_model.parameters(), optim, cfg.encoder_hidden)
    stacks = [_stack([_batch(cfg, 4, 16, T, seed) for seed in (1, 2)],
                     device) for T in (96, 160)]
    scanned = make_scanned_train_step(model, opt)
    order = [(0, 0), (0, 1), (1, 1), (0, 0), (1, 0), (1, 1), (0, 1)]
    for step, (gi, i) in enumerate(order):
        got = scanned(gi, stacks[gi], i, step)
        want = train_step(ref_model, ref_opt,
                          {k: v[i].clone() for k, v in stacks[gi].items()},
                          step)
        assert torch.equal(torch.stack(list(got)),
                           torch.stack(list(want))), step
    torch.cuda.synchronize()
    _assert_runs_equal(model, opt, ref_model, ref_opt)
    assert sorted(scanned.graphs) == [0, 1]
    assert [g.replays for g in scanned.graphs.values()] == [3, 2]
    k1, k3 = ("K1_bf16", "K3_bf16") if dtype == "bfloat16" else ("K1", "K3")
    for g in scanned.graphs.values():
        assert g.launches[k1] == g.launches[k3] == 3
    assert scanned.launches()[k1] == 15 and scanned.pool_bytes() > 0
