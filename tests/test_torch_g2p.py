"""PyTorch port, the G2P tooling: the trainable seq2seq G2P
(``text/neural_g2p.G2PModel``), its trainer (``text/train_g2p.py``), the
lexicon miner (``text/mine_lexicon.py``) and ``tools/g2p_ensemble.py``,
held against the JAX package on the CPU.

The model's numbers come from JAX's initial parameters (the port draws
its own from Flax's distributions, other numbers by design).
Tolerances: teacher-forced logits 1e-5 of their largest |value|; a few
training steps at dropout 0 from JAX's initial parameters (epoch_fn of
fastspeech2_tpu/text/train_g2p.py, written out here as that function
builds it): the epoch losses 1e-5 relative, the parameters 1e-5 of each
tensor's largest |value| (floored at 1e-2) but for at most 0.1% of the
elements, which may differ by up to twice the summed learning rates (an
Adam step is at most about its rate, and Adam divides each gradient
element by its own size, so one whose gradient sits at the summation
noise steps either way: 4 of 32,768 elements of one tensor were off, by
up to 1.4e-04), and the attention key biases, whose gradient is 0 in
exact arithmetic (the softmax ignores a shift shared by every key), held
to the same 2 x the summed learning rates.  Splits, augmentation, the miner's
lexicon and stats and the roundtrip accuracy: exact.  Decodes of an npz
the port wrote, through both packages' NeuralG2P: equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastspeech2_tpu.text import mine_lexicon as jax_mine
from fastspeech2_tpu.text import train_g2p as jax_train
from fastspeech2_tpu.text.neural_g2p import NeuralG2P as JaxNeuralG2P
from fastspeech2_tpu.text.neural_g2p import _model
from fastspeech2_tpu_torch.text import mine_lexicon, train_g2p
from fastspeech2_tpu_torch.text.neural_g2p import (
    N_PHONES,
    PH_BOS,
    PH_PAD,
    G2PModel,
    NeuralG2P,
    decode,
    encode,
    encode_phones,
    encode_word,
    param_shapes,
    save_params,
)
from fastspeech2_tpu_torch.tools import g2p_ensemble
from fastspeech2_tpu_torch.training.optim import AdamW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEXICON = os.path.join(REPO, "lexicon", "ljspeech-mined.txt")
METADATA = [os.path.join(REPO, "preprocessed_data", "LJSpeech10", name)
            for name in ("train.txt", "val.txt")]
WORDS = ["cat", "oswald", "permission", "o'brien", "re-enter", "zyzzyva"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the suite runs beside other workers, and these
    small models gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict)
                   else {name: np.asarray(v)})
    return out


def _nest(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


@pytest.fixture(scope="module")
def jax_init():
    chars = jnp.asarray(np.stack([encode_word(w) for w in WORDS[:2]]))
    dec = jnp.zeros((2, 28), jnp.int32).at[:, 0].set(PH_BOS)
    params = _model().init(jax.random.PRNGKey(0), chars, dec)["params"]
    return _flat(jax.device_get(params))


def _teacher(words_phones):
    chars = np.stack([encode_word(w) for w, _ in words_phones])
    targets = np.stack([encode_phones(p) for _, p in words_phones])
    return chars, train_g2p.teacher_inputs(targets), targets


def test_teacher_forced_logits_match_jax(jax_init):
    """The module's logits against the Flax model's on the same
    parameters, and the NeuralG2P decoder's functions give the module's
    numbers bit for bit; the parameter names and shapes are Flax's."""
    assert {k: v.shape for k, v in jax_init.items()} == param_shapes()
    lex = [("oswald", ["AO1", "Z", "W", "AO0", "L", "D"]),
           ("cat", ["K", "AE1", "T"]), ("zyzzyva", ["Z", "IH1"])]
    chars, dec_in, _ = _teacher(lex)
    ref = np.asarray(_model().apply({"params": _nest(jax_init)},
                                    jnp.asarray(chars), jnp.asarray(dec_in)))
    model = G2PModel(params=jax_init).eval()
    with torch.no_grad():
        got = model(torch.as_tensor(chars), torch.as_tensor(dec_in))
        p = model.tensors()
        enc, cmask = encode(p, torch.as_tensor(chars))
        again = decode(p, enc, cmask, torch.as_tensor(dec_in))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    # the port's own init draws Flax's distributions
    fresh = G2PModel(seed=3).tensors()
    assert float(fresh["enc_norm/scale"].mean()) == 1.0
    assert abs(float(fresh["char_emb/embedding"].std()) - 128 ** -0.5) < 0.01


def _jax_epochs(params, chars, dec_in, targets, orders, lr, total_steps):
    """fastspeech2_tpu/text/train_g2p.py's loss_fn and epoch_fn at dropout
    0, as train() builds them."""
    model = _model(dropout=0.0)
    opt = optax.adamw(optax.cosine_decay_schedule(lr, total_steps),
                      weight_decay=1e-4)
    opt_state = opt.init(params)

    def loss_fn(params, c, di, tg):
        logits = model.apply({"params": params}, c, di, deterministic=True)
        mask = (tg != PH_PAD)
        ls = optax.softmax_cross_entropy(
            logits, optax.smooth_labels(jax.nn.one_hot(tg, N_PHONES), 0.05))
        return (ls * mask).sum() / mask.sum()

    @jax.jit
    def epoch_fn(params, opt_state, order):
        def body(carry, idx):
            params, opt_state = carry
            loss, grads = jax.value_and_grad(loss_fn)(
                params, chars[idx], dec_in[idx], targets[idx])
            updates, opt_state = opt.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), order)
        return params, opt_state, losses.mean()

    losses = []
    for order in orders:
        params, opt_state, loss = epoch_fn(params, opt_state,
                                           jnp.asarray(order))
        losses.append(float(loss))
    return losses, _flat(jax.device_get(params))


def test_training_steps_match_jax(jax_init):
    """Two epochs of 4 steps (batch 16) from JAX's initial parameters at
    dropout 0: the epoch losses and the parameters against epoch_fn."""
    pairs = jax_train.load_pairs(LEXICON)[:64]
    chars, dec_in, targets = _teacher([(w, p) for w, p, _, _ in pairs])
    rng = np.random.RandomState(0)
    orders = [rng.permutation(64).reshape(4, 16) for _ in range(2)]
    lr, total = 1e-3, 8
    ref_losses, ref = _jax_epochs(
        _nest({k: jnp.asarray(v) for k, v in jax_init.items()}),
        jnp.asarray(chars.astype(np.int32)),
        jnp.asarray(dec_in.astype(np.int32)),
        jnp.asarray(targets.astype(np.int32)), orders, lr, total)
    model = G2PModel(params=jax_init).train()
    opt = AdamW(model.parameters(), train_g2p.cosine_decay(lr, total),
                weight_decay=train_g2p.WEIGHT_DECAY)
    got_losses = [float(train_g2p.run_epoch(
        model, opt, torch.as_tensor(chars), torch.as_tensor(dec_in),
        torch.as_tensor(targets), torch.as_tensor(order)))
        for order in orders]
    np.testing.assert_allclose(got_losses, ref_losses, rtol=1e-5, atol=0)
    lr_sum = sum(train_g2p.cosine_decay(lr, total)(i) for i in range(8))
    off = n = 0
    for name, want in ref.items():
        diff = np.abs(model.tensors()[name].detach().numpy() - want)
        if name.endswith("/key/bias"):
            assert diff.max() <= 2 * lr_sum, name
            continue
        far = diff > 1e-5 * max(np.abs(want).max(), 1e-2)
        assert (diff[far] <= 2 * lr_sum).all(), name
        off += int(far.sum())
        n += diff.size
    assert off <= 1e-3 * n, (off, n)


def test_split_and_augmentation_match_jax():
    pairs = train_g2p.load_pairs(LEXICON)
    jpairs = jax_train.load_pairs(LEXICON)
    assert [(w, p) for w, p, _, _ in pairs] == [(w, p) for w, p, _, _
                                               in jpairs]
    train, held = train_g2p.split_pairs(pairs, 500, 0)
    jtrain, jheld = jax_train.split_pairs(jpairs, 500, 0)
    assert [w for w, *_ in held] == [w for w, *_ in jheld]
    assert [w for w, *_ in train] == [w for w, *_ in jtrain]
    exclude = {w for w, *_ in pairs} | {w for w, *_ in held}
    aug = train_g2p.augment_pairs(train[:2000], exclude)
    jaug = jax_train.augment_pairs(jtrain[:2000], exclude)
    assert len(aug) > 100
    assert [(w, p) for w, p, _, _ in aug] == [(w, p) for w, p, _, _
                                             in jaug]
    for (_, _, c, t), (_, _, jc, jt) in zip(aug, jaug):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(t, jt)
    assert train_g2p.phone_error_rate(["A", "B"], ["A", "C", "B"]) == \
        jax_train.phone_error_rate(["A", "B"], ["A", "C", "B"])


@pytest.fixture(scope="module")
def overfit(tmp_path_factory):
    """The port's mirror of tests/test_neural_g2p.py's overfit run: 32
    words of the mined lexicon, 120 epochs at batch 16, lr 2e-3."""
    from fastspeech2_tpu_torch.text.g2p import read_lexicon

    tmp = tmp_path_factory.mktemp("g2p")
    lex = read_lexicon(LEXICON)
    words = sorted(lex)[100:132]
    path = tmp / "mini.txt"
    path.write_text("".join(w + "\t" + " ".join(lex[w]) + "\n"
                            for w in words))
    out = str(tmp / "g2p.npz")
    report = train_g2p.train(str(path), out, heldout=0, epochs=120,
                             batch_size=16, lr=2e-3, device="cpu",
                             log=lambda *_: None)
    return lex, words, out, report


def test_overfit_and_greedy_decode(overfit):
    lex, words, out, report = overfit
    assert report["greedy"] is None and report["epoch_seconds"] > 0
    g2p = NeuralG2P(out, beam=1)
    hyps = g2p.batch(words)
    acc = np.mean([h == lex[w] for w, h in zip(words, hyps)])
    assert acc >= 0.9, (acc, list(zip(words, hyps))[:5])
    assert g2p(words[0]) == hyps[0]
    assert g2p("123") == []


def test_port_npz_decodes_the_same_in_jax(overfit):
    """The npz the port wrote (float16, the JAX layout) loads into the
    JAX package's NeuralG2P and decodes as the port's does, greedy and
    beam 4; beam_candidates gives every beam, best first by score."""
    lex, words, out, _ = overfit
    probe = words[:12] + WORDS
    for beam in (1, 4):
        assert JaxNeuralG2P(out, beam=beam).batch(probe) == \
            NeuralG2P(out, beam=beam).batch(probe)
    cands, scores = NeuralG2P(out, beam=4).beam_candidates(probe)
    assert scores.shape == (len(probe), 4) and len(cands[0]) == 4
    best = NeuralG2P(out, beam=4).batch(probe)
    assert [c[int(np.argmax(s))] for c, s in zip(cands, scores)] == best
    with np.load(out) as data:
        assert {k: data[k].dtype for k in data.files} == dict.fromkeys(
            param_shapes(), np.float16)


def test_save_params_matches_jax_layout(tmp_path, jax_init):
    from fastspeech2_tpu.text.neural_g2p import save_params as jax_save

    ours, theirs = tmp_path / "a.npz", tmp_path / "b.npz"
    save_params(str(ours), G2PModel(params=jax_init).tensors())
    jax_save(str(theirs), _nest(jax_init))
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_mine_lexicon_matches_jax(tmp_path):
    """The miner on the tracked 10-clip metadata: the same lexicon,
    stats, written file and roundtrip accuracy as the JAX package."""
    lex, stats = mine_lexicon.mine_lexicon(METADATA)
    jlex, jstats = jax_mine.mine_lexicon(METADATA)
    assert stats == jstats and stats["aligned"] == 10
    assert lex == jlex and len(lex) > 100
    mine_lexicon.write_lexicon(lex, str(tmp_path / "a.txt"))
    jax_mine.write_lexicon(jlex, str(tmp_path / "b.txt"))
    assert (tmp_path / "a.txt").read_text() == \
        (tmp_path / "b.txt").read_text()
    acc = mine_lexicon.roundtrip_accuracy(METADATA[0], lex)
    assert acc == jax_mine.roundtrip_accuracy(METADATA[0], jlex)
    assert acc > 0.9


def test_miner_majority_vote(tmp_path):
    """Variant pronunciations resolve to the most frequent one (the case
    of tests/test_mined_lexicon.py)."""
    path = tmp_path / "meta.txt"
    path.write_text("u1|S|{DH AH0 K AE1 T}|the cat\n"
                    "u2|S|{DH AH0 D AO1 G}|the dog\n"
                    "u3|S|{DH IY0 EH1 N D}|the end\n")
    lex, stats = mine_lexicon.mine_lexicon([str(path)])
    assert stats["aligned"] == 3
    assert lex["the"] == ["DH", "AH0"]
    assert lex["cat"] == ["K", "AE1", "T"]
    assert lex["end"] == ["EH1", "N", "D"]


def test_defaults_never_write_tracked_files(tmp_path, monkeypatch):
    """Both CLIs' default outputs lie under output/ (the JAX CLIs default
    to the tracked lexicon and G2P weights), and the miner's default
    metadata is the tracked corpus's."""
    for default in (train_g2p.DEFAULT_OUT, mine_lexicon.DEFAULT_OUT):
        assert default.split(os.sep)[0] == "output"
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(mine_lexicon, "write_lexicon",
                        lambda lex, out: written.append(out))
    written = []
    mine_lexicon.main([])
    assert written == [mine_lexicon.DEFAULT_OUT]


def test_g2p_ensemble_tunes_on_the_first_half():
    """The confidence threshold is chosen on the first half of the words
    and scored on the second (the JAX script chose it on the words it
    scored): a threshold that helps only the second half is not picked,
    and the second half's accuracy is reported at the first half's
    choice."""
    refs = [["A"], ["B"], ["C"], ["D"]]
    neural = [["A"], ["B"], ["X"], ["X"]]
    rules = [["Y"], ["Y"], ["C"], ["D"]]
    conf = np.asarray([-1.0, -1.0, -1.0, -1.0])
    sweep, best, test = g2p_ensemble.confidence_fallback(conf, rules, neural,
                                                         refs)
    # on the first half every threshold below -1 keeps the neural answers
    # (accuracy 1.0); above -1 the rules take over (0.0)
    assert sweep[best] == 1.0 and best < -1.0
    assert test == 0.0
