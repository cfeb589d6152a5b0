"""PyTorch port, the forced aligner: MFCC features, the emissions, one
Viterbi decode, one EM update, the full flat-start fit, the TextGrid writer
and the align CLI, each held against the JAX package on the CPU with the
same numpy inputs.

Tolerances:
- MFCC features: 1e-4 absolute on the CMVN'd features (O(1) values).  The
  log-mels under them differ by up to ~4e-4 in bins near the 1e-5 clamp
  (FFT libraries; test_torch_preprocessing.py), which the DCT over 80
  bins and the per-utterance CMVN shrink below 1e-4.
- Emissions: 1e-4 relative to the largest |log-likelihood| (the same
  float32 products in another order).
- Viterbi under identical Gaussians and features: paths exactly (ties
  break to the lower index in both).
- One EM update from identical paths: means and variances within 1e-5 of
  the largest |value| (float32 sums of up to ~1500 frames in another
  order).
- The full fit on the same features: the total log-likelihood of every EM
  iteration within 1e-5 relative (about 0.4 of a total near -4e4; the JAX
  totals are read from its printed lines, which carry one decimal); the
  durations are reported (printed; all equal when this was written), not
  gated: flat-start EM is sensitive to its platform
  (docs/native_training.md:32-46).
"""

import json
import os
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fastspeech2_tpu.align import aligner as jax_aligner
from fastspeech2_tpu.align.features import (
    alignment_features as jax_features,
)
from fastspeech2_tpu.align.textgrid_writer import (
    write_textgrid as jax_write_textgrid,
)
from fastspeech2_tpu.audio.stft import MelSpectrogram as JaxMel
from fastspeech2_tpu.cli import align_cli as jax_align_cli
from fastspeech2_tpu_torch.align import aligner
from fastspeech2_tpu_torch.align.features import alignment_features
from fastspeech2_tpu_torch.align.textgrid_writer import write_textgrid
from fastspeech2_tpu_torch.audio.stft import MelSpectrogram
from fastspeech2_tpu_torch.audio.wav import load_wav
from fastspeech2_tpu_torch.cli import align_cli
from fastspeech2_tpu_torch.preprocessing.textgrid import read_textgrid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW = os.path.join(REPO, "raw_data", "LJSpeech10", "LJSpeech")
TEXTGRIDS = os.path.join(REPO, "preprocessed_data", "LJSpeech10",
                         "TextGrid", "LJSpeech")
METADATA = os.path.join(REPO, "preprocessed_data", "LJSpeech10",
                        "train.txt")
CONFIG = os.path.join(REPO, "config", "LJSpeech10")
# the three shortest tracked clips (33, 37 and 67 phones)
CLIPS = ("LJ011-0202", "LJ042-0094", "LJ006-0114")
FEATURE_ATOL = 1e-4
N_ITERS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test suite runs several workers on the CPU at once; torch's own
    thread pool on top of them oversubscribes the cores, and the many small
    ops here (DIO's bands, the aligner's frame loop, a tiny model's steps)
    then wait on each other for tens of seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    """The clips' wavs, padded batch, phone tokens (the tracked metadata's,
    wrapped in optional edge silences) and both packages' features."""
    wavs = [load_wav(os.path.join(RAW, f"{c}.wav"), 22050)[0]
            for c in CLIPS]
    lengths = [len(w) for w in wavs]
    batch = np.zeros((len(wavs), max(lengths)), np.float32)
    for i, w in enumerate(wavs):
        batch[i, : len(w)] = w
    phones = align_cli.phones_from_metadata(METADATA)
    tokens = [align_cli._with_edge_silence(phones[c]) for c in CLIPS]
    got = alignment_features(batch, lengths, MelSpectrogram(), device="cpu")
    ref = jax_features(batch, lengths, JaxMel())
    return dict(batch=batch, lengths=lengths, tokens=tokens, got=got,
                ref=(np.asarray(ref[0]), np.asarray(ref[1])))


def _utterances(module, feats, n_frames, tokens):
    return [module.Utterance(feats=feats[i], n_frames=int(n_frames[i]),
                             tokens=t, optional=o)
            for i, (t, o) in enumerate(tokens)]


def test_features_match_jax(problem):
    got, n_got = problem["got"]
    ref, n_ref = problem["ref"]
    np.testing.assert_array_equal(n_got, n_ref)
    assert got.shape == ref.shape and got.shape[-1] == 39
    np.testing.assert_allclose(got, ref, atol=FEATURE_ATOL, rtol=0)


def test_edge_silence_and_metadata_match_jax():
    assert (align_cli.phones_from_metadata(METADATA)
            == jax_align_cli.phones_from_metadata(METADATA))
    for tokens in (["AA1", "B"], ["sil", "AA1", "sp"], ["sp"]):
        assert (align_cli._with_edge_silence(tokens)
                == jax_align_cli._with_edge_silence(tokens))


def _packed(problem, seed=0):
    """Both aligners set up on JAX's features with the same random
    Gaussians -> (port aligner, jax aligner, port pack, jax pack)."""
    feats, n_frames = problem["ref"]
    pack = {}
    out = []
    for module, kwargs in ((aligner, dict(device="cpu")), (jax_aligner, {})):
        a = module.ForcedAligner(n_states=3, **kwargs)
        utts = _utterances(module, feats, n_frames, problem["tokens"])
        types = sorted({a.key_of(t) for u in utts for t in u.tokens})
        a.type_of = {p: i for i, p in enumerate(types)}
        rng = np.random.RandomState(seed)
        n = len(types) * 3
        a.means = rng.randn(n, feats.shape[-1]).astype(np.float32)
        a.variances = rng.uniform(0.5, 2.0, (n, feats.shape[-1])
                                  ).astype(np.float32)
        pack[module] = a._pack(utts)
        out.append(a)
    return out[0], out[1], pack[aligner], pack[jax_aligner]


def test_emissions_match_jax(problem):
    port, ref, p, j = _packed(problem)
    got = aligner._emissions(p[0], p[1], torch.from_numpy(port.means),
                             torch.from_numpy(port.variances)).numpy()
    want = np.asarray(jax_aligner._emissions(
        j[0], j[1], jnp.asarray(ref.means), jnp.asarray(ref.variances)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)


def test_transition_masks_and_viterbi_match_jax(problem):
    """One decode under identical Gaussians: the masks, the scores and the
    recovered paths."""
    port, ref, p, j = _packed(problem)
    for a, b in ((p[4], j[4]), (p[5], j[5]), (p[6], j[6])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got_paths, got_ll = port._decode(p[0], p[1], p[4], p[5], p[6], p[7],
                                     p[8])
    ref_paths, ref_ll = ref._decode(j[0], j[1], j[4], j[5], j[6], j[7], j[8])
    np.testing.assert_array_equal(got_paths, ref_paths)
    np.testing.assert_allclose(got_ll, ref_ll, rtol=1e-5, atol=0)


def test_em_update_matches_jax(problem):
    """The statistics and the Gaussians of one hard-EM update from the
    flat-start paths."""
    port, ref, p, j = _packed(problem)
    n_gauss = len(port.type_of) * 3
    paths = aligner._flat_start_paths(p[3], p[8])
    np.testing.assert_array_equal(
        paths, jax_aligner._flat_start_paths(j[3], j[8]))
    got = aligner._update_gaussians(*(t.numpy() for t in aligner._accumulate(
        p[0], torch.from_numpy(paths).long(), p[1], p[7], n_gauss)), 0.01)
    want = jax_aligner._update_gaussians(*jax_aligner._accumulate(
        j[0], jnp.asarray(paths), j[1], j[7], n_gauss), 0.01)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(),
                                   rtol=0)


def _logliks(printed):
    """The total log-likelihoods a verbose fit prints, one per
    iteration."""
    return [float(x) for x in re.findall(r"loglik (-?[\d.]+)", printed)]


def test_fit_matches_jax(problem, capsys):
    """The flat-start fit of N_ITERS iterations on JAX's features: the
    total log-likelihood per iteration, and the durations (reported)."""
    feats, n_frames = problem["ref"]
    port = aligner.ForcedAligner(n_iters=N_ITERS, tol=0.0, device="cpu")
    got = port.fit(_utterances(aligner, feats, n_frames, problem["tokens"]),
                   verbose=True)
    got_ll = _logliks(capsys.readouterr().out)
    ref = jax_aligner.ForcedAligner(n_iters=N_ITERS, tol=0.0)
    want = ref.fit(_utterances(jax_aligner, feats, n_frames,
                               problem["tokens"]), verbose=True)
    ref_ll = _logliks(capsys.readouterr().out)
    assert len(got_ll) == len(ref_ll) == N_ITERS
    # the printed totals carry one decimal
    np.testing.assert_allclose(got_ll, ref_ll, rtol=1e-5, atol=0.05)
    same = [int(np.sum(a.durations == b.durations)) for a, b in zip(got,
                                                                    want)]
    for a, n in zip(got, n_frames):
        assert a.durations.sum() == n and np.isfinite(a.loglik)
    with capsys.disabled():
        print(f"\n[align fit] loglik per iteration port {got_ll}, JAX "
              f"{ref_ll}; phones with equal durations {same} of "
              f"{[len(a.durations) for a in want]}")


def test_transform_matches_jax(problem):
    """Viterbi alignment of a batch with already-fitted Gaussians (the
    CLI's path beyond em_utts), and its refusal of unseen phone types."""
    feats, n_frames = problem["ref"]
    out = {}
    for module, kwargs in ((aligner, dict(device="cpu")), (jax_aligner, {})):
        a = module.ForcedAligner(n_iters=2, tol=0.0, **kwargs)
        with pytest.raises(RuntimeError, match="call fit"):
            a.transform([])
        utts = _utterances(module, feats, n_frames, problem["tokens"])
        a.fit(utts[:2], phone_inventory=[t for u in utts for t in u.tokens])
        out[module] = a.transform(utts[2:])
        bad = module.Utterance(feats=feats[0], n_frames=int(n_frames[0]),
                               tokens=["ZZ"], optional=[False])
        with pytest.raises(KeyError, match="absent from the fitted model"):
            a.transform([bad])
    (got,), (want,) = out[aligner], out[jax_aligner]
    np.testing.assert_array_equal(got.durations, want.durations)
    assert got.durations.sum() == n_frames[2]
    np.testing.assert_allclose(got.loglik, want.loglik, rtol=1e-5)


def test_textgrid_writer_matches_jax(tmp_path):
    phones = ["sil", "DH", "AH0", "", "sp", "K"]
    durations = [3, 5, 0, 2, 0, 7]
    a = write_textgrid(str(tmp_path / "a" / "x.TextGrid"), phones,
                       durations, 256, 22050)
    b = jax_write_textgrid(str(tmp_path / "b" / "x.TextGrid"), phones,
                           durations, 256, 22050)
    with open(a) as f, open(b) as g:
        assert f.read() == g.read()
    tier = read_textgrid(a).get_tier_by_name("phones")
    assert [iv.text for iv in tier.intervals] == ["sil", "DH", "", "K"]


def test_align_cli_writes_partitions(tmp_path, capsys):
    """The CLI on a 3-clip layout, phones from the tracked metadata, on the
    CPU: every clip gets a TextGrid whose phone intervals partition its
    frames; each EM iteration prints its loglik."""
    raw = tmp_path / "raw" / "LJSpeech"
    os.makedirs(raw)
    for clip in CLIPS:
        for ext in ("wav", "lab"):
            shutil.copy(os.path.join(RAW, f"{clip}.{ext}"), raw)
    with open(os.path.join(CONFIG, "preprocess.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["path"].update(raw_path=str(tmp_path / "raw"),
                       preprocessed_path=str(tmp_path / "pre"))
    written = align_cli.align_corpus(cfg, phones_file=METADATA, n_iters=3,
                                     device="cpu")
    assert [os.path.basename(p) for p in written] == sorted(
        f"{c}.TextGrid" for c in CLIPS)
    printed = capsys.readouterr().out
    logliks = _logliks(printed)
    assert len(logliks) == 3 and all(np.isfinite(logliks))
    for path in written:
        clip = os.path.basename(path)[: -len(".TextGrid")]
        n = load_wav(os.path.join(RAW, f"{clip}.wav"), 22050)[0].shape[0]
        tier = read_textgrid(path).get_tier_by_name("phones")
        frames = [round(iv.end_time * 22050 / 256)
                  - round(iv.start_time * 22050 / 256)
                  for iv in tier.intervals]
        assert sum(frames) == n // 256 + 1 and min(frames) > 0
        assert tier.intervals[0].start_time == 0
    assert "Aligned 3 utterances" in printed


def test_align_cli_g2p_phones_match_jax():
    """Without a phones file the CLI takes the synthesis front end: the
    lexicon, then the neural G2P for OOV words, as the JAX CLI does."""
    with open(os.path.join(CONFIG, "preprocess.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["path"]["lexicon_path"] = os.path.join(REPO,
                                               cfg["path"]["lexicon_path"])
    for clip in CLIPS[:2]:
        with open(os.path.join(RAW, f"{clip}.lab")) as f:
            text = f.readline().strip()
        assert (align_cli.phones_from_text(text, cfg)
                == jax_align_cli.phones_from_text(text, cfg))


def test_preprocess_cli_align_runs_without_jax(tmp_path):
    """`python -m fastspeech2_tpu_torch.cli.preprocess_cli PRE.yaml --align
    --device cpu` on a copy of three clips, in a process where jax, flax
    and the JAX package cannot be imported: TextGrids, then features."""
    import subprocess
    import sys

    raw = tmp_path / "raw" / "LJSpeech"
    os.makedirs(raw)
    for clip in CLIPS:
        for ext in ("wav", "lab"):
            shutil.copy(os.path.join(RAW, f"{clip}.{ext}"), raw)
    with open(os.path.join(CONFIG, "preprocess.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["path"].update(raw_path=str(tmp_path / "raw"),
                       preprocessed_path=str(tmp_path / "pre"),
                       lexicon_path=os.path.join(
                           REPO, cfg["path"]["lexicon_path"]))
    path = tmp_path / "pre.yaml"
    path.write_text(yaml.safe_dump(cfg))
    code = ("import runpy, sys\n"
            "for m in ('jax', 'flax', 'fastspeech2_tpu'):\n"
            "    sys.modules[m] = None\n"
            "sys.argv = ['preprocess_cli'] + sys.argv[1:]\n"
            "runpy.run_module('fastspeech2_tpu_torch.cli.preprocess_cli', "
            "run_name='__main__')\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(path), "--align", "--device",
         "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert "Aligned 3 utterances" in proc.stdout
    pre = tmp_path / "pre"
    assert sorted(os.listdir(pre / "TextGrid" / "LJSpeech")) == sorted(
        f"{c}.TextGrid" for c in CLIPS)
    for kind in ("mel", "pitch", "energy", "duration", "wav"):
        assert len(os.listdir(pre / kind)) == 3, kind
    with open(pre / "stats.json") as f:
        stats = json.load(f)
    assert all(np.isfinite(v) for k in stats for v in stats[k])
