"""PyTorch port, data preparation: DIO and YIN F0, the unvoiced
interpolation, the TextGrid reader, the phoneme averaging, the
Preprocessor on tracked clips, the corpus adapters, the MFA command line
and a 3-step training on the port's own features, each held against the
JAX package on the CPU with the same numpy inputs.

Tolerances:
- F0 (DIO, YIN): voicing agrees on at least F0_VOICING_SHARE of frames and
  F0 on jointly voiced frames to F0_RTOL relative.  Both packages compute
  in float32 with FFTs of different libraries (PocketFFT through torch,
  XLA's through JAX) over up to 2^19 samples; the zero-crossing positions
  and harmonic phases then agree to ~1e-6 relative (2.4e-6 at most on
  these signals when this was written), and a frame whose score sits at a
  voicing threshold may flip.
- The Preprocessor: durations, phones and the trimmed wavs exactly; the
  mel before its log within 1e-5 of its largest value and the log-mel
  within 1e-3 (the log of bins near the 1e-5 clamp turns the FFT
  libraries' ~1e-8 absolute differences into ~1e-4, 4.0e-4 at most here;
  test_torch_audio.py holds MelSpectrogram alike), the normalized phone
  energy and pitch within 1e-4, stats.json within 1e-4, train.txt and
  val.txt as sets (the JAX package shuffles them unseeded).
- The 3-step training: the losses of each step within 1e-4 relative, the
  bound of test_torch_train.py's trajectory test on identical batches;
  the features here differ by the amounts above.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from fastspeech2_tpu.audio.dio import dio_f0 as jax_dio
from fastspeech2_tpu.audio.f0 import interpolate_unvoiced as jax_interp
from fastspeech2_tpu.audio.f0 import yin_f0 as jax_yin
from fastspeech2_tpu.preprocessing import PREPARE_ALIGN as JAX_PREPARE
from fastspeech2_tpu.preprocessing import Preprocessor as JaxPreprocessor
from fastspeech2_tpu.preprocessing import mfa as jax_mfa
from fastspeech2_tpu.preprocessing.preprocessor import (
    _phoneme_average as jax_phoneme_average,
)
from fastspeech2_tpu.preprocessing.textgrid import (
    read_textgrid as jax_read_textgrid,
)
from fastspeech2_tpu_torch.audio.dio import dio_f0
from fastspeech2_tpu_torch.audio.f0 import interpolate_unvoiced, yin_f0
from fastspeech2_tpu_torch.audio.wav import load_wav
from fastspeech2_tpu_torch.cli import preprocess_cli
from fastspeech2_tpu_torch.preprocessing import mfa
from fastspeech2_tpu_torch.preprocessing.corpora import PREPARE_ALIGN
from fastspeech2_tpu_torch.preprocessing.preprocessor import (
    Preprocessor,
    _phoneme_average,
)
from fastspeech2_tpu_torch.preprocessing.textgrid import read_textgrid
from test_dio_accuracy import AMPS, FS, HOP, _harmonic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW = os.path.join(REPO, "raw_data", "LJSpeech10", "LJSpeech")
TEXTGRIDS = os.path.join(REPO, "preprocessed_data", "LJSpeech10",
                         "TextGrid", "LJSpeech")
CONFIG = os.path.join(REPO, "config", "LJSpeech10")
F0_VOICING_SHARE = 0.99
F0_RTOL = 1e-4
# three clips whose trimmed wavs share one 32768-sample bucket (131072), so
# each package compiles or plans one DSP shape
CLIPS = ("LJ006-0114", "LJ006-0161", "LJ009-0038")
FEATURE_ATOL = 1e-4
STATS_ATOL = 1e-4
SECONDS = 3


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


# ---- F0 ---------------------------------------------------------------------

def _signals():
    """3 s each, so every DIO call here shares one JAX compile: the glide,
    vibrato and noisy (5 dB SNR) signals of test_dio_accuracy.py, pure
    noise, and two tracked clips cut to their first 3 s."""
    T = SECONDS * FS
    t = np.arange(T) / FS
    rng = np.random.RandomState(1)
    noisy = _harmonic(160.0 + 30.0 * np.sin(2 * np.pi * 1.2 * t))
    n = rng.randn(T).astype(np.float32)
    n *= np.sqrt((noisy ** 2).mean() / (n ** 2).mean()) * 10 ** (-5 / 20)
    out = {
        "glide": _harmonic(120.0 * 2 ** (t / 2.0)),
        "vibrato": _harmonic(200.0 + 6.0 * np.sin(2 * np.pi * 5.0 * t),
                             amps=AMPS),
        "noisy": (noisy + n).astype(np.float32),
        "noise": np.random.RandomState(0).randn(T).astype(np.float32),
    }
    for clip in ("LJ001-0012", "LJ011-0202"):
        wav, _ = load_wav(os.path.join(RAW, f"{clip}.wav"), FS)
        out[clip] = wav[:T].astype(np.float32)
    return out


SIGNALS = _signals()


@pytest.mark.parametrize("estimator", ["dio", "yin"])
@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_f0_matches_jax(name, estimator):
    y = SIGNALS[name]
    port_fn, jax_fn = {"dio": (dio_f0, jax_dio),
                       "yin": (yin_f0, jax_yin)}[estimator]
    ref = np.asarray(jax_fn(y, FS, HOP))
    got = port_fn(torch.from_numpy(y), FS, HOP).numpy()
    assert got.shape == ref.shape == (1 + len(y) // HOP,)
    assert ((got > 0) == (ref > 0)).mean() >= F0_VOICING_SHARE
    both = (got > 0) & (ref > 0)
    np.testing.assert_allclose(got[both], ref[both], rtol=F0_RTOL, atol=0)
    # the batched call (the Preprocessor's DSP batch) gives each row's F0
    # to the same bounds (a batched FFT may sum in another order)
    row = port_fn(torch.from_numpy(np.stack([y, y[::-1].copy()])), FS,
                  HOP)[0].numpy()
    assert ((row > 0) == (got > 0)).mean() >= F0_VOICING_SHARE
    both = (row > 0) & (got > 0)
    np.testing.assert_allclose(row[both], got[both], rtol=F0_RTOL, atol=0)


def test_interpolate_unvoiced_matches_jax():
    rng = np.random.RandomState(3)
    f0 = rng.uniform(80, 300, 200) * (rng.uniform(size=200) > 0.4)
    for x in (f0, np.zeros(7), f0[:1]):
        np.testing.assert_array_equal(interpolate_unvoiced(x), jax_interp(x))


def test_phoneme_average_matches_jax():
    rng = np.random.RandomState(4)
    durations = rng.randint(0, 5, 40)
    values = rng.randn(int(durations.sum()))
    np.testing.assert_array_equal(_phoneme_average(values, durations),
                                  jax_phoneme_average(values, durations))


def test_textgrid_reader_matches_jax(tmp_path):
    """Every tracked TextGrid, and a short-format one."""
    names = sorted(os.listdir(TEXTGRIDS))
    assert len(names) == 10
    short = tmp_path / "short.TextGrid"
    short.write_text('File type = "ooTextFile"\nObject class = "TextGrid"\n'
                     '\n0\n1.5\n<exists>\n1\n"IntervalTier"\n"phones"\n0\n'
                     '1.5\n2\n0\n0.5\n"sil"\n0.5\n1.5\n"AA1"\n')
    for path in [os.path.join(TEXTGRIDS, n) for n in names] + [str(short)]:
        got, ref = read_textgrid(path), jax_read_textgrid(path)
        assert [(t.name, [(i.start_time, i.end_time, i.text)
                          for i in t.intervals]) for t in got.tiers] == [
            (t.name, [(i.start_time, i.end_time, i.text)
                      for i in t.intervals]) for t in ref.tiers]
        assert got.get_tier_by_name("phones").intervals


# ---- the Preprocessor on tracked clips ---------------------------------------

def _layout(root, clips=CLIPS):
    """raw/LJSpeech/{clip}.{wav,lab} + pre/TextGrid/LJSpeech/{clip}.TextGrid
    under ``root`` -> the LJSpeech10 preprocess config pointed there."""
    raw = os.path.join(root, "raw", "LJSpeech")
    tg = os.path.join(root, "pre", "TextGrid", "LJSpeech")
    os.makedirs(raw)
    os.makedirs(tg)
    for clip in clips:
        for ext in ("wav", "lab"):
            shutil.copy(os.path.join(RAW, f"{clip}.{ext}"), raw)
        shutil.copy(os.path.join(TEXTGRIDS, f"{clip}.TextGrid"), tg)
    with open(os.path.join(CONFIG, "preprocess.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["path"].update(raw_path=os.path.join(root, "raw"),
                       preprocessed_path=os.path.join(root, "pre"))
    cfg["preprocessing"]["val_size"] = 1
    return cfg


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    """The 3 clips through both preprocessors: JAX one utterance per
    dispatch (one compile), the port through its CLI at the config's
    dsp_batch_size (4) -> (jax config, port config)."""
    root = tmp_path_factory.mktemp("pre")
    jax_cfg = _layout(str(root / "jax"))
    jax_cfg["preprocessing"]["dsp_batch_size"] = 1
    JaxPreprocessor(jax_cfg).build_from_path()
    port_cfg = _layout(str(root / "torch"))
    path = root / "torch" / "preprocess.yaml"
    path.write_text(yaml.safe_dump(port_cfg))
    preprocess_cli.main([str(path), "--device", "cpu"])
    return jax_cfg, port_cfg


def _feature(cfg, kind, clip):
    return np.load(os.path.join(cfg["path"]["preprocessed_path"], kind,
                                f"LJSpeech-{kind}-{clip}.npy"))


def test_preprocessor_matches_jax(preprocessed):
    jax_cfg, port_cfg = preprocessed
    for clip in CLIPS:
        np.testing.assert_array_equal(_feature(port_cfg, "duration", clip),
                                      _feature(jax_cfg, "duration", clip))
        np.testing.assert_array_equal(_feature(port_cfg, "wav", clip),
                                      _feature(jax_cfg, "wav", clip))
        got, ref = _feature(port_cfg, "mel", clip), _feature(jax_cfg, "mel",
                                                              clip)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        lin = np.exp(ref.astype(np.float64))
        np.testing.assert_allclose(np.exp(got.astype(np.float64)), lin,
                                   atol=1e-5 * lin.max(), rtol=0)
        np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
        for kind in ("pitch", "energy"):
            got, ref = (_feature(c, kind, clip) for c in (port_cfg, jax_cfg))
            assert got.shape == ref.shape == _feature(
                jax_cfg, "duration", clip).shape
            np.testing.assert_allclose(got, ref, atol=FEATURE_ATOL, rtol=0)

    def read(cfg, name):
        with open(os.path.join(cfg["path"]["preprocessed_path"], name)) as f:
            return f.read()

    got, ref = (json.loads(read(c, "stats.json"))
                for c in (port_cfg, jax_cfg))
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], atol=STATS_ATOL,
                                   rtol=0)
    assert read(port_cfg, "speakers.json") == read(jax_cfg, "speakers.json")
    splits = {c: [set(read(cfg, f"{s}.txt").splitlines())
                  for s in ("train", "val")]
              for c, cfg in (("port", port_cfg), ("jax", jax_cfg))}
    assert set.union(*splits["port"]) == set.union(*splits["jax"])
    assert [len(s) for s in splits["port"]] == [2, 1]


def test_preprocessor_dsp_batch_is_per_utterance(preprocessed, tmp_path):
    """dsp_batch_size 1 (one utterance per DSP call) gives the batched
    run's durations exactly and its features within the bounds above (a
    batched FFT may sum in another order)."""
    _, port_cfg = preprocessed
    cfg = _layout(str(tmp_path / "one"))
    cfg["preprocessing"]["dsp_batch_size"] = 1
    Preprocessor(cfg, "cpu").build_from_path()
    for clip in CLIPS:
        np.testing.assert_array_equal(_feature(cfg, "duration", clip),
                                      _feature(port_cfg, "duration", clip))
        np.testing.assert_allclose(_feature(cfg, "mel", clip),
                                   _feature(port_cfg, "mel", clip),
                                   atol=1e-3, rtol=0)
        for kind in ("pitch", "energy"):
            np.testing.assert_allclose(_feature(cfg, kind, clip),
                                       _feature(port_cfg, kind, clip),
                                       atol=FEATURE_ATOL, rtol=0)


def test_preprocess_cli_reflect_pads_past_the_end(tmp_path):
    """A wav padded to its bucket is reflected past its true end, as the
    JAX package pads it (preprocessing/preprocessor.py:247-252)."""
    cfg = _layout(str(tmp_path), clips=CLIPS[:1])
    port, ref = Preprocessor(cfg, "cpu"), JaxPreprocessor(cfg)
    got = port._prepare_utterance("LJSpeech", CLIPS[0])
    want = ref._prepare_utterance("LJSpeech", CLIPS[0])
    assert len(got["wav_padded"]) == 131072
    for key in ("wav_padded", "wav", "durations"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["text"] == want["text"] and got["total"] == want["total"]


# ---- prepare_align and the MFA command line ----------------------------------

def _corpus_config(corpus, raw):
    return {"path": {"corpus_path": str(corpus), "raw_path": str(raw)},
            "preprocessing": {
                "audio": {"sampling_rate": 22050, "max_wav_value": 32768.0},
                "text": {"text_cleaners": ["english_cleaners"]}}}


def _tone(freq, sr=16000, seconds=0.3):
    t = np.arange(int(sr * seconds)) / sr
    return (0.25 * np.sin(2 * np.pi * freq * t) * 32767).astype(np.int16)


def _write_corpora(root):
    from scipy.io import wavfile

    lj = root / "LJSpeech"
    os.makedirs(lj / "wavs")
    for i, freq in enumerate((220.0, 330.0), 1):
        wavfile.write(str(lj / "wavs" / f"LJ001-000{i}.wav"), 16000,
                      _tone(freq))
    (lj / "metadata.csv").write_text(
        "LJ001-0001|raw|Printing, Mr. Smith bought 2 books.\n"
        "LJ001-0002|raw|The second sentence.\n"
        "LJ001-0003|raw|Missing wav is skipped.\n")
    ai = root / "AISHELL3"
    os.makedirs(ai / "train" / "wav" / "SSB0005")
    wavfile.write(str(ai / "train" / "wav" / "SSB0005" / "SSB00050001.wav"),
                  16000, _tone(200.0))
    (ai / "train" / "content.txt").write_text(
        "SSB00050001.wav\t你 ni3 好 hao3\n")
    lt = root / "LibriTTS" / "19" / "198"
    os.makedirs(lt)
    wavfile.write(str(lt / "19_198_000000_000000.wav"), 16000, _tone(250.0))
    (lt / "19_198_000000_000000.normalized.txt").write_text(
        "Dr. Jones paid $5.")
    return {"LJSpeech": lj, "AISHELL3": ai, "LibriTTS": root / "LibriTTS"}


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("dataset", sorted(JAX_PREPARE))
def test_prepare_align_matches_jax(tmp_path, dataset):
    """Each corpus adapter on a miniature corpus in its layout (resampled
    from 16 kHz): the same files, byte for byte."""
    corpus = _write_corpora(tmp_path)[dataset]
    assert sorted(PREPARE_ALIGN) == sorted(JAX_PREPARE)
    JAX_PREPARE[dataset](_corpus_config(corpus, tmp_path / "jax_raw"))
    cfg = dict(_corpus_config(corpus, tmp_path / "port_raw"),
               dataset=dataset)
    path = tmp_path / "pre.yaml"
    path.write_text(yaml.safe_dump(cfg))
    preprocess_cli.main(["prepare_align", str(path), "--device", "cpu"])
    got, ref = _tree(tmp_path / "port_raw"), _tree(tmp_path / "jax_raw")
    assert got == ref and ref


def test_mfa_command_line_matches_jax(tmp_path, monkeypatch):
    """The `mfa align` command line with MFA present (an injected runner:
    no aligner runs), and MFANotInstalled with the manual command when
    it is absent."""
    monkeypatch.setattr(mfa, "mfa_binary", lambda: None)
    monkeypatch.setattr(jax_mfa, "mfa_binary", lambda: None)
    cfg = {"path": {"raw_path": str(tmp_path / "raw"),
                    "preprocessed_path": str(tmp_path / "pre"),
                    "lexicon_path": str(tmp_path / "lex.txt")}}
    calls = {}
    for name, module in (("port", mfa), ("jax", jax_mfa)):
        seen = []
        out_dir, _ = module.run_mfa_align(
            cfg, binary="/fake/mfa", num_jobs=2,
            runner=lambda cmd, check: seen.append((cmd, check)))
        assert out_dir == str(tmp_path / "pre" / "TextGrid")
        assert os.path.isdir(out_dir)
        calls[name] = seen
    assert calls["port"] == calls["jax"]
    assert calls["port"][0][0][:2] == ["/fake/mfa", "align"]
    with pytest.raises(mfa.MFANotInstalled) as e:
        mfa.run_mfa_align(cfg)
    assert f"mfa align {cfg['path']['raw_path']}" in str(e.value)


def test_preparation_entry_points_need_cuda_unless_cpu(tmp_path):
    """No CUDA here: every preparation entry point raises unless --device
    cpu is given."""
    from fastspeech2_tpu_torch.cli import align_cli

    assert not torch.cuda.is_available()
    cfg = _layout(str(tmp_path), clips=CLIPS[:1])
    path = tmp_path / "pre.yaml"
    path.write_text(yaml.safe_dump(dict(cfg, dataset="LJSpeech")))
    for main, argv in ((preprocess_cli.main, [str(path)]),
                       (preprocess_cli.main, ["prepare_align", str(path)]),
                       (align_cli.main, [str(path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)


# ---- three training steps on each package's own features ---------------------

def _tiny_model_config():
    with open(os.path.join(CONFIG, "model.yaml")) as f:
        model_cfg = yaml.safe_load(f)
    model_cfg["transformer"].update(encoder_layer=1, decoder_layer=1,
                                    encoder_hidden=16, decoder_hidden=16,
                                    conv_filter_size=32)
    model_cfg["variance_predictor"]["filter_size"] = 16
    model_cfg["variance_embedding"]["n_bins"] = 16
    model_cfg["postnet"] = {"embedding_dim": 16, "kernel_size": 5,
                            "n_convolutions": 3}
    # the JAX package's attention and FFN resolve to their XLA formulations
    # on the CPU ("auto"), the port's to their plain versions
    return model_cfg


def test_training_on_port_features_matches_jax(preprocessed):
    """Three optimizer steps of a tiny model (float32, eval mode: no
    dropout) on the batch of the three clips: the port on its own
    features, the JAX package on its own, from the same initial weights."""
    from fastspeech2_tpu.configs.config import (
        FastSpeech2Config as JaxFastSpeech2Config,
    )
    from fastspeech2_tpu.configs.config import OptimConfig as JaxOptimConfig
    from fastspeech2_tpu.data import FeatureDataset as JaxFeatureDataset
    from fastspeech2_tpu.data.dataset import collate_batch as jax_collate
    from fastspeech2_tpu.models.fastspeech2 import (
        FastSpeech2 as JaxFastSpeech2,
    )
    from fastspeech2_tpu.training.optim import make_optimizer
    from fastspeech2_tpu.training.step import _apply_model
    from fastspeech2_tpu_torch.configs.config import (
        FastSpeech2Config,
        OptimConfig,
    )
    from fastspeech2_tpu_torch.data.dataset import (
        FeatureDataset,
        collate_batch,
    )
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.training.optim import NoamAdam
    from fastspeech2_tpu_torch.training.step import train_step
    from fastspeech2_tpu_torch.utils.params_io import from_jax_params
    from helpers import init_variables

    jax_pre, port_pre = preprocessed
    model_cfg = _tiny_model_config()
    optim = dict(batch_size=3, betas=(0.9, 0.98), eps=1e-9,
                 weight_decay=0.0, grad_clip_thresh=1.0, grad_acc_step=1,
                 warm_up_step=4, anneal_steps=(2,), anneal_rate=0.3,
                 mu_dtype="float32")

    def batch_of(dataset, collate):
        items = sorted((dataset[i] for i in range(len(dataset))),
                       key=lambda s: s["id"])
        return collate(items, max_mel_len=1000)

    jax_cfg = JaxFastSpeech2Config.build(jax_pre, model_cfg)
    jax_batch = {k: v for k, v in batch_of(
        _all_rows(JaxFeatureDataset, jax_pre), jax_collate).items()
        if k not in ("ids", "raw_texts", "valid_count")}
    port_batch = batch_of(_all_rows(FeatureDataset, port_pre), collate_batch)
    jax_model = JaxFastSpeech2(jax_cfg)
    variables = init_variables(jax_model, jax_batch)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])

    def loss(params, batch):
        losses, _, _ = _apply_model(jax_model, jax_cfg, params,
                                    variables["batch_stats"], batch, None,
                                    train=False)
        return losses.total, losses

    grad_fn = jax.jit(jax.grad(loss, has_aux=True))
    optimizer, _ = make_optimizer(JaxOptimConfig(**optim),
                                  jax_cfg.encoder_hidden)
    opt_state = optimizer.init(params)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    device_batch = {k: jnp.asarray(v) for k, v in jax_batch.items()}
    ref = []
    for _ in range(3):
        grads, losses = grad_fn(params, device_batch)
        params, opt_state = update(grads, opt_state, params)
        ref.append([float(v) for v in losses])

    cfg = FastSpeech2Config.build(port_pre, model_cfg)
    model = FastSpeech2(cfg)
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables), cfg))
    model.eval()
    opt = NoamAdam(model.parameters(), OptimConfig(**optim),
                   cfg.encoder_hidden)
    t = {k: torch.as_tensor(np.asarray(port_batch[k])) for k in port_batch
         if k not in ("ids", "raw_texts", "valid_count")}
    t = {k: v.long() if not v.is_floating_point() else v.float()
         for k, v in t.items()}
    got = [[float(v) for v in train_step(model, opt, t, i)]
           for i in range(3)]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0)
    assert got[2][0] < got[0][0]


class _all_rows:
    """Both splits of a preprocessed corpus as one dataset."""

    def __init__(self, dataset_cls, cfg):
        self.parts = [dataset_cls(f"{s}.txt", cfg) for s in ("train", "val")]

    def __len__(self):
        return sum(len(p) for p in self.parts)

    def __getitem__(self, i):
        for p in self.parts:
            if i < len(p):
                return p[i]
            i -= len(p)
        raise IndexError(i)
