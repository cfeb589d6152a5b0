"""PyTorch port, serving: the fused text->wav dispatch with warm-shape
snapping against the JAX package's, the snapping choices and warm sets,
the background-warmup race, the coalescer, every HTTP status and the
serve CLI, all on the CPU.

The model is the tiny acoustic model of ``test_torch_port._tiny_setup``
(JAX initialiser, npz snapshot) and the tiny HiFi-GAN of
``tests/test_serving.py`` (JAX's PRNGKey(0) init, its parameters loaded
into the port's generator), hop 16.  Sentences use lexicon words only, so
no neural G2P runs.  Tolerances: at float32 the mel to 1e-4 and the int16
wavs to 1e-3 of full scale, as test_torch_port.py holds the CLIs; at
bfloat16 the calibrated bound of tests/test_torch_bf16.py (the port no
further from JAX at bfloat16 than JAX at bfloat16 is from itself at
float32), with the JAX side compiled without excess precision.  On the CPU
there is no CUDA graph: a warm shape is one that has been dispatched.
Every test that starts a thread or a server stops it and joins it with a
timeout.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fastspeech2_tpu.cli.common import load_model_for_inference as jax_load
from fastspeech2_tpu.configs.config import load_yaml_configs
from fastspeech2_tpu.serving import BatchingSynthesizer as JaxBatching
from fastspeech2_tpu.synthesis import HiFiGANVocoder as JaxHiFiGAN
from fastspeech2_tpu.synthesis import Synthesizer as JaxSynthesizer
from fastspeech2_tpu_torch.cli import serve_cli
from fastspeech2_tpu_torch.cli.synthesize_cli import load_model_for_inference
from fastspeech2_tpu_torch.serving import (
    BatchingSynthesizer,
    ServerOverloaded,
    TTSServer,
)
from fastspeech2_tpu_torch.serving.server import wav_bytes
from fastspeech2_tpu_torch.synthesis.pipeline import Synthesizer
from fastspeech2_tpu_torch.synthesis.vocoder import (
    build_generator,
    generator_from_jax_params,
)
from test_torch_port import CONFIG, REPO, VOCODER, _tiny_setup

# tests/test_serving.py:33-36
TINY_HIFIGAN = {"upsample_rates": [4, 4], "upsample_kernel_sizes": [8, 8],
                "upsample_initial_channel": 32, "resblock_kernel_sizes": [3],
                "resblock_dilation_sizes": [[1, 3]], "num_mels": 80}
HOP = 16
FULL_SCALE = 32768
TEXTS = ["They bought their offices.", "The soviet authorities denied it.",
         "One."]
STRICT = {"xla_allow_excess_precision": False}
JOIN_S = 30


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Both packages' tiny models and vocoders on one preprocess config
    (absolute paths, hop 16)."""
    tmp = tmp_path_factory.mktemp("serving")
    model_path, train_path, npz = _tiny_setup(tmp)
    with open(f"{CONFIG}/preprocess.yaml") as f:
        pre = yaml.safe_load(f)
    for key in ("lexicon_path", "raw_path", "preprocessed_path"):
        pre["path"][key] = f"{REPO}/{pre['path'][key]}"
    pre["preprocessing"]["stft"]["hop_length"] = HOP
    pre_path = tmp / "preprocess.yaml"
    pre_path.write_text(yaml.safe_dump(pre))
    configs = load_yaml_configs(str(pre_path), model_path, train_path)
    jax_voc = JaxHiFiGAN(config=TINY_HIFIGAN)
    gen = build_generator(TINY_HIFIGAN)
    gen.load_state_dict(generator_from_jax_params(jax_voc.params,
                                                  TINY_HIFIGAN))
    models = {}
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        models[name] = load_model_for_inference(configs[0], configs[1], npz,
                                                "cpu", dtype=dt)
    return dict(configs=configs, paths=(str(pre_path), model_path,
                                        train_path, npz),
                jax_voc=jax_voc, gen=gen.eval(), models=models)


def _port(setup, dtype="float32", **kwargs):
    model, cfg = setup["models"][dtype]
    return Synthesizer(model, cfg, setup["configs"][0], "cpu",
                       vocoder=setup["gen"], **kwargs)


def _jax(setup, dtype=jnp.float32, model_config=None, **kwargs):
    configs = setup["configs"]
    if model_config is not None:
        configs = (configs[0], model_config, configs[2])
    model, variables, cfg = jax_load(configs, dtype=dtype,
                                     weights_npz=setup["paths"][3])
    return JaxSynthesizer(model, variables, cfg, configs[0],
                          vocoder=setup["jax_voc"], **kwargs)


def _np(t):
    return np.asarray(t.float() if torch.is_tensor(t) else t, np.float64)


@pytest.fixture(scope="module")
def f32_pair(setup):
    """The fused dispatch of TEXTS snapped to the warm (4, 32) shape in
    both packages at float32 -> ((port wavs, out), (JAX wavs, out))."""
    port, ref = _port(setup, snap_to_warm=True), _jax(setup,
                                                      snap_to_warm=True)
    for syn in (port, ref):
        syn.warm_shape(4, 32)
    return port.synthesize(TEXTS), ref.synthesize(TEXTS)


def _assert_same_dispatch(got, ref):
    (g_wavs, g_out), (r_wavs, r_out) = got, ref
    assert g_out.postnet_mel.shape[0] == 4
    assert g_out.src_pad_mask.shape == r_out.src_pad_mask.shape == (4, 32)
    np.testing.assert_array_equal(g_out.duration_rounded.numpy(),
                                  np.asarray(r_out.duration_rounded))
    np.testing.assert_array_equal(g_out.mel_len.numpy(),
                                  np.asarray(r_out.mel_len))
    for i, (g, r) in enumerate(zip(g_wavs, r_wavs)):
        assert g.dtype == r.dtype == np.int16
        assert g.shape == r.shape == (int(g_out.mel_len[i]) * HOP,)


def test_fused_synthesize_matches_jax_float32(setup, f32_pair):
    port = _port(setup)
    ref = _jax(setup)
    for text in TEXTS:
        np.testing.assert_array_equal(port.text_to_ids(text)[0],
                                      ref.text_to_ids(text)[0])
    assert port.fused and port.graphs is None   # no graph on the CPU
    _assert_same_dispatch(*f32_pair)
    (g_wavs, g_out), (r_wavs, r_out) = f32_pair
    assert np.abs(_np(g_out.postnet_mel)
                  - _np(r_out.postnet_mel)).max() <= 1e-4
    assert max(np.abs(w).max() for w in r_wavs) > 0
    for g, r in zip(g_wavs, r_wavs):
        np.testing.assert_allclose(g.astype(np.float64), r.astype(np.float64),
                                   atol=1e-3 * FULL_SCALE, rtol=0)


def test_fused_synthesize_matches_jax_bfloat16(setup, f32_pair):
    """JAX's fused dispatch compiled without excess precision, its
    attention and FFN in Pallas interpret mode, as the bfloat16 tests run
    them; the controls promote the predictions to float32 on both sides."""
    model_config = dict(setup["configs"][1],
                        attention_backend="pallas_interpret",
                        ffn_backend="pallas_interpret")
    ref = _jax(setup, jnp.bfloat16, model_config, snap_to_warm=True)
    model, inner = ref.model, setup["jax_voc"].raw_apply

    def fused(variables, voc_params, speakers, texts, src_lens, p, e, d,
              p_off, e_off):
        out = model.apply(variables, speakers, texts, src_lens,
                          max_mel_len=ref.max_mel_len, p_control=p,
                          e_control=e, d_control=d, p_offset=p_off,
                          e_offset=e_off, train=False)
        return inner(voc_params, out.postnet_mel), out

    compiled = {}

    def strict(*args, max_mel_len, truncate_decoder=True):
        assert max_mel_len == ref.max_mel_len and truncate_decoder
        key = args[3].shape
        if key not in compiled:
            compiled[key] = jax.jit(fused).lower(*args).compile(STRICT)
        return compiled[key](*args)

    ref._fused = strict
    ref.warm_shape(4, 32)
    port = _port(setup, "bfloat16", snap_to_warm=True)
    port.warm_shape(4, 32)
    got, want = port.synthesize(TEXTS), ref.synthesize(TEXTS)
    _assert_same_dispatch(got, want)
    (g_wavs, g_out), (r_wavs, r_out) = got, want
    (_, f32_out), (r32_wavs, r32_out) = f32_pair
    assert g_out.postnet_mel.dtype == torch.bfloat16
    assert g_out.pitch_prediction.dtype == torch.float32
    for name in ("mel", "postnet_mel", "pitch_prediction",
                 "energy_prediction"):
        g, r = _np(getattr(g_out, name)), _np(getattr(r_out, name))
        err = np.abs(g - r).max()
        assert err <= np.abs(r - _np(getattr(r32_out, name))).max(), name
        assert np.abs(g - _np(getattr(f32_out, name))).max() > 0, name
    for g, r, r32 in zip(g_wavs, r_wavs, r32_wavs):
        g, r, r32 = (w.astype(np.float64) for w in (g, r, r32))
        assert np.abs(g - r).max() <= 0.01 * FULL_SCALE
        assert np.abs(g - r).max() <= max(np.abs(r - r32).max(), 1.0)


WARM_SETS = [set(), {(4, 32)}, {(4, 32), (1, 16)},
             {(16, 128), (4, 64), (8, 32), (2, 16)},
             {(2, 64), (4, 32), (8, 16), (16, 128)}]
REQUESTS = [(b, p) for b in (1, 2, 4, 8, 16) for p in (16, 32, 48, 64, 128)]


def test_snap_choices_match_jax(setup):
    port, ref = _port(setup), _jax(setup)
    for warm in WARM_SETS:
        port._warm, ref._warm = set(warm), set(warm)
        for req in REQUESTS:
            assert port._snap(*req) == ref._snap(*req), (warm, req)


def _fake_jax_fused(*args, **kwargs):
    """Stands in for JAX's compiled fused dispatch where only the shapes it
    is asked for matter."""
    return jnp.zeros(1), None


@pytest.mark.parametrize("grid", ["top", "full"])
def test_warmup_warm_sets_match_jax(setup, grid):
    """The warm set after warmup (max batch 8, text envelope 48 -> buckets
    16, 32, 64) in both packages."""
    port, ref = _port(setup, snap_to_warm=True), _jax(setup,
                                                      snap_to_warm=True)
    ref._fused = _fake_jax_fused
    logs = {}
    for name, syn, cls in (("port", port, BatchingSynthesizer),
                           ("jax", ref, JaxBatching)):
        batcher = cls(syn, max_batch_size=8)
        try:
            logs[name] = []
            batcher.warmup(log=logs[name].append, max_phones=48, grid=grid)
        finally:
            batcher.stop()
    assert port._warm == ref._warm
    if grid == "top":
        assert port._warm == {(8, 64)}
        assert "skipped (requests snap" in logs["port"][0]
    else:
        assert port._warm == {(b, p) for b in (1, 2, 4, 8)
                              for p in (16, 32, 64)}
        assert any("grid complete: 12 warm shapes" in m for m in logs["port"])
    assert "top (batch 8 x text 64)" in logs["port"][0]


def test_background_warmup_never_unsnaps_a_request(setup, monkeypatch):
    """A warm_shape blocked mid-dispatch in a background thread while a
    request is dispatched: JAX's warm_shape has switched the shared
    snap_to_warm flag off (pipeline.py:219), so its request goes out at
    its exact shape; the port's request still snaps to the warm (4, 32)."""
    entered, release = threading.Event(), threading.Event()
    shapes = {}

    def blocking(real, name):
        def fused(*args, **kwargs):
            texts = args[3] if name == "jax" else args[1]
            if threading.current_thread().name == "warm":
                entered.set()
                release.wait(JOIN_S)
                return _fake_jax_fused() if name == "jax" else real(
                    *args, **kwargs)
            shapes[name] = tuple(texts.shape)
            if name == "jax":
                raise _Dispatched
            return real(*args, **kwargs)
        return fused

    port, ref = _port(setup, snap_to_warm=True), _jax(setup,
                                                      snap_to_warm=True)
    ref._fused = blocking(ref._fused, "jax")
    monkeypatch.setattr(port, "fused_forward",
                        blocking(port.fused_forward, "port"))
    for name, syn in (("jax", ref), ("port", port)):
        syn._warm = {(4, 32)}
        entered.clear()
        release.clear()
        warm = threading.Thread(target=syn.warm_shape, args=(1, 16),
                                name="warm")
        warm.start()
        try:
            assert entered.wait(JOIN_S)
            try:
                syn.synthesize([TEXTS[2]])
            except _Dispatched:
                pass
        finally:
            release.set()
            warm.join(JOIN_S)
        assert not warm.is_alive()
        assert syn.snap_to_warm
    assert shapes == {"jax": (1, 16), "port": (4, 32)}


class _Dispatched(Exception):
    pass


# -- the coalescer and the HTTP front end, mirroring tests/test_serving.py

@pytest.fixture
def synth(setup):
    return _port(setup)


def test_wav_bytes_riff():
    wav = (np.sin(np.linspace(0, 20, 1000)) * 10000).astype(np.int16)
    b = wav_bytes(wav, 22050)
    assert b[:4] == b"RIFF" and b[8:12] == b"WAVE"
    assert len(b) == 44 + 2000


def _threads(target, args_list):
    threads = [threading.Thread(target=target, args=a) for a in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)


def test_batching_coalesces_and_matches_solo(synth):
    """Six co-arriving requests share dispatches; each wav equals the same
    text's solo dispatch at the shape its batch snapped to outside the
    tail the PostNet's frame mask and the vocoder's receptive field give
    batch-mates (here the whole of a short wav can be tail, so the check
    is the length and a bitwise head)."""
    synth.snap_to_warm = True
    synth.warm_shape(8, 32)
    batcher = BatchingSynthesizer(synth, max_batch_size=8, max_wait_ms=200.0)
    try:
        results = {}
        _threads(lambda i: results.__setitem__(
            i, batcher.synthesize(TEXTS[i % 3])), [(i,) for i in range(6)])
        stats = batcher.stats()
    finally:
        batcher.stop()
    assert len(results) == 6 and stats["requests"] == 6
    assert stats["batches"] < 6, stats
    for i, wav in results.items():
        solo, out = synth.synthesize([TEXTS[i % 3]])
        assert wav.dtype == np.int16 and wav.shape == solo[0].shape
        assert out.src_pad_mask.shape == (8, 32)
        head = max(0, len(wav) - 40 * HOP)
        np.testing.assert_array_equal(wav[:head], solo[0][:head])


def test_batching_groups_by_controls(synth):
    batcher = BatchingSynthesizer(synth, max_batch_size=8, max_wait_ms=200.0)
    seen = []
    inner = synth.synthesize

    def spy(texts, speakers=None, p_control=1.0, e_control=1.0,
            d_control=1.0):
        seen.append((len(texts), d_control))
        return inner(texts, speakers, p_control, e_control, d_control)

    synth.synthesize = spy
    try:
        results = {}
        _threads(lambda i, d: results.__setitem__(
            i, batcher.synthesize("They bought", d_control=d)),
            [(i, 1.0 + 0.2 * (i % 2)) for i in range(4)])
        stats = batcher.stats()
    finally:
        batcher.stop()
    assert len(results) == 4 and stats["requests"] == 4
    assert stats["batches"] >= 2
    # no dispatch mixes two control tuples
    assert sum(n for n, _ in seen) == 4
    assert {d for _, d in seen} == {1.0, 1.2}


@pytest.fixture(scope="module")
def server(setup):
    batcher = BatchingSynthesizer(_port(setup), max_batch_size=8,
                                  max_wait_ms=20.0)
    srv = TTSServer(batcher, 22050, port=0).start()
    yield srv
    srv.stop()


def _url(server, path):
    return f"http://127.0.0.1:{server.port}{path}"


def _post(server, payload, token=None, path="/synthesize", raw=None):
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        _url(server, path), headers=headers,
        data=raw if raw is not None else json.dumps(payload).encode())
    return urllib.request.urlopen(req, timeout=JOIN_S)


def _status(fn):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn()
    return e.value


def test_http_healthz_stats_and_404(server):
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok"}
    with urllib.request.urlopen(_url(server, "/stats"), timeout=30) as r:
        assert set(json.loads(r.read())) == {"requests", "batches",
                                             "mean_batch", "pending", "shed"}
    assert _status(lambda: urllib.request.urlopen(
        _url(server, "/nope"), timeout=30)).code == 404
    assert _status(lambda: _post(server, {"text": "x"},
                                 path="/nope")).code == 404


def test_http_synthesize_returns_the_dispatch_wav(server):
    with _post(server, {"text": TEXTS[0]}) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        body = r.read()
    assert body[:4] == b"RIFF"
    wavs, _ = server.batcher.synthesizer.synthesize([TEXTS[0]])
    np.testing.assert_array_equal(np.frombuffer(body[44:], np.int16),
                                  wavs[0])


def test_http_bad_requests(server):
    for raw in (b"{}", b"{not json", json.dumps({"text": "   "}).encode(),
                json.dumps({"text": 5}).encode()):
        assert _status(lambda: _post(server, None, raw=raw)).code == 400


def test_http_long_text(server):
    """Texts over 100 chars auto-route through sentence-splitting long-form
    synthesis: the wav is the sentences' joined with 120 ms pauses."""
    text = ("They bought their offices. " * 3
            + "And the soviet authorities denied it to one another.")
    assert len(text) > 100
    with _post(server, {"text": text}) as r:
        body = r.read()
    assert body[:4] == b"RIFF"
    wav, chunks = server.batcher.synthesizer.synthesize_long(text)
    assert len(chunks) == 4
    np.testing.assert_array_equal(np.frombuffer(body[44:], np.int16), wav)


def test_http_synthesize_stream_chunks(server):
    body = json.dumps({"text": "They bought. One another?"}).encode()
    req = urllib.request.Request(
        _url(server, "/synthesize_stream"), data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=JOIN_S) as r:
        assert r.headers["Content-Type"] == "audio/L16;rate=22050;channels=1"
        data = r.read()
    pcm = np.frombuffer(data, np.int16)
    syn = server.batcher.synthesizer
    first, second = (syn.synthesize([t])[0][0]
                     for t in ("They bought.", "One another?"))
    pause = np.zeros(int(22050 * 0.12), np.int16)
    np.testing.assert_array_equal(pcm, np.concatenate([first, pause,
                                                       second]))


def test_synthesize_stream_generator(synth):
    b = BatchingSynthesizer(synth, max_batch_size=4, max_wait_ms=5.0)
    try:
        chunks = list(b.synthesize_stream("They. Bought. One."))
    finally:
        b.stop()
    assert len(chunks) == 5
    assert all(c.dtype == np.int16 for c in chunks)
    assert np.all(chunks[1] == 0) and np.all(chunks[3] == 0)


def test_steady_path_makes_no_new_warm_shape(synth):
    """After the top shape only, requests of any size inside the envelope
    snap to it: the warm set (on the card, the graphs) does not grow."""
    batcher = BatchingSynthesizer(synth, max_batch_size=4, max_wait_ms=5.0)
    try:
        batcher.warmup(max_phones=32)
        assert synth._warm == {(4, 32)}
        assert batcher.synthesize("One").dtype == np.int16
        wavs, out = synth.synthesize(TEXTS[:2])
        assert len(wavs) == 2 and out.src_pad_mask.shape == (4, 32)
        wavs, _ = synth.synthesize([TEXTS[1]] * 3)
        assert len(wavs) == 3
    finally:
        batcher.stop()
    assert synth._warm == {(4, 32)}


class _BlockingSynthesizer:
    """Fake synthesizer whose dispatches block on an event."""

    def __init__(self):
        self.release = threading.Event()
        self.preprocess_config = {
            "preprocessing": {"audio": {"sampling_rate": 22050}}}

    def synthesize(self, texts, speakers=None, p_control=1.0,
                   e_control=1.0, d_control=1.0):
        self.release.wait(JOIN_S)
        return [np.ones(100, np.int16) for _ in texts], None

    def synthesize_long(self, text, **kw):
        self.release.wait(JOIN_S)
        return np.ones(100, np.int16), None


def _wait_pending(batcher, n):
    for _ in range(100):
        if batcher.stats()["pending"] >= n:
            return
        time.sleep(0.05)
    raise AssertionError(f"never {n} pending")


def test_overload_shedding_batcher():
    fake = _BlockingSynthesizer()
    batcher = BatchingSynthesizer(fake, max_batch_size=2, max_wait_ms=1.0,
                                  max_pending=2)
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(batcher.synthesize("x")))
        for _ in range(2)]
    try:
        for t in threads:
            t.start()
        _wait_pending(batcher, 2)
        with pytest.raises(ServerOverloaded):
            batcher.synthesize("y")
        assert batcher.stats()["shed"] == 1
        fake.release.set()
        for t in threads:
            t.join(JOIN_S)
        assert len(results) == 2
        assert batcher.stats()["pending"] == 0
    finally:
        fake.release.set()
        for t in threads:
            t.join(JOIN_S)
        batcher.stop()


class _InstantSynthesizer:
    """Fake synthesizer that answers at once: the coalescer's own
    bookkeeping under load."""

    preprocess_config = {"preprocessing": {"audio": {"sampling_rate": 22050}}}

    def synthesize(self, texts, speakers=None, p_control=1.0,
                   e_control=1.0, d_control=1.0):
        return [np.full(4, len(t), np.int16) for t in texts], None


def test_batcher_counts_hold_under_thread_stress():
    """96 callers at once with a shortened switch interval: every request
    gets its own text's wav and the counters lose no update."""
    import sys

    batcher = BatchingSynthesizer(_InstantSynthesizer(), max_batch_size=8,
                                  max_wait_ms=1.0, max_pending=1000)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    results = {}
    try:
        _threads(lambda i: results.__setitem__(
            i, batcher.synthesize("x" * (1 + i % 7))),
            [(i,) for i in range(96)])
        stats = batcher.stats()
    finally:
        sys.setswitchinterval(interval)
        batcher.stop()
    assert len(results) == 96
    assert all(int(w[0]) == 1 + i % 7 for i, w in results.items())
    assert stats["requests"] == 96 and stats["pending"] == 0
    assert stats["batches"] * 8 >= 96


@pytest.fixture
def hardened_server(setup):
    batcher = BatchingSynthesizer(_port(setup), max_batch_size=8,
                                  max_wait_ms=10.0)
    srv = TTSServer(batcher, 22050, port=0, auth_token="sekrit",
                    max_body_bytes=512, max_text_len=40).start()
    yield srv
    srv.stop()


def test_http_auth_and_limits(hardened_server):
    srv = hardened_server
    assert _status(lambda: _post(srv, {"text": "One"})).code == 401
    assert _status(lambda: _post(srv, {"text": "One"},
                                 token="wrong")).code == 401
    with _post(srv, {"text": "One"}, token="sekrit") as r:
        assert r.read()[:4] == b"RIFF"
    with urllib.request.urlopen(_url(srv, "/healthz"), timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok"}
    assert _status(lambda: _post(srv, {"text": "x" * 600},
                                 token="sekrit")).code == 413
    assert _status(lambda: _post(srv, {"text": "y" * 60},
                                 token="sekrit")).code == 400


def test_http_overload_returns_429():
    fake = _BlockingSynthesizer()
    batcher = BatchingSynthesizer(fake, max_batch_size=2, max_wait_ms=1.0,
                                  max_pending=1)
    srv = TTSServer(batcher, 22050, port=0).start()
    held = threading.Thread(target=lambda: batcher.synthesize("x"))
    try:
        held.start()
        _wait_pending(batcher, 1)
        err = _status(lambda: _post(srv, {"text": "hello"}))
        assert err.code == 429 and err.headers["Retry-After"] == "1"
        err = _status(lambda: _post(srv, {"text": "hello."},
                                    path="/synthesize_stream"))
        assert err.code == 429
    finally:
        fake.release.set()
        held.join(JOIN_S)
        srv.stop()


def test_stop_before_start_returns():
    """A server stopped before it was started (a caller whose set-up
    raised, in a ``finally``) closes its socket and its batcher and
    returns: socketserver's shutdown() alone would wait forever for a
    serve loop that never ran."""
    batcher = BatchingSynthesizer(_BlockingSynthesizer(), max_batch_size=2,
                                  max_wait_ms=1.0)
    srv = TTSServer(batcher, 22050, port=0)
    done = threading.Event()
    stopper = threading.Thread(target=lambda: (srv.stop(), done.set()),
                               daemon=True)
    stopper.start()
    stopper.join(JOIN_S)
    assert done.is_set()
    assert srv.httpd.socket.fileno() == -1


def test_http_concurrency_32(server):
    """32 simultaneous clients each get valid audio or a clean 429."""
    results, shed, errors = {}, [], []

    def call(i):
        try:
            with _post(server, {"text": f"{TEXTS[i % 3]}"}) as r:
                results[i] = r.read()
        except urllib.error.HTTPError as exc:
            (shed if exc.code == 429 else errors).append((i, exc))
        except Exception as exc:
            errors.append((i, exc))

    _threads(call, [(i,) for i in range(32)])
    assert not errors
    assert len(results) >= 24 and len(results) + len(shed) == 32
    assert all(b[:4] == b"RIFF" and len(b) > 44 for b in results.values())


def test_serve_cli_build_server(setup, monkeypatch):
    """build_server from argv on the CPU: the model.yaml's vocoder
    (HiFi-GAN-iSTFT, tracked snapshot), a snapping synthesizer, the token
    from $TTS_AUTH_TOKEN; --data_parallel 2 raises where two cards are
    not visible (here: the CPU)."""
    pre, model_path, train_path, npz = setup["paths"]
    with open(pre) as f:
        pre_cfg = yaml.safe_load(f)
    pre_cfg["preprocessing"]["stft"]["hop_length"] = 256
    pre256 = pre.replace("preprocess.yaml", "preprocess256.yaml")
    with open(pre256, "w") as f:
        yaml.safe_dump(pre_cfg, f)
    argv = ["-p", pre256, "-m", model_path, "-t", train_path,
            "--weights_npz", npz, "--vocoder_ckpt", VOCODER, "--device",
            "cpu", "--port", "0", "--max_batch_size", "2"]
    args = serve_cli.build_parser().parse_args(argv)
    assert (args.max_wait_ms, args.max_pending, args.max_body_bytes,
            args.max_text_len, args.warmup_grid, args.dtype) == (
        20.0, 256, 65536, 4096, "top", "float32")
    monkeypatch.setenv("TTS_AUTH_TOKEN", "env-token")
    srv = serve_cli.build_server(args).start()
    try:
        syn = srv.batcher.synthesizer
        assert syn.snap_to_warm and syn.fused and syn.graphs is None
        assert srv.auth_token == "env-token"
        srv.batcher.warmup(max_phones=16)
        assert syn._warm == {(2, 16)}
        with _post(srv, {"text": "One"}, token="env-token") as r:
            body = r.read()
        wavs, out = syn.synthesize(["One"])
        assert out.src_pad_mask.shape == (2, 16)
        np.testing.assert_array_equal(np.frombuffer(body[44:], np.int16),
                                      wavs[0])
        assert len(wavs[0]) == int(out.mel_len[0]) * 256
    finally:
        srv.stop()
    args = serve_cli.build_parser().parse_args(argv + ["--data_parallel",
                                                       "2"])
    with pytest.raises(ValueError, match="needs 2 cards, 0 visible"):
        serve_cli.build_server(args)


def test_serve_cli_needs_a_card_unless_cpu(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pre, model_path, train_path, npz = setup["paths"]
    args = serve_cli.build_parser().parse_args(
        ["-p", pre, "-m", model_path, "-t", train_path, "--weights_npz",
         npz])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.build_server(args)


def test_fused_dispatch_redispatches_beyond_max_mel_len(setup):
    """A predicted length beyond max_mel_len is dispatched again at
    round_up(need, 512) frames, untruncated, as JAX does."""
    port = _port(setup, max_mel_len=8)
    ref = _jax(setup, max_mel_len=8)
    (g_wavs, g_out), (r_wavs, r_out) = (s.synthesize([TEXTS[1]])
                                        for s in (port, ref))
    need = int(g_out.duration_rounded.sum())
    assert need > 8 and g_out.postnet_mel.shape[1] == 512
    assert np.asarray(r_out.postnet_mel).shape[1] == 512
    assert int(g_out.mel_len[0]) == int(r_out.mel_len[0]) == need
    np.testing.assert_allclose(g_wavs[0].astype(np.float64),
                               r_wavs[0].astype(np.float64),
                               atol=1e-3 * FULL_SCALE, rtol=0)


def test_fused_controls_match_jax(setup):
    """Non-default controls in the absolute mode through the fused
    dispatch: one set of control tensors serves every value."""
    port = _port(setup, control_mode="absolute")
    ref = _jax(setup, control_mode="absolute")
    kw = dict(p_control=1.2, e_control=0.8, d_control=1.1)
    (g_wavs, g_out), (r_wavs, r_out) = (s.synthesize([TEXTS[0]], **kw)
                                        for s in (port, ref))
    np.testing.assert_array_equal(g_out.duration_rounded.numpy(),
                                  np.asarray(r_out.duration_rounded))
    np.testing.assert_allclose(_np(g_out.pitch_prediction),
                               _np(r_out.pitch_prediction), atol=1e-4)
    np.testing.assert_allclose(g_wavs[0].astype(np.float64),
                               r_wavs[0].astype(np.float64),
                               atol=1e-3 * FULL_SCALE, rtol=0)



def test_cached_constants_are_kept_inside_keep_read():
    """What a graph reads stays alive when its cache lets go: inside
    keep_read, every cached constant handed out is collected (outside, none
    is); a cleared cache then makes a new tensor of the same values."""
    from fastspeech2_tpu_torch.models import hifigan_istft
    from fastspeech2_tpu_torch.ops import positional
    from fastspeech2_tpu_torch.ops.device_cache import keep_read

    cpu = torch.device("cpu")
    with keep_read() as kept:
        table = positional._device_table(37, 8, torch.float32, cpu)
        wss = hifigan_istft._window_sum_square(16, 4, 9, cpu)
    positional._device_table(38, 8, torch.float32, cpu)
    assert len(kept) == 2 and kept[0] is table and kept[1] is wss
    positional._device_table.cache_clear()
    hifigan_istft._window_sum_square.cache_clear()
    again = positional._device_table(37, 8, torch.float32, cpu)
    assert again is not table and torch.equal(again, table)
    assert torch.equal(hifigan_istft._window_sum_square(16, 4, 9, cpu), wss)


class _EagerGraph:
    """Stands in for a CUDA graph on the CPU: a replay runs the forward on
    the static inputs into the static outputs."""

    def __init__(self, forward, inputs):
        self.forward, self.inputs = forward, inputs
        with torch.inference_mode():
            self.outputs = forward(*inputs)

    def replay(self):
        wav, out = self.forward(*self.inputs)
        self.outputs[0].copy_(wav)
        for static, value in zip(self.outputs[1], out):
            static.copy_(value)


def test_cold_shapes_run_eagerly_beside_the_graphs(setup, monkeypatch):
    """Where a Synthesizer has graphs, warm_shape captures one and a
    dispatch at its shape replays it; a dispatch at a shape without one
    runs eagerly and leaves the warm set and the graphs as they were.  The
    wavs are the eager Synthesizer's at the same snapped shapes."""
    from fastspeech2_tpu_torch.synthesis.graphs import (
        KERNELS,
        GraphCache,
        _Graph,
    )

    syn = _port(setup, snap_to_warm=True)
    cache = GraphCache(syn._forward_to_wav, "cpu")

    def capture(speakers, texts, src_lens):
        inputs = [t.clone() for t in (speakers, texts, src_lens)]
        inputs += [torch.tensor(v) for v in (1.0, 1.0, 1.0, 0.0, 0.0)]
        g = _EagerGraph(syn._forward_to_wav, inputs)
        return _Graph(g, inputs, g.outputs, [], dict.fromkeys(KERNELS, 1))

    monkeypatch.setattr(cache, "_capture", capture)
    syn.graphs = cache
    ids = np.tile(syn.text_to_ids(TEXTS[1])[0], 8)
    syn.warm_shape(1, 32)
    ref = _port(setup, snap_to_warm=True)
    ref._warm = {(1, 32)}
    replays = []
    for n in (20, 40, 12, 40):
        wavs, out = syn.synthesize_ids([ids[:n]], d_control=1.1)
        replays.append(cache.replays())
        assert sorted(cache.graphs) == sorted(syn._warm) == [(1, 32)]
        wavs_e, out_e = ref.synthesize_ids([ids[:n]], d_control=1.1)
        ref._warm = {(1, 32)}
        assert out.src_pad_mask.shape == out_e.src_pad_mask.shape
        np.testing.assert_array_equal(wavs[0], wavs_e[0])
    # 20 and 12 phones snap to the graph, 40 phones (text 48) run eagerly
    assert replays == [1, 1, 2, 2]
    assert cache.launches() == dict.fromkeys(KERNELS, 2)
