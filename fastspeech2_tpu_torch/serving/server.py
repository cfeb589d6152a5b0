"""Batched TTS serving daemon (port of ``fastspeech2_tpu/serving/server.py``).

The synthesis pipeline runs text->wav as one fused dispatch per batch
(``synthesis/pipeline.py``; on the card a CUDA graph replay); serving
throughput then hinges on filling batches.  `BatchingSynthesizer`
coalesces concurrent requests: callers enqueue (text, speaker, controls)
and block on a future; a single dispatcher thread drains the queue, groups
requests by control ratios (the controls are inputs of the graph, so
different ratios share one graph; they cannot share one batch because
they are per-batch scalars), pads each group to the text bucket, and runs
one fused dispatch per group.

`TTSServer` wraps that in a stdlib ThreadingHTTPServer:

  POST /synthesize   {"text": "...", "speaker": 0, "pitch_control": 1.0,
                      "energy_control": 1.0, "duration_control": 1.0,
                      "long": bool (default: auto for texts > 100 chars —
                      sentence-split long-form synthesis)}
                     -> audio/wav bytes (RIFF, int16, corpus sample rate)
  POST /synthesize_stream  same payload -> chunked raw PCM16
                     (audio/L16;rate=<sr>;channels=1): each sentence's
                     audio is flushed as soon as it is synthesized, so
                     playback can start before long texts finish.
                     Sentences from concurrent streams coalesce into the
                     same fused dispatches as /synthesize requests.
  GET  /healthz      -> {"status": "ok"}
  GET  /stats        -> {"requests": N, "batches": M, "mean_batch": ...,
                         "pending": in-flight, "shed": rejected-429s}

Hardening: optional bearer-token auth (401), request-body and text-length
limits (413/400), and overload shedding — admissions beyond
`max_pending` in-flight utterances are rejected with 429 + Retry-After
instead of growing the queue without bound.

No external dependencies; everything is stdlib + the pipeline.
"""

import json
import queue
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class ServerOverloaded(RuntimeError):
    """Raised when the pending-request cap is hit (shed with HTTP 429)."""


class PayloadTooLarge(ValueError):
    """Raised when a request body exceeds max_body_bytes (HTTP 413)."""


def wav_bytes(wav_int16, sampling_rate):
    """int16 numpy array -> RIFF/WAVE file bytes (mono, PCM16)."""
    data = wav_int16.tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sampling_rate,
                                 sampling_rate * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(data))
    return hdr + data


class _Request:
    __slots__ = ("text", "speaker", "controls", "event", "result", "error")

    def __init__(self, text, speaker, controls):
        self.text = text
        self.speaker = speaker
        self.controls = controls
        self.event = threading.Event()
        self.result = None
        self.error = None


class BatchingSynthesizer:
    """Thread-safe request coalescing around a Synthesizer.

    max_batch_size bounds the padded batch; max_wait_ms is how long the
    dispatcher lingers after the first request of a batch to let
    co-arriving requests join it.
    """

    def __init__(self, synthesizer, max_batch_size=16, max_wait_ms=20.0,
                 max_pending=256):
        self.synthesizer = synthesizer
        self.max_batch_size = max_batch_size
        self.max_wait_ms = max_wait_ms
        # overload shedding: admissions beyond this many in-flight
        # utterances raise ServerOverloaded instead of growing the queue
        # (and its tail latency) without bound
        self.max_pending = max_pending
        self._pending = 0
        self._queue = queue.Queue()
        self._stats_lock = threading.Lock()
        self.n_requests = 0
        self.n_batches = 0
        self.n_shed = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def warmup(self, sample_texts=None, log=print, max_phones=128,
               grid="top"):
        """Make serving shapes warm with no cold-capture hole.

        Phase 1 (always, blocking): make the TOP (max batch bucket × max
        text bucket) shape warm — on the card, capture its CUDA graph —
        and switch the synthesizer to snap_to_warm.  Every request within
        that envelope then pads up to a warm shape: the steady path never
        waits for a capture.

        grid — what happens to the REST of the (batch bucket × text
        bucket) grid:
        - "top" (default): nothing.  All requests snap to the top shape;
          the padding waste is bounded (one dispatch shape).
        - "background": fill largest-first in a daemon thread; each
          shape joins the warm set as it lands.  A capture holds the
          graphs' lock, so dispatches wait for it.
        - "full": fill blocking, before taking traffic — the zero-
          padding-waste option, at startup-time cost.

        max_phones bounds the warmed text envelope (128 phones covers
        the reference's 100-char single-mode input and the sentence
        chunks of the long-form path).  sample_texts, if given, extends
        the envelope to cover each text's exact phone count.
        """
        syn = self.synthesizer
        if hasattr(syn, "snap_to_warm"):
            syn.snap_to_warm = True
        tb = getattr(syn, "text_bucket", 16)
        if sample_texts:
            for text in sample_texts:
                ids, _ = syn.text_to_ids(text)
                max_phones = max(max_phones, len(ids))
        # text buckets: tb doublings up to the first covering max_phones;
        # batch buckets: every power of two up to AND INCLUDING the
        # bucket max_batch_size itself rounds to — a non-power-of-two
        # max (e.g. 12) coalesces batches that _pack_batch pads to the
        # NEXT bucket (16)
        pbuckets = [tb]
        while pbuckets[-1] < max_phones:
            pbuckets.append(pbuckets[-1] * 2)
        sizes = [1]
        top = 1 << (self.max_batch_size - 1).bit_length()
        while sizes[-1] < top:
            sizes.append(sizes[-1] * 2)
        t0 = time.monotonic()
        syn.warm_shape(sizes[-1], pbuckets[-1])
        combos = [(s, p) for p in reversed(pbuckets)
                  for s in reversed(sizes)
                  if (s, p) != (sizes[-1], pbuckets[-1])]
        what = {"top": "skipped (requests snap to the top combo)",
                "background": "warming in background",
                "full": "next"}[grid]
        log(f"Warmup made the top (batch {sizes[-1]} x text "
            f"{pbuckets[-1]}) shape warm in {time.monotonic() - t0:.1f}s; "
            f"{len(combos)} smaller (text-bucket x batch-bucket) combos "
            f"{what}")
        if grid == "top":
            return

        def fill():
            for s, p in combos:
                if self._stop.is_set():
                    return
                try:
                    syn.warm_shape(s, p)
                except Exception as exc:   # warmup must never kill serving
                    log(f"background warmup stopped at (batch {s} x "
                        f"text {p}): {exc}")
                    return
            log(f"Warmup grid complete: {len(combos) + 1} warm shapes in "
                f"{time.monotonic() - t0:.1f}s")

        if grid == "background":
            threading.Thread(target=fill, daemon=True).start()
        else:
            fill()

    # -- client side ----------------------------------------------------
    def synthesize(self, text, speaker=0, p_control=1.0, e_control=1.0,
                   d_control=1.0, timeout=120.0, long=False):
        """Blocking: returns the trimmed int16 waveform for one utterance.

        long=True routes through the sentence-splitting long-form path
        (no batching across requests; each chunk is its own dispatch)."""
        self._admit()
        try:
            if long:
                wav, _ = self.synthesizer.synthesize_long(
                    text, speaker=int(speaker), p_control=float(p_control),
                    e_control=float(e_control), d_control=float(d_control))
                with self._stats_lock:
                    self.n_requests += 1
                    self.n_batches += 1
                return wav
            req = _Request(text, int(speaker),
                           (float(p_control), float(e_control),
                            float(d_control)))
            self._queue.put(req)
            if not req.event.wait(timeout):
                raise TimeoutError("synthesis timed out")
            if req.error is not None:
                raise req.error
            return req.result
        finally:
            with self._stats_lock:
                self._pending -= 1

    def _admit(self):
        with self._stats_lock:
            if self._pending >= self.max_pending:
                self.n_shed += 1
                raise ServerOverloaded(
                    f"{self._pending} requests already pending "
                    f"(max_pending={self.max_pending})")
            self._pending += 1

    def synthesize_stream(self, text, speaker=0, p_control=1.0,
                          e_control=1.0, d_control=1.0, timeout=120.0,
                          pause_ms=120.0):
        """Generator of int16 waveform chunks, one per sentence.

        Each sentence enters the shared coalescing queue, so sentences
        from concurrent streams (and ordinary /synthesize requests) share
        fused dispatches.  Inter-sentence pauses are emitted as silence
        chunks, matching synthesize_long's output when concatenated."""
        import re

        import numpy as np

        chunks = [c.strip() for c in
                  re.split(r"(?<=[.!?;:])\s+", text.strip()) if c.strip()]
        sr = self.synthesizer.preprocess_config["preprocessing"]["audio"][
            "sampling_rate"]
        pause = np.zeros(int(sr * pause_ms / 1000.0), np.int16)
        for i, chunk in enumerate(chunks):
            wav = self.synthesize(chunk, speaker, p_control, e_control,
                                  d_control, timeout=timeout)
            yield wav
            if i < len(chunks) - 1:
                yield pause

    # -- dispatcher -----------------------------------------------------
    def _drain(self):
        """Collect up to max_batch_size requests, waiting max_wait_ms after
        the first arrival for stragglers."""
        first = self._queue.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait_ms / 1000.0
        while len(batch) < self.max_batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req is None:
                self._queue.put(None)   # re-signal stop after this batch
                break
            batch.append(req)
        return batch

    def _run(self):
        while not self._stop.is_set():
            batch = self._drain()
            if batch is None:
                return
            # group by control ratios (controls are per-batch scalars)
            groups = {}
            for req in batch:
                groups.setdefault(req.controls, []).append(req)
            for controls, reqs in groups.items():
                self._dispatch(controls, reqs)

    def _dispatch(self, controls, reqs):
        p, e, d = controls
        try:
            wavs, _ = self.synthesizer.synthesize(
                [r.text for r in reqs],
                speakers=[r.speaker for r in reqs],
                p_control=p, e_control=e, d_control=d)
            if wavs is None:
                raise RuntimeError(
                    "synthesizer has no vocoder; serving needs one")
            with self._stats_lock:
                self.n_requests += len(reqs)
                self.n_batches += 1
            for r, w in zip(reqs, wavs):
                r.result = w
                r.event.set()
        except Exception as exc:           # surface to every waiter
            for r in reqs:
                r.error = exc
                r.event.set()

    def stop(self):
        self._stop.set()
        self._queue.put(None)
        self._thread.join(timeout=5)

    def stats(self):
        with self._stats_lock:
            n_req, n_bat = self.n_requests, self.n_batches
            pending, shed = self._pending, self.n_shed
        return {
            "requests": n_req,
            "batches": n_bat,
            "mean_batch": (n_req / n_bat) if n_bat else 0.0,
            "pending": pending,
            "shed": shed,
        }


class TTSServer:
    """HTTP front end over a BatchingSynthesizer."""

    def __init__(self, batching_synthesizer, sampling_rate, host="127.0.0.1",
                 port=0, auth_token=None, max_body_bytes=65536,
                 max_text_len=4096):
        self.batcher = batching_synthesizer
        self.sampling_rate = sampling_rate
        self.auth_token = auth_token
        self.max_body_bytes = max_body_bytes
        self.max_text_len = max_text_len
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):   # quiet
                pass

            def _json(self, code, obj, headers=()):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _shed(self, exc):
                self._json(429, {"error": str(exc)},
                           headers=[("Retry-After", "1")])

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"status": "ok"})
                elif self.path == "/stats":
                    self._json(200, server.batcher.stats())
                else:
                    self._json(404, {"error": "not found"})

            def _authorized(self):
                if server.auth_token is None:
                    return True
                got = self.headers.get("Authorization", "")
                return got == f"Bearer {server.auth_token}"

            def _read_payload(self):
                length = int(self.headers.get("Content-Length", 0))
                if length > server.max_body_bytes:
                    raise PayloadTooLarge(
                        f"request body {length} bytes exceeds "
                        f"{server.max_body_bytes}")
                payload = json.loads(self.rfile.read(length) or b"{}")
                text = payload["text"]
                if not isinstance(text, str) or not text.strip():
                    raise ValueError("'text' must be a non-empty string")
                if len(text) > server.max_text_len:
                    raise ValueError(
                        f"'text' length {len(text)} exceeds "
                        f"max_text_len={server.max_text_len}")
                return payload, text

            def _stream(self, payload, text):
                """Chunked raw-PCM16 response, one chunk per sentence."""
                gen = server.batcher.synthesize_stream(
                    text,
                    speaker=payload.get("speaker", 0),
                    p_control=payload.get("pitch_control", 1.0),
                    e_control=payload.get("energy_control", 1.0),
                    d_control=payload.get("duration_control", 1.0),
                )
                # synthesize the first sentence BEFORE committing to a 200:
                # overload/synthesis errors at the head of the stream can
                # still be reported with a proper status code
                try:
                    first = next(gen)
                except StopIteration:
                    first = None
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    f"audio/L16;rate={server.sampling_rate};channels=1")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                import itertools

                head = () if first is None else (first,)
                try:
                    for wav in itertools.chain(head, gen):
                        data = wav.tobytes()
                        if not data:
                            continue
                        self.wfile.write(f"{len(data):x}\r\n".encode())
                        self.wfile.write(data)
                        self.wfile.write(b"\r\n")
                        self.wfile.flush()
                except ServerOverloaded as exc:
                    # headers already sent: can't 429 any more — make it
                    # a generic mid-stream failure (connection drop)
                    raise RuntimeError(
                        f"overloaded mid-stream: {exc}") from exc
                # Terminal chunk only on successful exhaustion: if the
                # generator raises mid-stream we close the connection
                # without it, so chunked-aware clients see truncation
                # instead of a cleanly completed (but short) response.
                self.wfile.write(b"0\r\n\r\n")
                self.close_connection = True

            def do_POST(self):
                if self.path not in ("/synthesize", "/synthesize_stream"):
                    self._json(404, {"error": "not found"})
                    return
                if not self._authorized():
                    self._json(401, {"error": "missing or invalid "
                                              "bearer token"})
                    return
                try:
                    payload, text = self._read_payload()
                except PayloadTooLarge as exc:
                    self._json(413, {"error": str(exc)})
                    return
                except (ValueError, KeyError, json.JSONDecodeError) as exc:
                    self._json(400, {"error": str(exc)})
                    return
                if self.path == "/synthesize_stream":
                    try:
                        self._stream(payload, text)
                    except ServerOverloaded as exc:
                        # raised before any bytes were sent (_stream
                        # synthesizes the first sentence pre-headers)
                        self._shed(exc)
                    except Exception:
                        # mid-stream failure: drop the connection with no
                        # terminal chunk (see _stream)
                        self.close_connection = True
                    return
                # long texts take the sentence-splitting path; default
                # auto-routes anything the reference would truncate
                # (synthesize.py:203 cuts single-mode input at 100 chars)
                long = payload.get("long")
                if long is None:
                    long = len(text) > 100
                try:
                    wav = server.batcher.synthesize(
                        text,
                        speaker=payload.get("speaker", 0),
                        p_control=payload.get("pitch_control", 1.0),
                        e_control=payload.get("energy_control", 1.0),
                        d_control=payload.get("duration_control", 1.0),
                        long=bool(long),
                    )
                except ServerOverloaded as exc:
                    self._shed(exc)
                    return
                except Exception as exc:
                    self._json(500, {"error": str(exc)})
                    return
                body = wav_bytes(wav, server.sampling_rate)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        # stdlib default listen backlog is 5: a concurrency spike RSTs
        # connections at the socket before the 429 shedding path can
        # answer them.  Accept the burst, shed in-protocol instead.
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128

        self.httpd = _Server((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = None

    def start(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def stop(self):
        # shutdown() waits for serve_forever's loop to end: without a
        # started loop it would wait forever
        if self._thread:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        self.batcher.stop()
