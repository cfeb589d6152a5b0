"""Time the port's HTTP server on a CUDA card, with its CUDA graphs and
without them, and the synthesize CLI's one-shot ``--long``.

The server is the serve CLI's ``build_server`` on the tracked LJSpeech10
weights (``--max_batch_size 16``, ``warmup(grid="top")``: every request
within 16 x 128 snaps to one graph).  Request mix: the 10 transcripts of
the tracked corpus the voice was trained on
(``preprocessed_data/LJSpeech10/{train,val}.txt``, 47 to 170 characters),
drawn uniformly with a seeded generator and POSTed as ``{"text": ...}``
to ``/synthesize``: the server's own routing then sends the texts longer
than 100 characters (5 of 10) down the sentence-split long path.  Latency
is the host clock from the POST to the last byte.

- ``--requests N``: N requests one at a time per segment -> p50, p95,
  p99 and mean latency.
- ``--bursts K``: K bursts of ``--concurrency`` requests per segment ->
  utterances/s over the bursts' wall time, ``mean_batch`` from ``/stats``,
  and the latencies.
- The segments run graphs on, off, off, on (ABBA), and each mode's two
  segments are pooled.  "Off" sets ``Synthesizer.graphs`` to None: the same
  fused dispatch at the same snapped shapes, run eagerly.
- ``--long-runs R``: ``synthesize_cli.main`` with ``--mode single --long``
  on three sentences, R times in this process (the first builds the
  kernels and is not reported): the CLI's wall time and the time inside
  ``Synthesizer.synthesize_long``.  ``--long-only`` skips the server (for
  a checkout that has none).
- ``--root DIR`` runs the port of another checkout (for example an
  unpacked parent commit): its ``fastspeech2_tpu_torch`` is imported
  instead of this one, and built there.  The checkout needs the neural
  G2P's weights (``fastspeech2_tpu/text/data/g2p_seq2seq.npz``), or its
  frontend would be another one: the script stops without them.

Run from a checkout's root (it reads ``config/``, ``weights/`` and
``preprocessed_data/`` there): ``python
fastspeech2_tpu_torch/tools/serve_bench.py [--requests 150] [--bursts 6]
[--long-runs 4] [--long-only] [--root DIR] [--json FILE]``.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = "config/LJSpeech10"
ACOUSTIC_NPZ = "weights/acoustic_LJSpeech10_100k.npz"
VOCODER_NPZ = "weights/vocoder_gen_mixed60k.npz"
CORPUS = ("preprocessed_data/LJSpeech10/train.txt",
          "preprocessed_data/LJSpeech10/val.txt")
LONG_TEXT = ("The quick brown fox jumps over the lazy dog. The soviet "
             "authorities denied oswald permission. They bought their "
             "offices from one another.")


def corpus_texts():
    texts = []
    for path in CORPUS:
        with open(path) as f:
            texts += [line.rstrip("\n").split("|")[3] for line in f]
    return texts


def percentiles(ms):
    ms = np.asarray(ms, np.float64)
    return {"n": int(ms.size), "p50_ms": float(np.percentile(ms, 50)),
            "p95_ms": float(np.percentile(ms, 95)),
            "p99_ms": float(np.percentile(ms, 99)),
            "mean_ms": float(ms.mean()), "max_ms": float(ms.max())}


def post(url, text):
    req = urllib.request.Request(
        url + "/synthesize", data=json.dumps({"text": text}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        body = r.read()
        if r.status != 200 or body[:4] != b"RIFF":
            raise RuntimeError(f"status {r.status} for {text!r}")
    return (time.perf_counter() - t0) * 1e3


def segment(url, batcher, texts, rng, n_requests, n_bursts, concurrency):
    """One segment: requests one at a time, then bursts."""
    c1 = [post(url, texts[i])
          for i in rng.integers(0, len(texts), n_requests)]
    burst_ms, burst_s = [], 0.0
    stats0 = batcher.stats()
    for _ in range(n_bursts):
        picks = rng.integers(0, len(texts), concurrency)
        lat = [None] * concurrency

        def call(j):
            lat[j] = post(url, texts[picks[j]])

        threads = [threading.Thread(target=call, args=(j,))
                   for j in range(concurrency)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        burst_s += time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or None in lat:
            raise RuntimeError("a burst request failed or hung")
        burst_ms += lat
    stats1 = batcher.stats()
    return c1, burst_ms, burst_s, (stats1["requests"] - stats0["requests"],
                                   stats1["batches"] - stats0["batches"])


def serve(args, log):
    from fastspeech2_tpu_torch.cli import serve_cli

    server = serve_cli.build_server(serve_cli.build_parser().parse_args([
        "-p", f"{CONFIG}/preprocess.yaml", "-m", f"{CONFIG}/model.yaml",
        "-t", f"{CONFIG}/train.yaml", "--weights_npz", ACOUSTIC_NPZ,
        "--vocoder_ckpt", VOCODER_NPZ, "--port", "0", "--max_batch_size",
        "16"]))
    batcher = server.batcher
    syn = batcher.synthesizer
    graphs = syn.graphs
    if graphs is None:
        raise RuntimeError("the synthesizer has no CUDA graphs")
    texts = corpus_texts()
    rng = np.random.default_rng(args.seed)
    pooled = {m: {"c1": [], "burst": [], "burst_s": 0.0, "req": 0, "bat": 0}
              for m in ("on", "off")}
    try:
        batcher.warmup(grid="top", log=log)
        server.start()
        url = f"http://127.0.0.1:{server.port}"
        for text in texts:            # the frontend's and the paths' first
            post(url, text)           # calls, not timed
        warm = set(syn._warm)
        for mode in ("on", "off", "off", "on"):
            # without graphs an eager dispatch marks its shape warm: each
            # segment starts from the warmup's shapes
            with syn._warm_lock:
                syn._warm = set(warm)
            syn.graphs = graphs if mode == "on" else None
            c1, burst, burst_s, (req, bat) = segment(
                url, batcher, texts, rng, args.requests, args.bursts,
                args.concurrency)
            p = pooled[mode]
            p["c1"] += c1
            p["burst"] += burst
            p["burst_s"] += burst_s
            p["req"] += req
            p["bat"] += bat
            log(f"[serve_bench] graphs {mode}: concurrency 1 p50 "
                f"{np.percentile(c1, 50):.2f} ms; bursts "
                f"{len(burst) / burst_s:.2f} utterances/s")
    finally:
        syn.graphs = graphs
        server.stop()
    result = {}
    for mode, p in pooled.items():
        result[mode] = {
            "concurrency_1": percentiles(p["c1"]),
            "burst": dict(percentiles(p["burst"]),
                          utterances_per_s=len(p["burst"]) / p["burst_s"],
                          mean_batch=p["req"] / max(p["bat"], 1),
                          bursts=2 * args.bursts,
                          concurrency=args.concurrency)}
    result["graphs"] = sorted(graphs.graphs)
    result["capture_seconds"] = graphs.capture_seconds
    return result


def long_cli(args, log):
    import torch

    from fastspeech2_tpu_torch.cli import synthesize_cli
    from fastspeech2_tpu_torch.synthesis.pipeline import Synthesizer

    inner = Synthesizer.synthesize_long
    spent = []

    def timed(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return inner(self, *a, **k)
        finally:
            spent.append((time.perf_counter() - t0) * 1e3)

    Synthesizer.synthesize_long = timed
    wall = []
    try:
        with tempfile.TemporaryDirectory() as out:
            for _ in range(args.long_runs):
                t0 = time.perf_counter()
                synthesize_cli.main([
                    "--mode", "single", "--long", "--text", LONG_TEXT,
                    "-p", f"{CONFIG}/preprocess.yaml",
                    "-m", f"{CONFIG}/model.yaml",
                    "-t", f"{CONFIG}/train.yaml",
                    "--weights_npz", ACOUSTIC_NPZ,
                    "--vocoder_ckpt", VOCODER_NPZ, "--result_path", out])
                wall.append((time.perf_counter() - t0) * 1e3)
    finally:
        Synthesizer.synthesize_long = inner
    log(f"[serve_bench] --long: main {[round(w, 2) for w in wall]} ms, "
        f"synthesize_long {[round(s, 2) for s in spent]} ms (the first "
        f"builds the kernels)")
    return {"main_ms": wall[1:], "synthesize_long_ms": spent[1:],
            "first_main_ms": wall[0]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose fastspeech2_tpu_torch is timed")
    ap.add_argument("--requests", type=int, default=150)
    ap.add_argument("--bursts", type=int, default=6)
    ap.add_argument("--concurrency", type=int, default=32)
    ap.add_argument("--long-runs", type=int, default=4)
    ap.add_argument("--long-only", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="also write results here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("serve_bench: no CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    from fastspeech2_tpu_torch.synthesis import pipeline

    from fastspeech2_tpu_torch.text import neural_g2p

    if not pipeline.__file__.startswith(os.path.abspath(args.root) + os.sep):
        sys.exit(f"serve_bench: imported {pipeline.__file__}, not the port "
                 f"in {args.root} (run this file, not the module)")
    if not neural_g2p.available():
        # the frontend would fall back to the rule engine for the words the
        # lexicon lacks, and time another frontend
        sys.exit(f"serve_bench: no neural G2P weights at "
                 f"{neural_g2p.DEFAULT_WEIGHTS}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    def log(msg):
        print(msg, flush=True)

    result = dict(root=os.path.abspath(args.root), card=card)
    log(f"[serve_bench] {card}; port from {result['root']}")
    if args.long_runs:
        result["long"] = long_cli(args, log)
    if not args.long_only:
        result["serve"] = serve(args, log)
    line = json.dumps(result)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
