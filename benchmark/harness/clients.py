"""The load generator, run as a process of its own so that its threads do
not share the server's interpreter:

    python benchmark/harness/clients.py SPEC.json

SPEC holds the port, the seed, the window's seconds, the traffic file's
``load`` and ``texts`` blocks, the lexicon path and an output directory.

A closed loop: ``load.clients`` threads, each sending its next text as
soon as its last reply has come; client c's k-th text is text
k * clients + c.  Every client has ``load.warm`` replies before the
window.  A request is timed from when it is sent to the last byte of its
reply.

Stdout carries "READY" once the warm replies are in, then, after a line
"GO" on stdin, "WINDOW <t0>" when
the window opens and "END <t1>" when it closes (time.monotonic, which the
server's process shares); after the
requests in flight have ended, records.json (one record a request of the
window) and sample.npz (the replies the correctness check may draw: those
whose key, drawn from the seed, is below ``sample_share``, and the longest)
go to the output directory, and the process exits.
"""

import http.client
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.harness.texts import TextGen  # noqa: E402

DRAIN_S = 60.0


def post(port, text, timeout=120.0):
    """-> (status, body bytes or None)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/synthesize", body=json.dumps({"text": text}),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    except (OSError, http.client.HTTPException):
        return -1, None
    finally:
        conn.close()


def wav_samples(body):
    """RIFF bytes -> int16 samples, or None if the reply is no wav."""
    if body is None or len(body) < 44 or body[:4] != b"RIFF" \
            or body[8:12] != b"WAVE":
        return None
    n = int.from_bytes(body[40:44], "little")
    if n != len(body) - 44:
        return None
    return np.frombuffer(body[44:], dtype="<i2")


class Recorder:
    def __init__(self, keys, share):
        self.keys = keys
        self.share = share
        self.lock = threading.Lock()
        self.records = []
        self.kept = {}
        self.longest = (-1, None, None)

    def add(self, rec, body):
        wav = wav_samples(body) if rec["status"] == 200 else None
        rec["ok"] = wav is not None
        rec["samples"] = 0 if wav is None else int(wav.size)
        with self.lock:
            self.records.append(rec)
            if wav is None:
                return
            if self.keys[rec["id"]] < self.share:
                self.kept[rec["id"]] = wav
            if wav.size > self.longest[0]:
                self.longest = (wav.size, rec["id"], wav)


def await_go(out):
    out.write("READY\n")
    out.flush()
    if sys.stdin.readline().strip() != "GO":
        raise SystemExit("no GO from the harness")


def closed_loop(spec, gen, rec, out):
    load = spec["load"]
    n, warm = load["clients"], load.get("warm", 2)
    port = spec["port"]
    window = {}
    warmed = threading.Barrier(n + 1)

    def client(c):
        k = 0
        for _ in range(warm):
            post(port, gen.text(k * n + c))
            k += 1
        warmed.wait()
        t_end = window["end"]
        while True:
            t_send = time.monotonic()
            if t_send >= t_end:
                return
            idx = k * n + c
            status, body = post(port, gen.text(idx))
            t_done = time.monotonic()
            rec.add({"id": idx, "t_send": t_send, "t_done": t_done,
                     "status": status}, body)
            k += 1

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n)]
    for t in threads:
        t.start()
    # the window opens when every client has had its warm replies and the
    # harness has said GO
    window["end"] = float("inf")
    while warmed.n_waiting < n:
        time.sleep(0.001)
    await_go(out)
    t0 = time.monotonic()
    window["end"] = t0 + spec["seconds"]
    warmed.wait()
    out.write(f"WINDOW {t0!r}\n")
    out.flush()
    time.sleep(max(0.0, window["end"] - time.monotonic()))
    out.write(f"END {time.monotonic()!r}\n")
    out.flush()
    for t in threads:
        t.join(DRAIN_S + 130.0)
    return t0, window["end"]


def main(spec_path):
    with open(spec_path) as f:
        spec = json.load(f)
    gen = TextGen(spec["texts"], spec["lexicon"], spec["seed"])
    keys = np.random.default_rng([int(spec["seed"]), 5]).random(
        int(spec["n_texts"]))
    rec = Recorder(keys, float(spec["sample_share"]))
    out = sys.stdout
    t0, t1 = closed_loop(spec, gen, rec, out)
    summary = {"t0": t0, "t1": t1, "records": rec.records}
    kept = dict(rec.kept)
    if rec.longest[1] is not None:
        kept[rec.longest[1]] = rec.longest[2]
    summary["longest"] = rec.longest[1]
    os.makedirs(spec["out_dir"], exist_ok=True)
    with open(os.path.join(spec["out_dir"], "records.json"), "w") as f:
        json.dump(summary, f)
    np.savez(os.path.join(spec["out_dir"], "sample.npz"),
             **{str(k): v for k, v in kept.items()})
    out.write("DONE\n")
    out.flush()


if __name__ == "__main__":
    main(sys.argv[1])
