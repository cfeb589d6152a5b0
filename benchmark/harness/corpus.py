"""A synthetic preprocessed corpus in the layout the system's loader reads
(``<dir>/{mel,pitch,energy,duration}/<speaker>-<kind>-<base>.npy`` and a
pipe-delimited ``train.txt``), made from a seed.

A run trains on the corpus that its configuration's ``corpus`` block
names (its ``seed`` among it), as a trainer's corpus sits on disk:
:func:`cached` writes it once under the checkout's ``.bench_cache/corpus``
and every later run reads it from there, so that a run's set-up does not
create its 6,400 files anew.

Utterance lengths follow the configuration's ``corpus`` block: seconds
drawn normal(mean, sd) and cut to [min, max], frames = seconds x rate /
hop; about ``frames_per_phone`` frames a phone.  The lengths are the same
for every seed (drawn from a fixed generator), so every seed gives the
same batches' shapes, shape groups and schedule, and the same work; the
seed draws the rest: the phones' durations, a random split of the frames
(each at least one); phones drawn from the
ARPAbet symbols with a pause (sp) now and then; pitch and energy per phone
normal, cut to the configuration's bins; mels random (their values do not
change the work), stored as float16 to keep the bytes written down.
"""

import hashlib
import json
import os
import shutil
import tempfile

import numpy as np

from benchmark.reference.frontend import PHONE_IDS

_PHONES = [p for p in PHONE_IDS if p not in ("sp", "spn", "sil")]
SIZES_SEED = 11


def cached(root, corpus, stats, n_mels, sampling_rate, hop):
    """The directory of the corpus that ``corpus`` (with its ``seed``)
    and the rest describe, under ``<root>/.bench_cache/corpus/``, written
    there first if no run has written it (staged, then renamed into place
    whole)."""
    h = hashlib.sha256(json.dumps([corpus, stats, n_mels, sampling_rate,
                                   hop], sort_keys=True).encode())
    with open(__file__, "rb") as f:
        h.update(f.read())
    key = h.hexdigest()[:16]
    parent = os.path.join(root, ".bench_cache", "corpus")
    path = os.path.join(parent, key)
    if not os.path.isdir(path):
        os.makedirs(parent, exist_ok=True)
        staging = tempfile.mkdtemp(prefix=key + ".", dir=parent)
        write(staging, corpus, stats, n_mels, sampling_rate, hop,
              corpus["seed"])
        try:
            os.rename(staging, path)
        except OSError:   # another run put it there first
            shutil.rmtree(staging, ignore_errors=True)
    return path


def link(src, out_dir):
    """Make ``out_dir`` (which holds the run's stats and speakers) read the
    corpus at ``src``: its feature folders linked, its lists copied."""
    for sub in ("mel", "pitch", "energy", "duration"):
        os.symlink(os.path.join(src, sub), os.path.join(out_dir, sub))
    for name in ("train.txt", "val.txt"):
        shutil.copyfile(os.path.join(src, name), os.path.join(out_dir, name))


def write(out_dir, corpus, stats, n_mels, sampling_rate, hop, seed):
    """-> the number of utterances written."""
    rng = np.random.default_rng([int(seed), 11])
    for sub in ("mel", "pitch", "energy", "duration"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    s = corpus["seconds"]
    n = int(corpus["n_utterances"])
    secs = np.clip(np.random.default_rng(SIZES_SEED).normal(
        s["mean"], s["sd"], n), s["min"], s["max"])
    frames = np.round(secs * sampling_rate / hop).astype(np.int64)
    lines = []
    p_lo, p_hi = stats["pitch"][0], stats["pitch"][1]
    e_lo, e_hi = stats["energy"][0], stats["energy"][1]
    for u in range(n):
        T = int(frames[u])
        n_ph = max(2, int(round(T / corpus["frames_per_phone"])))
        cuts = np.sort(rng.choice(np.arange(1, T), n_ph - 1, replace=False))
        dur = np.diff(np.concatenate([[0], cuts, [T]])).astype(np.int64)
        phones = [_PHONES[i] for i in rng.integers(len(_PHONES), size=n_ph)]
        for j in np.nonzero(rng.random(n_ph) < corpus["pause_share"])[0]:
            phones[j] = "sp"
        base = f"syn{u:05d}"
        np.save(os.path.join(out_dir, "duration",
                             f"S-duration-{base}.npy"), dur)
        np.save(os.path.join(out_dir, "pitch", f"S-pitch-{base}.npy"),
                np.clip(rng.normal(0.0, 1.0, n_ph), p_lo, p_hi))
        np.save(os.path.join(out_dir, "energy", f"S-energy-{base}.npy"),
                np.clip(rng.normal(0.0, 1.0, n_ph), e_lo, e_hi)
                .astype(np.float32))
        np.save(os.path.join(out_dir, "mel", f"S-mel-{base}.npy"),
                (rng.standard_normal((T, n_mels), dtype=np.float32) * 1.2
                 - 5.0).astype(np.float16))
        lines.append(f"{base}|S|{{{' '.join(phones)}}}|synthetic")
    with open(os.path.join(out_dir, "train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(out_dir, "val.txt"), "w") as f:
        f.write("")
    return n
