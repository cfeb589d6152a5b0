"""Which batches a scan-mode training run trains on, worked out again from
the corpus on disk: upstream FastSpeech 2's grouped-sorted batching
(shuffle, take group_size x batch_size utterances, sort them by text
length, longest first, cut them into batches; the last partial batch
dropped) padded to bucketed shapes, and epoch 0's batches grouped by
shape in the order each shape first appears.  numpy only.
"""

import os

import numpy as np

from benchmark.reference.frontend import PHONE_IDS

KEYS = ("speakers", "texts", "src_lens", "mels", "mel_lens", "pitches",
        "energies", "durations")


def round_up(n, m):
    return ((int(n) + m - 1) // m) * m


class Corpus:
    def __init__(self, path):
        self.path = path
        self.rows = []
        with open(os.path.join(path, "train.txt")) as f:
            for line in f:
                base, spk, text, _ = line.rstrip("\n").split("|")
                ids = [PHONE_IDS[p] for p in text.strip("{}").split()]
                self.rows.append((base, spk, np.asarray(ids, np.int64)))

    def item(self, i):
        base, spk, ids = self.rows[i]

        def load(kind):
            return np.load(os.path.join(self.path, kind,
                                        f"{spk}-{kind}-{base}.npy"))

        return {"text": ids, "mel": load("mel"), "pitch": load("pitch"),
                "energy": load("energy"), "duration": load("duration")}


def collate(items, text_bucket, mel_bucket, max_mel_len):
    B = len(items)
    P = round_up(max(len(s["text"]) for s in items), text_bucket)
    T = min(round_up(max(s["mel"].shape[0] for s in items), mel_bucket),
            round_up(max_mel_len, mel_bucket))
    n_mels = items[0]["mel"].shape[1]
    out = {"speakers": np.zeros(B, np.int64),
           "texts": np.zeros((B, P), np.int64),
           "src_lens": np.zeros(B, np.int64),
           "mels": np.zeros((B, T, n_mels), np.float32),
           "mel_lens": np.zeros(B, np.int64),
           "pitches": np.zeros((B, P), np.float32),
           "energies": np.zeros((B, P), np.float32),
           "durations": np.zeros((B, P), np.int64)}
    for b, s in enumerate(items):
        p, t = len(s["text"]), min(s["mel"].shape[0], T)
        out["texts"][b, :p] = s["text"]
        out["src_lens"][b] = p
        out["mels"][b, :t] = s["mel"][:t]
        out["mel_lens"][b] = t
        out["pitches"][b, :p] = s["pitch"][:p]
        out["energies"][b, :p] = s["energy"][:p]
        out["durations"][b, :p] = s["duration"][:p]
    return out


def epoch_batches(corpus, batch_size, group_size, text_bucket, mel_bucket,
                  max_mel_len, seed=0):
    """Epoch 0's batches as index lists (utterance indices) with their
    padded shapes, without reading any feature."""
    n = len(corpus.rows)
    lens = np.array([len(r[2]) for r in corpus.rows])
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    group = batch_size * group_size
    out = []
    for start in range(0, n, group):
        chunk = order[start:start + group]
        chunk = chunk[np.argsort(-lens[chunk])]
        for b in range(0, len(chunk), batch_size):
            idx = chunk[b:b + batch_size]
            if len(idx) == batch_size:
                out.append(idx)
    return out


def group_firsts(corpus_dir, loader):
    """The first batch (a numpy dict) of each shape group, in group order;
    ``loader``: batch_size, group_size, text_bucket, mel_bucket,
    max_mel_len."""
    corpus = Corpus(corpus_dir)
    shapes, firsts = set(), []
    for idx in epoch_batches(corpus, **loader):
        items = [corpus.rows[i] for i in idx]
        mel_T = max(np.load(os.path.join(
            corpus_dir, "duration", f"{spk}-duration-{base}.npy")).sum()
            for base, spk, _ in items)
        P = round_up(max(len(r[2]) for r in items), loader["text_bucket"])
        T = min(round_up(mel_T, loader["mel_bucket"]),
                round_up(loader["max_mel_len"], loader["mel_bucket"]))
        if (P, T) not in shapes:
            shapes.add((P, T))
            firsts.append(collate([corpus.item(j) for j in idx],
                                  loader["text_bucket"], loader["mel_bucket"],
                                  loader["max_mel_len"]))
    return firsts
