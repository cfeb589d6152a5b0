"""Request texts made from a seed and a traffic file's ``texts`` block.

Words are drawn Zipf-weighted (exponent ``zipf_s``) over one fixed rank
order of the lexicon's plain lower-case words: first ``head`` (a ranked
list in the traffic file), then every other word, shortest first, ties in
alphabetical order.  The order is the same for every seed.  A text's
length in characters is drawn first, normal with ``chars``'s mean and sd
and drawn again until it lies in [min, max]; words are added until the
text reaches it, none taking the text past max.  A comma follows a word
with probability ``comma``, a sentence ends with probability ``period``
after a word, and every text ends with a period.  Text ``i`` depends on
the seed and ``i`` alone.
"""

import re

import numpy as np


def lexicon_words(path):
    words, seen = [], set()
    with open(path) as f:
        for line in f:
            w = line.split(None, 1)[0].lower() if line.strip() else ""
            if re.fullmatch(r"[a-z]+", w) and w not in seen:
                seen.add(w)
                words.append(w)
    return words


def rank_order(words, head):
    """``head`` (those of its words in ``words``), then the other words
    shortest first, ties alphabetical."""
    vocab = set(words)
    first = [w for w in head if w in vocab]
    taken = set(first)
    return first + sorted((w for w in words if w not in taken),
                          key=lambda w: (len(w), w))


class TextGen:
    def __init__(self, params, lexicon_path, seed):
        self.p = params
        self.seed = int(seed)
        self.words = rank_order(lexicon_words(lexicon_path),
                                params.get("head", []))
        ranks = np.arange(1, len(self.words) + 1, dtype=np.float64)
        w = ranks ** -float(params.get("zipf_s", 1.0))
        self.cdf = np.cumsum(w / w.sum())

    def text(self, i):
        p = self.p
        rng = np.random.default_rng([self.seed, 1, int(i)])
        c = p["chars"]
        while True:
            target = int(round(rng.normal(c["mean"], c["sd"])))
            if c["min"] <= target <= c["max"]:
                break
        comma = float(p.get("comma", 0.0))
        period = float(p.get("period", 0.0))
        out, start = "", True
        while len(out) + 1 < target:
            for _ in range(32):
                w = self.words[min(int(np.searchsorted(self.cdf,
                                                       rng.random())),
                                   len(self.words) - 1)]
                if len(out) + len(w) + 2 <= c["max"]:
                    break
            else:
                break
            out += (" " if out else "") + (w.capitalize() if start else w)
            start = False
            r = rng.random()
            if r < period:
                out += "."
                start = True
            elif r < period + comma:
                out += ","
        out = out.rstrip(".,")
        return out + "."

    def texts(self, n):
        return [self.text(i) for i in range(n)]
