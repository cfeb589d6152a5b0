"""Minimal Praat TextGrid reader (stand-in for the `tgt` dependency; a copy
of ``fastspeech2_tpu/preprocessing/textgrid.py``, which is pure Python).

Parses interval tiers from both long ("ooTextFile" with item [] blocks) and
short TextGrid formats, which covers Montreal Forced Aligner output — the
only use in this framework (reference preprocessor/preprocessor.py:163-167
reads the "phones" tier).
"""

import re
from dataclasses import dataclass
from typing import List


@dataclass
class Interval:
    start_time: float
    end_time: float
    text: str


@dataclass
class IntervalTier:
    name: str
    intervals: List[Interval]


@dataclass
class TextGrid:
    tiers: List[IntervalTier]

    def get_tier_by_name(self, name):
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(f"no tier named {name!r}")


_NUM_RE = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")
_STR_RE = re.compile(r'"((?:[^"]|"")*)"')


def read_textgrid(path):
    with open(path, encoding="utf-8") as f:
        content = f.read()
    if "item" in content and "intervals" in content:
        return _parse_long(content)
    return _parse_short(content)


def _parse_long(content):
    tiers = []
    # split on item [n] blocks (skip the "item []:" header)
    blocks = re.split(r"item \[\d+\]:", content)[1:]
    for block in blocks:
        cls = _STR_RE.search(block)
        if cls is None or cls.group(1) != "IntervalTier":
            continue
        name_m = re.search(r'name\s*=\s*"((?:[^"]|"")*)"', block)
        name = name_m.group(1).replace('""', '"') if name_m else ""
        intervals = []
        for m in re.finditer(
            r"intervals \[\d+\]:\s*"
            r"xmin\s*=\s*([-\d.eE+]+)\s*"
            r"xmax\s*=\s*([-\d.eE+]+)\s*"
            r'text\s*=\s*"((?:[^"]|"")*)"',
            block,
        ):
            intervals.append(Interval(
                float(m.group(1)), float(m.group(2)),
                m.group(3).replace('""', '"')))
        tiers.append(IntervalTier(name, intervals))
    return TextGrid(tiers)


def _parse_short(content):
    """Short format: header then per-tier: class, name, xmin, xmax, count,
    then triples (xmin, xmax, text)."""
    toks = []
    for line in content.splitlines():
        line = line.strip()
        if not line:
            continue
        sm = _STR_RE.fullmatch(line)
        if sm:
            toks.append(("s", sm.group(1).replace('""', '"')))
            continue
        nm = _NUM_RE.fullmatch(line)
        if nm:
            toks.append(("n", float(line)))
            continue
        # header lines like 'File type = "ooTextFile"'
        for s in _STR_RE.findall(line):
            toks.append(("s", s.replace('""', '"')))
        for n in _NUM_RE.findall(line):
            if not _STR_RE.search(line):
                toks.append(("n", float(n)))
    # walk: find "IntervalTier" markers
    tiers = []
    i = 0
    while i < len(toks):
        if toks[i] == ("s", "IntervalTier"):
            name = toks[i + 1][1]
            count = int(toks[i + 4][1])
            j = i + 5
            intervals = []
            for _ in range(count):
                intervals.append(Interval(
                    toks[j][1], toks[j + 1][1], toks[j + 2][1]))
                j += 3
            tiers.append(IntervalTier(name, intervals))
            i = j
        else:
            i += 1
    return TextGrid(tiers)
