"""English text -> phone IDs, as upstream FastSpeech 2's synthesize.py
reads a sentence: trailing punctuation stripped, the text split on
punctuation and whitespace, each word looked up in the lexicon (first
pronunciation wins, lower case), each punctuation token a short pause
{sp}; the phones mapped through the upstream symbol table, where the 84
ARPAbet symbols (39 base phones in alphabetical order, each vowel followed
by its three stress variants) start at ID 64 and sp, spn and sil are 357,
358 and 359.  A word outside the lexicon raises: the
cells' texts hold none.
"""

import re
from string import punctuation

_VOWELS = "AA AE AH AO AW AY EH ER EY IH IY OW OY UH UW".split()
_CONSONANTS = ("B CH D DH F G HH JH K L M N NG P R S SH T TH V W Y Z "
               "ZH").split()


def _arpabet():
    out = []
    for p in sorted(_VOWELS + _CONSONANTS):
        out.append(p)
        if p in _VOWELS:
            out.extend([p + "0", p + "1", p + "2"])
    return out


PHONE_IDS = {p: 64 + i for i, p in enumerate(_arpabet())}
PHONE_IDS.update({"sp": 357, "spn": 358, "sil": 359})


def read_lexicon(path):
    lexicon = {}
    with open(path) as f:
        for line in f:
            parts = re.split(r"\s+", line.strip("\n"))
            if parts[0].lower() not in lexicon:
                lexicon[parts[0].lower()] = parts[1:]
    return lexicon


def phones(text, lexicon):
    text = text.rstrip(punctuation)
    out = []
    for w in re.split(r"([,;.\-\?\!\s+])", text):
        if w.lower() in lexicon:
            out += lexicon[w.lower()]
        elif re.search(r"[A-Za-z0-9]", w):
            raise ValueError(f"{w!r} is outside the lexicon")
        elif w.strip():
            out.append("sp")
    return out


def text_to_ids(text, lexicon):
    return [PHONE_IDS[p] for p in phones(text, lexicon)
            if p in PHONE_IDS]
