"""Algorithmic tone-numbered-pinyin -> initial/final phone decomposition (a
copy of ``fastspeech2_tpu/text/pinyin_g2p.py``).

Replaces the reference's static 4,120-line lexicon file
(lexicon/pinyin-lexicon-r.txt, read by synthesize.py:20-29) with the
underlying decomposition rules; `generate_lexicon()` regenerates the full
table, and a test verifies the output matches the reference file entry for
entry.  Conventions (visible throughout that lexicon):

  - trailing 'r' before the tone digit = erhua -> append "rr"
  - zh/ch/sh/r + "i" -> apical vowel "iii"; z/c/s + "i" -> "ii"
  - j/q/x/y + "u(...)" -> umlaut "v(...)"; explicit "v"/"lv" kept
  - abbreviations iu -> iou, ui -> uei, un -> uen
  - y- syllables: yi->i, yin->in, ying->ing, y+vowel -> i-final (ya->ia),
    yo/you->iou, yu*->v*; w- syllables: wu->u, w+vowel -> u-final (wa->ua),
    wen/weng->uen
  - bare finals (a, ai, er, ...) have no initial
"""

from fastspeech2_tpu_torch.text.pinyin import (
    _BASE_FINALS,
    initials as INITIALS,
)

_MULTI_INITIALS = ("zh", "ch", "sh")
_FINAL_SET = set(_BASE_FINALS)


def split_pinyin(syllable):
    """'zhuang1' -> ('zh', 'uang1') ; 'a3' -> ('', 'a3') ; erhua appends rr.

    Returns a list of phone strings, or None if not a valid syllable.
    """
    syllable = syllable.strip().lower()
    if not syllable or not syllable[-1].isdigit():
        return None
    tone = syllable[-1]
    body = syllable[:-1]
    erhua = False
    if len(body) > 1 and body.endswith("r") and body != "er":
        erhua = True
        body = body[:-1]

    phones = _decompose(body, tone)
    if phones is None:
        return None
    if erhua:
        phones = phones + ["rr"]
    return phones


def _decompose(body, tone):
    if body in ("er", "r"):  # bare "r<tone>" is the erhua syllable itself
        return ["er" + tone]
    if body in _FINAL_SET:
        return [body + tone]

    # pick the initial (longest match first)
    initial = None
    for cand in _MULTI_INITIALS:
        if body.startswith(cand):
            initial = cand
            break
    if initial is None and body and body[0] in set("bcdfghjklmnpqrstwxyz"):
        initial = body[0]
    if initial is None:
        return None
    rest = body[len(initial):]

    final = _normalize_final(initial, rest)
    if final is None or final not in _FINAL_SET:
        return None
    return [initial, final + tone]


def _normalize_final(initial, rest):
    if initial in ("zh", "ch", "sh", "r") and rest == "i":
        return "iii"
    if initial in ("z", "c", "s") and rest == "i":
        return "ii"
    if initial == "y":
        if rest in ("i", "in", "ing"):
            return rest if rest != "i" else "i"
        if rest == "o" or rest == "ou":
            return "iou"
        if rest.startswith("u"):        # yu, yue, yuan, yun -> v-series
            return {"u": "v", "ue": "ve", "uan": "van",
                    "un": "vn"}.get(rest)
        if rest == "e":
            return "ie"
        if rest == "ong":
            return "iong"
        return "i" + rest if ("i" + rest) in _FINAL_SET else None
    if initial == "w":
        if rest == "u":
            return "u"
        if rest in ("en", "eng"):
            return "uen"
        if rest == "o":
            return "uo"
        return "u" + rest if ("u" + rest) in _FINAL_SET else None
    # abbreviations
    if rest == "iu":
        return "iou"
    if rest == "ui":
        return "uei"
    if rest == "un":
        return "vn" if initial in ("j", "q", "x") else "uen"
    if rest == "o" and initial in ("b", "p", "m", "f"):
        return "o"  # labial + o keeps the bare final in this lexicon
    if initial in ("j", "q", "x"):
        if rest.startswith("u"):
            mapped = "v" + rest[1:]
            return mapped if mapped in _FINAL_SET else None
    if rest == "e" and initial in ("l", "n") or rest == "ue":
        # lue/nue -> ve handled via explicit ue; plain le/ne stay "e"
        if rest == "ue":
            return "ve"
    if rest.startswith("v"):
        return rest if rest in _FINAL_SET else None
    return rest if rest in _FINAL_SET else None


def generate_lexicon():
    """Regenerate the pinyin lexicon: {syllable: [phones]} over all valid
    syllables x tones 1-5 x (plain, erhua)."""
    lex = {}
    syllables = _enumerate_syllables()
    for body in syllables:
        for tone in "12345":
            plain = split_pinyin(body + tone)
            if plain:
                lex[body + tone] = plain
            if body != "er":
                er = split_pinyin(body + "r" + tone)
                if er:
                    lex[body + "r" + tone] = er
    return lex


def _enumerate_syllables():
    """All pinyin syllable bodies appearing in standard Mandarin, derived by
    validating initial x surface-final combinations through _decompose."""
    bodies = set(_BASE_FINALS) | {"er", "r"}
    surface_finals = set()
    for f in _BASE_FINALS:
        surface_finals.add(f)
    surface_finals |= {"i", "u", "o", "e", "iu", "ui", "un", "ue"}
    for ini in INITIALS:
        for rest in surface_finals:
            body = ini + rest
            if _decompose(body, "1"):
                bodies.add(body)
    return sorted(bodies)
