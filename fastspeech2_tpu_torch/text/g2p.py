"""Grapheme-to-phoneme conversion for synthesis input (port of
``fastspeech2_tpu/text/g2p.py``).

English follows the reference flow (synthesize.py:32-56): strip trailing
punctuation, split on punctuation/whitespace, look each word up in the
lexicon, send out-of-vocabulary words to ``oov_to_phones``, map non-word
leftovers to {sp}.  :func:`make_oov_to_phones` builds the OOV chain the JAX
package takes when ``g2p_en`` is not installed: the trained seq2seq model
(text/neural_g2p.py), then the rule engine.  The port never uses
``g2p_en``.

Mandarin follows synthesize.py:59-84: text -> TONE3 pinyin (through
``pypinyin`` where it is installed; otherwise the input must already be
tone-numbered pinyin tokens) -> lexicon initial/final phones, else the
algorithmic decomposition (text/pinyin_g2p.py), OOV -> "sp".
"""

import re

from fastspeech2_tpu_torch.text.letter_to_sound import letter_to_sound


def make_oov_to_phones(device="cpu"):
    """word -> phones: the neural G2P on ``device`` when its weights are
    present, else (or when it returns nothing) the rule engine."""
    from fastspeech2_tpu_torch.text import neural_g2p

    model = (neural_g2p.NeuralG2P(device=device)
             if neural_g2p.available() else None)

    def oov_to_phones(word):
        if model is not None:
            phones = model(word)
            if phones:
                return phones
        return letter_to_sound(word)

    return oov_to_phones


def read_lexicon(lex_path):
    """word -> [phones] (first pronunciation wins; synthesize.py:20-29)."""
    lexicon = {}
    with open(lex_path) as f:
        for line in f:
            temp = re.split(r"\s+", line.strip("\n"))
            word, phones = temp[0], temp[1:]
            if word.lower() not in lexicon:
                lexicon[word.lower()] = phones
    return lexicon


def _token_to_phones(w, lexicon, oov_to_phones):
    """One split token -> phones: lexicon hit, else verbalize digits and
    recurse per word, else the OOV chain."""
    if w.lower() in lexicon:
        return list(lexicon[w.lower()])
    stripped = w.strip("\"'()[]`“”‘’").lower()
    if stripped and stripped in lexicon:
        return list(lexicon[stripped])
    if re.search(r"[0-9]", w):
        from fastspeech2_tpu_torch.text.numbers import normalize_numbers

        expanded = normalize_numbers(w)
        if expanded != w:
            phones = []
            for part in re.split(r"[\s\-,]+", expanded):
                if part:
                    phones += _token_to_phones(part, lexicon, oov_to_phones)
            return phones
    return oov_to_phones(w)


def english_to_phones(text, lexicon, oov_to_phones=letter_to_sound):
    """Sentence -> phone string '{HH AH0 ...}' with sp for punctuation."""
    from string import punctuation

    text = text.rstrip(punctuation)
    phones = []
    words = re.split(r"([,;.\-\?\!\s+])", text)
    for w in words:
        if w.lower() in lexicon:
            phones += lexicon[w.lower()]
        elif re.search(r"[A-Za-z0-9]", w):
            phones += _token_to_phones(w, lexicon, oov_to_phones)
        elif w.strip():
            # punctuation token: becomes a short pause ({sp}) below
            phones.append(w.strip())
    out = "{" + "}{".join(phones) + "}"
    out = re.sub(r"\{[^\w\s]?\}", "{sp}", out)
    return out.replace("}{", " ")



def mandarin_to_phones(text, lexicon):
    """Hanzi or tone-numbered pinyin -> phone string."""
    try:  # pragma: no cover - optional dependency
        from pypinyin import Style, pinyin

        pinyins = [
            p[0] for p in pinyin(
                text, style=Style.TONE3, strict=False,
                neutral_tone_with_five=True)
        ]
    except ImportError:
        if re.search(r"[一-鿿]", text):
            raise RuntimeError(
                "pypinyin is unavailable: pass tone-numbered pinyin "
                "(e.g. 'ni3 hao3') instead of hanzi")
        pinyins = text.split()
    from fastspeech2_tpu_torch.text.pinyin_g2p import split_pinyin

    phones = []
    for p in pinyins:
        if p in lexicon:
            phones += lexicon[p]
        else:
            # the algorithmic decomposition, OOV -> sp as upstream
            decomposed = split_pinyin(p)
            if decomposed:
                phones += decomposed
            else:
                phones.append("sp")
    return "{" + " ".join(phones) + "}"
