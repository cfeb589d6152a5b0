"""PyTorch port, text frontend: the README sentence must give the same
phones and phone IDs in both packages, the out-of-vocabulary words
included (they go through the neural G2P, whose decoders are compared
word by word); Mandarin tone-numbered pinyin gives the same
decomposition, phones and IDs, and hanzi without pypinyin the same
error."""

import os
import sys

import numpy as np
import pytest

from fastspeech2_tpu.text import text_to_sequence as jax_text_to_sequence
from fastspeech2_tpu.text import neural_g2p as jax_neural_g2p
from fastspeech2_tpu.text.g2p import english_to_phones as jax_english_to_phones
from fastspeech2_tpu.text.g2p import read_lexicon
from fastspeech2_tpu_torch.text import text_to_sequence
from fastspeech2_tpu_torch.text import neural_g2p
from fastspeech2_tpu_torch.text.g2p import english_to_phones, make_oov_to_phones

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEXICON = os.path.join(REPO, "lexicon", "ljspeech-mined.txt")
README_SENTENCE = "The quick brown fox jumps over the lazy dog."
WORDS = ["fox", "lazy", "quixotic", "zelda", "hypothesize"]


@pytest.fixture(scope="module")
def lexicon():
    return read_lexicon(LEXICON)


def test_readme_sentence_phone_ids_match_jax(lexicon):
    # "fox" and "lazy" are out of the lexicon: the neural G2P decides them
    assert "fox" not in lexicon and "lazy" not in lexicon
    ref_phones = jax_english_to_phones(README_SENTENCE, lexicon)
    phones = english_to_phones(README_SENTENCE, lexicon,
                               make_oov_to_phones("cpu"))
    assert phones == ref_phones
    cleaners = ["english_cleaners"]
    ids = text_to_sequence(phones, cleaners)
    assert ids == jax_text_to_sequence(ref_phones, cleaners)
    assert len(ids) > 20


@pytest.mark.parametrize("beam", [1, 4])
def test_neural_g2p_decoders_match_jax(beam):
    ref = jax_neural_g2p.NeuralG2P(beam=beam).batch(WORDS)
    got = neural_g2p.NeuralG2P(beam=beam).batch(WORDS)
    assert got == ref
    assert all(got)


def test_neural_g2p_reads_the_jax_packages_weights():
    assert neural_g2p.DEFAULT_WEIGHTS == os.path.abspath(
        jax_neural_g2p.DEFAULT_WEIGHTS)
    assert neural_g2p.NeuralG2P(beam=1).batch(["", "123"]) == [[], []]


def test_ids_are_the_same_vocabulary():
    assert neural_g2p.PH_TO_ID == jax_neural_g2p.PH_TO_ID
    assert neural_g2p.CHAR_TO_ID == jax_neural_g2p.CHAR_TO_ID
    assert np.array_equal(neural_g2p.encode_word("fox"),
                          jax_neural_g2p.encode_word("fox"))


# ---- Mandarin: tone-numbered pinyin ----------------------------------------

PINYIN = ["ni3 hao3 shi4 jie4", "zhuang1 yuan2 lv4 er2 huar1",
          "xiong2 qu4 wen4 ri4 si1 zi3 qqq9 a5", "lve4 nve4 yo1 r5"]


def test_split_pinyin_matches_jax_over_every_syllable():
    from fastspeech2_tpu.text import pinyin_g2p as jax_pinyin_g2p
    from fastspeech2_tpu_torch.text import pinyin_g2p

    bodies = jax_pinyin_g2p._enumerate_syllables()
    assert pinyin_g2p._enumerate_syllables() == bodies
    assert len(bodies) > 400
    for body in bodies:
        for tone in "12345":
            for syllable in (body + tone, body + "r" + tone):
                assert (pinyin_g2p.split_pinyin(syllable)
                        == jax_pinyin_g2p.split_pinyin(syllable)), syllable
    assert pinyin_g2p.generate_lexicon() == jax_pinyin_g2p.generate_lexicon()


@pytest.mark.parametrize("text", PINYIN)
def test_mandarin_phone_ids_match_jax(text, lexicon):
    """Lexicon hits stay English words, so every syllable is decomposed;
    an invalid token becomes sp in both."""
    from fastspeech2_tpu.text.g2p import (
        mandarin_to_phones as jax_mandarin_to_phones,
    )
    from fastspeech2_tpu_torch.text.g2p import mandarin_to_phones

    for lex in (lexicon, {}, {"ni3": ["n", "i3"], "hao3": ["h", "ao3"]}):
        phones = mandarin_to_phones(text, lex)
        assert phones == jax_mandarin_to_phones(text, lex)
        ids = text_to_sequence(phones, [])
        assert ids == jax_text_to_sequence(phones, [])
        assert len(ids) >= len(text.split())


def test_hanzi_without_pypinyin_raises_as_in_jax(monkeypatch):
    from fastspeech2_tpu.text.g2p import (
        mandarin_to_phones as jax_mandarin_to_phones,
    )
    from fastspeech2_tpu_torch.text.g2p import mandarin_to_phones

    monkeypatch.setitem(sys.modules, "pypinyin", None)
    messages = []
    for fn in (jax_mandarin_to_phones, mandarin_to_phones):
        with pytest.raises(RuntimeError, match="pypinyin is unavailable") as e:
            fn("你好世界", {})
        messages.append(str(e.value))
    assert messages[0] == messages[1]
