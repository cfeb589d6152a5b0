"""Mine a word -> ARPAbet lexicon from preprocessed metadata (port of
``fastspeech2_tpu/text/mine_lexicon.py``, on the port's
``text/letter_to_sound.py``).

The reference ships `lexicon/librispeech-lexicon.txt` for synthesis-time
word lookup (synthesize.py:20-29) but that artifact is stripped from this
mirror. What IS shipped is quality-bearing: 13,100 LJSpeech utterances of
aligned `{phone string}|raw text` metadata
(preprocessed_data/LJSpeech/{train,val}.txt), produced upstream with the
MFA librispeech lexicon + g2p_en. This module recovers a per-word lexicon
from those pairs:

1. For each utterance, tokenize the raw text exactly as
   `text/g2p.py::english_to_phones` does, and predict each word's phones
   with the rule-based letter-to-sound engine.
2. Globally align the concatenated prediction against the utterance's
   true phone sequence (Needleman-Wunsch over phones; substitutions are
   cheap when the stress-stripped base phones match). The predicted side
   carries word indices, so the alignment path projects word boundaries
   onto the true phones.
3. Majority-vote each word's pronunciation across its occurrences.

The tracked `lexicon/ljspeech-mined.txt` was generated this way by the
JAX package from the full corpus's metadata, which the repository does
not hold.  This port's defaults read the tracked 10-clip metadata
(`preprocessed_data/LJSpeech10/{train,val}.txt`) and write under
`output/`, never over the tracked lexicon:

    python -m fastspeech2_tpu_torch.text.mine_lexicon \
        [--metadata F ...] [--out output/lexicon/ljspeech-mined.txt] \
        [--eval F]
"""

import argparse
import collections
import os
import re

import numpy as np

DEFAULT_OUT = os.path.join("output", "lexicon", "ljspeech-mined.txt")
_WORD_SPLIT = re.compile(r"([,;.\-\?\!\s+])")
_SILENCES = {"sp", "spn", "sil"}

# alignment costs
_SUB_EXACT = 0.0
_SUB_BASE = 0.25      # same phone, different stress digit
_SUB_OTHER = 1.0
_GAP = 0.7


def _base(phone):
    return phone.rstrip("0123456789")


def tokenize_words(text):
    """The english_to_phones word split, keeping only lexical tokens.

    Surrounding punctuation (quotes, parens) is stripped like
    g2p.py::_token_to_phones does for its lexicon lookup; internal
    apostrophes are kept ("don't").
    """
    from string import punctuation

    words = []
    for w in _WORD_SPLIT.split(text.rstrip(punctuation)):
        w = w.strip().strip("\"'()[]`“”‘’").strip()
        if re.search(r"[A-Za-z0-9]", w):
            words.append(w.lower())
    return words


def _predict(word):
    from fastspeech2_tpu_torch.text.letter_to_sound import letter_to_sound

    return letter_to_sound(word)


def align_words_to_phones(words, true_phones, predict=_predict):
    """Project word boundaries onto `true_phones` via DP alignment.

    Returns a list of (word, phones) per occurrence, or None when the
    utterance cannot be aligned (no words / no phones).
    """
    true_phones = [p for p in true_phones if p not in _SILENCES]
    if not words or not true_phones:
        return None
    pred, word_of = [], []
    for wi, w in enumerate(words):
        phones = predict(w)
        if not phones:       # un-predictable token: zero-width anchor
            phones = ["AH0"]
        pred.extend(phones)
        word_of.extend([wi] * len(phones))

    n, m = len(pred), len(true_phones)
    # vectorized Needleman-Wunsch, rows over pred
    cost = np.empty((n + 1, m + 1), np.float32)
    move = np.zeros((n + 1, m + 1), np.int8)  # 0=diag 1=up(del pred) 2=left
    cost[0] = np.arange(m + 1) * _GAP
    move[0, 1:] = 2
    tb = np.asarray(true_phones)
    tb_base = np.asarray([_base(p) for p in true_phones])
    js = np.arange(1, m + 1, dtype=np.float32)
    for i in range(1, n + 1):
        cost[i, 0] = i * _GAP
        move[i, 0] = 1
        p = pred[i - 1]
        sub = np.where(tb == p, _SUB_EXACT,
                       np.where(tb_base == _base(p), _SUB_BASE, _SUB_OTHER))
        diag = cost[i - 1, :-1] + sub
        up = cost[i - 1, 1:] + _GAP
        dm = diag <= up
        best_du = np.where(dm, diag, up)
        mv_du = np.where(dm, 0, 1).astype(np.int8)
        # left-gap chains close over this row:
        #   row[j] = min_{k<=j}(best_du[k-1] + GAP*(j-k))
        #          = GAP*j + running_min(best_du[k-1] - GAP*k)
        # (k=0 term is the all-gap prefix row[0])
        shifted = np.concatenate(
            ([cost[i, 0]], best_du - _GAP * js))
        run_min = np.minimum.accumulate(shifted)[1:]
        row_tail = _GAP * js + run_min
        cost[i, 1:] = row_tail
        from_du = row_tail >= best_du - 1e-6
        move[i, 1:] = np.where(from_du, mv_du, np.int8(2))

    # backtrack: map each true phone to a pred index
    owner = [None] * m
    i, j = n, m
    while i > 0 or j > 0:
        mv = move[i, j]
        if i > 0 and j > 0 and mv == 0:
            owner[j - 1] = i - 1
            i, j = i - 1, j - 1
        elif i > 0 and (mv == 1 or j == 0):
            i -= 1
        else:
            # inserted true phone: inherit the left neighbour's owner
            owner[j - 1] = max(i - 1, 0)
            j -= 1

    spans = collections.defaultdict(list)
    for j, oi in enumerate(owner):
        spans[word_of[oi]].append(true_phones[j])
    return [(w, spans.get(wi, [])) for wi, w in enumerate(words)]


def parse_metadata_line(line):
    parts = line.rstrip("\n").split("|")
    if len(parts) < 4:
        return None
    phones = parts[2].strip()
    if not (phones.startswith("{") and phones.endswith("}")):
        return None
    return parts[3], phones[1:-1].split()


def mine_lexicon(metadata_paths, predict=_predict, log=lambda *_: None):
    """-> (word -> phones dict, stats dict)."""
    votes = collections.defaultdict(collections.Counter)
    n_lines = n_aligned = 0
    for path in metadata_paths:
        with open(path) as f:
            for line in f:
                parsed = parse_metadata_line(line)
                if parsed is None:
                    continue
                raw_text, true_phones = parsed
                n_lines += 1
                occ = align_words_to_phones(
                    tokenize_words(raw_text), true_phones, predict)
                if occ is None:
                    continue
                n_aligned += 1
                for word, phones in occ:
                    if phones and len(phones) <= 4 * len(word) + 4:
                        votes[word][tuple(phones)] += 1
                if n_aligned % 2000 == 0:
                    log(f"aligned {n_aligned} utterances, "
                        f"{len(votes)} words")
    lexicon, disputed = {}, 0
    for word, counter in votes.items():
        (phones, top), total = counter.most_common(1)[0], sum(
            counter.values())
        if top / total < 0.5:
            disputed += 1
        lexicon[word] = list(phones)
    stats = {"lines": n_lines, "aligned": n_aligned,
             "words": len(lexicon), "disputed": disputed}
    return lexicon, stats


def write_lexicon(lexicon, out_path):
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        for word in sorted(lexicon):
            f.write(word + "\t" + " ".join(lexicon[word]) + "\n")


def roundtrip_accuracy(metadata_path, lexicon, predict=_predict,
                       limit=None):
    """Token accuracy of lexicon-based prediction vs the true metadata
    phones (silences excluded on both sides)."""
    total = correct = 0
    with open(metadata_path) as f:
        for k, line in enumerate(f):
            if limit is not None and k >= limit:
                break
            parsed = parse_metadata_line(line)
            if parsed is None:
                continue
            raw_text, true_phones = parsed
            true_phones = [p for p in true_phones if p not in _SILENCES]
            pred = []
            for w in tokenize_words(raw_text):
                pred.extend(lexicon.get(w) or predict(w))
            # phone-level edit alignment score
            n, m = len(pred), len(true_phones)
            if m == 0:
                continue
            d = np.zeros((n + 1, m + 1), np.int32)
            d[0] = np.arange(m + 1)
            for i in range(1, n + 1):
                d[i, 0] = i
                sub = d[i - 1, :-1] + (
                    np.asarray(true_phones) != pred[i - 1])
                up = d[i - 1, 1:] + 1
                row = d[i]
                prev = row[0]
                best = np.minimum(sub, up)
                for j in range(1, m + 1):
                    prev = min(best[j - 1], prev + 1)
                    row[j] = prev
            total += m
            correct += m - int(d[n, m])
    return correct / max(total, 1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--metadata", nargs="+", default=[
        "preprocessed_data/LJSpeech10/train.txt",
        "preprocessed_data/LJSpeech10/val.txt"])
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--eval", default=None,
                   help="metadata file for roundtrip accuracy")
    p.add_argument("--eval_limit", type=int, default=None)
    args = p.parse_args(argv)

    lexicon, stats = mine_lexicon(args.metadata, log=print)
    write_lexicon(lexicon, args.out)
    print(f"wrote {stats['words']} words to {args.out} "
          f"({stats['aligned']}/{stats['lines']} utterances aligned, "
          f"{stats['disputed']} disputed)")
    if args.eval:
        acc = roundtrip_accuracy(args.eval, lexicon,
                                 limit=args.eval_limit)
        print(f"roundtrip phone accuracy on {args.eval}: {acc:.4f}")


if __name__ == "__main__":
    main()
