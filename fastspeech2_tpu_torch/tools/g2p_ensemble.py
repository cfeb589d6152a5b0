"""G2P ensemble experiment: seq2seq beam candidates x rule engine (port
of ``scripts/g2p_ensemble.py``).

Measures every no-new-data combination signal on the held-out split of
``text/train_g2p.py`` (split_pairs seed 0, 500 words):

  - neural beam-K top-1
  - rule engine alone (text/letter_to_sound.py)
  - oracle(neural top-1, rules): the ceiling ANY 2-way ensemble can hit
  - oracle over all K beam candidates (+rules): reranking ceiling
  - agreement rerank: pick the rule output when it appears among the
    K beam candidates, else neural top-1
  - confidence fallback: neural top-1 unless its length-normalized
    log-prob is below a threshold, then rules.  The threshold is tuned on
    the first half of the held-out words and reported on the second half
    ("test"), as the phone-LM rerank is (the JAX script picked it on the
    words it reported, ``scripts/g2p_ensemble.py:273``); the whole sweep
    is printed as the tuning surface.

The beams and their scores come from ``NeuralG2P.beam_candidates``.  On
the CPU by default (the model is tiny):

    python -m fastspeech2_tpu_torch.tools.g2p_ensemble [--device cuda]
"""

import argparse
import json

import numpy as np

from fastspeech2_tpu_torch.text.letter_to_sound import letter_to_sound
from fastspeech2_tpu_torch.text.neural_g2p import DEFAULT_WEIGHTS, NeuralG2P
from fastspeech2_tpu_torch.text.train_g2p import load_pairs, split_pairs

THRESHOLDS = np.arange(-2.0, -0.049, 0.05)


def acc(pred, refs):
    return float(np.mean([p == r for p, r in zip(pred, refs)]))


class PhoneLM:
    """Interpolated add-k n-gram LM over phone sequences.

    Trained on the TRAIN-split pronunciations only (no new data): a
    beam-rescoring prior that knows which phone sequences look like
    English pronunciations.  Orders interpolate 1..n with fixed weights
    (highest order dominates)."""

    def __init__(self, prons, order=3, k=0.1):
        from collections import defaultdict

        self.order = order
        self.k = k
        self.counts = [defaultdict(float) for _ in range(order)]
        self.ctx = [defaultdict(float) for _ in range(order)]
        self.vocab = set()
        for ph in prons:
            seq = ["<s>"] * (order - 1) + list(ph) + ["</s>"]
            self.vocab.update(seq)
            for i in range(order - 1, len(seq)):
                for n in range(1, order + 1):
                    c = tuple(seq[i - n + 1:i])
                    self.counts[n - 1][c + (seq[i],)] += 1.0
                    self.ctx[n - 1][c] += 1.0
        self.V = len(self.vocab)
        w = np.asarray([2.0 ** i for i in range(order)])
        self.weights = w / w.sum()

    def logp(self, phones):
        seq = ["<s>"] * (self.order - 1) + list(phones) + ["</s>"]
        total = 0.0
        for i in range(self.order - 1, len(seq)):
            p = 0.0
            for n in range(1, self.order + 1):
                c = tuple(seq[i - n + 1:i])
                num = self.counts[n - 1].get(c + (seq[i],), 0.0) + self.k
                den = self.ctx[n - 1].get(c, 0.0) + self.k * self.V
                p += self.weights[n - 1] * (num / den)
            total += np.log(p)
        return total


def rerank_experiment(g2p, train, held, beam, log=print):
    """Beam rescoring with a train-split phone LM + length prior.

    score(cand) = logp_neural + lam * logp_LM(cand) + beta * len(cand)

    The model memorizes its train split (dev accuracy there is 1.0, no
    tuning signal), so (lam, beta) are tuned on the FIRST HALF of the
    held-out sample and the second half is scored once at the chosen
    point — the honest generalization number is the "test" row."""
    dev, test = held[: len(held) // 2], held[len(held) // 2:]
    lm = PhoneLM([ph for _, ph, _, _ in train])

    def score_and_pick(words, refs, lam, beta, cands, scores):
        pred = []
        for cs, sc in zip(cands, scores):
            best, best_s = cs[0], -np.inf
            for c, s in zip(cs, sc):
                if not c:
                    continue
                total = s + lam * lm.logp(c) + beta * len(c)
                if total > best_s:
                    best, best_s = c, total
            pred.append(best)
        return acc(pred, refs)

    out = {}
    for name, subset in [("dev", dev), ("test", test)]:
        words = [w for w, _, _, _ in subset]
        refs = [ph for _, ph, _, _ in subset]
        cands, scores = g2p.beam_candidates(words)
        out[name] = (words, refs, cands, scores)

    dw, dr, dc, ds = out["dev"]
    base_dev = acc([c[0] for c in dc], dr)
    best = (0.0, 0.0)
    best_acc = base_dev
    for lam in [0.0, 0.1, 0.2, 0.3, 0.5, 0.8, 1.2, 2.0]:
        for beta in [-0.6, -0.3, 0.0, 0.3, 0.6]:
            a = score_and_pick(dw, dr, lam, beta, dc, ds)
            if a > best_acc:
                best_acc, best = a, (lam, beta)
    hw, hr, hc, hs = out["test"]
    test_base = acc([c[0] for c in hc], hr)
    test_rerank = score_and_pick(hw, hr, *best, hc, hs)
    log(f"rerank: dev(held/2) base {base_dev:.4f} -> {best_acc:.4f} at "
        f"(lam={best[0]}, beta={best[1]}); test(held/2) {test_base:.4f} "
        f"-> {test_rerank:.4f}")
    return {"dev_base": round(base_dev, 4),
            "dev_best": round(best_acc, 4),
            "lam": best[0], "beta": best[1],
            "test_base": round(test_base, 4),
            "test_rerank": round(test_rerank, 4)}


def confidence_fallback(conf, rules, neural, refs):
    """The confidence-fallback sweep on the first half of the words, the
    threshold that wins there, and its accuracy on the second half ->
    (sweep {threshold: dev accuracy}, threshold, test accuracy)."""
    half = len(refs) // 2

    def pick(th, lo, hi):
        return [ru if c < th else n for c, ru, n in
                zip(conf[lo:hi], rules[lo:hi], neural[lo:hi])]

    sweep = {round(float(th), 2): round(acc(pick(th, 0, half), refs[:half]),
                                        4) for th in THRESHOLDS}
    best = max(sweep, key=sweep.get)
    return sweep, best, acc(pick(best, half, len(refs)), refs[half:])


def run(lexicon, weights, heldout=500, seed=0, beam=4, device="cpu",
        log=print):
    pairs = load_pairs(lexicon)
    train, held = split_pairs(pairs, heldout, seed)
    words = [w for w, _, _, _ in held]
    refs = [ph for _, ph, _, _ in held]
    log(f"held-out: {len(held)} words (seed={seed})")

    g2p = NeuralG2P(weights, beam=beam, device=device)
    cands, scores = g2p.beam_candidates(words)
    neural = [c[0] for c in cands]
    rules = [letter_to_sound(w) for w in words]

    results = {
        "neural_top1": acc(neural, refs),
        "rules": acc(rules, refs),
        "oracle_neural_or_rules": float(np.mean(
            [n == r or ru == r
             for n, ru, r in zip(neural, rules, refs)])),
        f"oracle_beam{beam}": float(np.mean(
            [any(c == r for c in cs) for cs, r in zip(cands, refs)])),
        f"oracle_beam{beam}_or_rules": float(np.mean(
            [any(c == r for c in cs) or ru == r
             for cs, ru, r in zip(cands, rules, refs)])),
    }

    # agreement rerank: trust the rules when the neural model considered
    # the same pronunciation plausible (it's in the beam)
    agree = [ru if ru in cs else n
             for cs, ru, n in zip(cands, rules, neural)]
    results["agreement_rerank"] = acc(agree, refs)

    # confidence fallback: neural top-1 unless its per-token log-prob is
    # weak, then rules; threshold tuned on the first half, scored on the
    # second
    lens = np.asarray([max(len(c[0]), 1) for c in cands], np.float32)
    conf = scores[:, 0] / lens
    sweep, best_th, test_acc = confidence_fallback(conf, rules, neural,
                                                   refs)
    half = len(refs) // 2
    results["confidence_fallback_dev_best"] = sweep[best_th]
    results["confidence_fallback_threshold"] = best_th
    results["confidence_fallback_test"] = test_acc
    results["neural_top1_test"] = acc(neural[half:], refs[half:])

    # hybrid: agreement rerank first, then the tuned confidence fallback,
    # scored on the second half
    hybrid = [ru if (ru in cs or c < best_th) else n
              for cs, c, ru, n in zip(cands[half:], conf[half:],
                                      rules[half:], neural[half:])]
    results["agreement_plus_confidence_test"] = acc(hybrid, refs[half:])

    # beam rescoring with a train-split phone LM (the beam oracle is the
    # real headroom; the rules are not — see the oracle_* rows)
    results["phone_lm_rerank"] = rerank_experiment(g2p, train, held, beam,
                                                   log)

    for k, v in results.items():
        log(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
    log(json.dumps({"results": {k: round(v, 4) if isinstance(v, float)
                                else v for k, v in results.items()},
                    "confidence_sweep_dev": sweep}))
    return results, sweep


def main(argv=None):
    from fastspeech2_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lexicon", default="lexicon/ljspeech-mined.txt")
    ap.add_argument("--weights", default=DEFAULT_WEIGHTS)
    ap.add_argument("--heldout", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--beam", type=int, default=4)
    ap.add_argument("--device", default="cpu",
                    help="cpu (default: the model is tiny) or cuda")
    args = ap.parse_args(argv)
    return run(args.lexicon, args.weights, args.heldout, args.seed,
               args.beam, resolve_device(args.device))


if __name__ == "__main__":
    main()
