"""Train the seq2seq OOV G2P on the mined lexicon (port of
``fastspeech2_tpu/text/train_g2p.py``):

    python -m fastspeech2_tpu_torch.text.train_g2p \\
        [--lexicon lexicon/ljspeech-mined.txt] \\
        [--out output/g2p/g2p_seq2seq.npz] [--device cuda|cpu]

Holds out ``--heldout`` words (the same deterministic split as the JAX
package: the same words), trains teacher-forced with label smoothing,
reports word accuracy and phone error rate on the held-out words for the
greedy and beam-4 decoders and for the rule engine (text/letter_to_sound.py)
they back up, then writes float16 weights in the JAX package's npz layout.
The default ``--out`` lies under ``output/``: the tracked weights the
frontend reads (``fastspeech2_tpu/text/data/g2p_seq2seq.npz``, the JAX
CLI's default) are never overwritten by default.

The optimizer is optax's ``adamw(cosine_decay_schedule(lr, total_steps),
weight_decay=1e-4)`` (``training/optim.AdamW``: decay on every parameter,
scaled by the schedule, whose count starts at 0); the loss is the mean
over non-PAD targets of the cross-entropy against labels smoothed by 0.05
over N_PHONES; each epoch's order is ``RandomState(seed).permutation``.
The JAX package runs one epoch per dispatch (``lax.scan``); this is a
plain loop of steps over the device-resident lexicon.  Runs on the card
unless ``--device cpu`` is given.
"""

import argparse
import os
import time

import numpy as np
import torch
from torch.nn import functional as F

from fastspeech2_tpu_torch.text.neural_g2p import (
    MAX_PRON,
    N_PHONES,
    PH_BOS,
    PH_PAD,
    G2PModel,
    NeuralG2P,
    encode_phones,
    encode_word,
    save_params,
)
from fastspeech2_tpu_torch.training.optim import AdamW

DEFAULT_OUT = os.path.join("output", "g2p", "g2p_seq2seq.npz")
LABEL_SMOOTHING = 0.05
WEIGHT_DECAY = 1e-4


def load_pairs(lexicon_path):
    pairs = []
    with open(lexicon_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            word, phones = parts[0], parts[1:]
            c = encode_word(word)
            if c is None or len(word) > 28 or len(phones) > MAX_PRON - 1:
                continue
            pairs.append((word, phones, c, encode_phones(phones)))
    return pairs


def split_pairs(pairs, heldout, seed=0):
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(pairs))
    held = [pairs[i] for i in order[:heldout]]
    train = [pairs[i] for i in order[heldout:]]
    return train, held


# English suffix phonology for data augmentation (conservative subset:
# only spellings formed by plain concatenation / silent-e handling, no
# consonant doubling).  Segment classes by final phone (stress stripped).
_VOICELESS = {"P", "T", "K", "F", "TH"}
_SIBILANT = {"S", "Z", "SH", "CH", "JH", "ZH"}


def augment_pairs(train_pairs, exclude_words):
    """Derive suffixed forms (plural/3rd-person -s/-es, -ing, -ed, -ly)
    from TRAIN-split bases with rule-derived pronunciations.  Surface
    forms already in the lexicon or in the held-out set are excluded, so
    augmentation can neither duplicate supervised entries nor leak
    held-out answers.  The stress pattern of the base carries over
    unchanged (these suffixes are stress-neutral in English)."""
    out = []
    for word, phones, _, _ in train_pairs:
        if not word.isalpha() or len(word) < 3 or not phones:
            continue
        last = phones[-1].rstrip("012")
        cands = []
        if last in _SIBILANT:
            cands.append((word + "es", phones + ["IH0", "Z"]))
        elif last in _VOICELESS:
            cands.append((word + "s", phones + ["S"]))
        elif not word.endswith("s"):
            cands.append((word + "s", phones + ["Z"]))
        ed = (["IH0", "D"] if last in {"T", "D"}
              else ["T"] if last in _VOICELESS else ["D"])
        if word[-1] == "e":
            # silent-e concatenation: bake -> baking / baked
            cands.append((word[:-1] + "ing", phones + ["IH0", "NG"]))
            cands.append((word + "d", phones + ed))
        elif word[-1] not in "aeiouy":
            # skip CVC endings (consonant doubling: stop -> stopped)
            cvc = (len(word) >= 3 and word[-2] in "aeiou"
                   and word[-3] not in "aeiou")
            if not cvc:
                cands.append((word + "ing", phones + ["IH0", "NG"]))
                cands.append((word + "ed", phones + ed))
        if word[-1] not in "aeiou" and last != "L" and not word.endswith(
                "ly"):
            cands.append((word + "ly", phones + ["L", "IY0"]))
        for w, ph in cands:
            if w in exclude_words or len(w) > 28 or len(ph) > MAX_PRON - 1:
                continue
            c = encode_word(w)
            if c is None:
                continue
            out.append((w, ph, c, encode_phones(ph)))
    return out


def phone_error_rate(ref, hyp):
    """Levenshtein distance over phone tokens / len(ref)."""
    m, n = len(ref), len(hyp)
    d = np.arange(n + 1, dtype=np.int32).copy()
    for i in range(1, m + 1):
        prev = d.copy()
        d[0] = i
        for j in range(1, n + 1):
            d[j] = min(prev[j] + 1, d[j - 1] + 1,
                       prev[j - 1] + (ref[i - 1] != hyp[j - 1]))
    return d[n] / max(m, 1)


def evaluate(decode_fn, held, label, log=print):
    refs = [phones for _, phones, _, _ in held]
    hyps = decode_fn([w for w, _, _, _ in held])
    pers = [phone_error_rate(r, h) for r, h in zip(refs, hyps)]
    acc = float(np.mean([r == h for r, h in zip(refs, hyps)]))
    per = float(np.mean(pers))
    # stress-blind scores: segmental correctness matters most for
    # intelligibility
    strip = lambda seq: [p.rstrip("012") for p in seq]  # noqa: E731
    acc_nostress = float(np.mean(
        [strip(r) == strip(h) for r, h in zip(refs, hyps)]))
    per_nostress = float(np.mean(
        [phone_error_rate(strip(r), strip(h))
         for r, h in zip(refs, hyps)]))
    log(f"[{label}] heldout n={len(held)}  word_acc={acc:.3f}  "
        f"PER={per:.3f}  (stress-blind acc={acc_nostress:.3f} "
        f"PER={per_nostress:.3f})")
    return {"word_acc": acc, "per": per, "word_acc_nostress": acc_nostress,
            "per_nostress": per_nostress}


def cosine_decay(lr, total_steps):
    """optax.cosine_decay_schedule(lr, total_steps) in float32: count ->
    lr * 0.5 * (1 + cos(pi * min(count, total) / total))."""
    f32 = np.float32

    def schedule(count):
        c = f32(min(count, total_steps))
        return float(f32(lr) * (f32(0.5) * (f32(1) + np.cos(
            f32(np.pi) * c / f32(total_steps)))))

    return schedule


def smoothed_loss(logits, targets):
    """Cross-entropy against one-hot targets smoothed by LABEL_SMOOTHING
    over N_PHONES (optax.smooth_labels), meaned over non-PAD targets."""
    labels = (F.one_hot(targets, N_PHONES).float() * (1.0 - LABEL_SMOOTHING)
              + LABEL_SMOOTHING / N_PHONES)
    ls = -(labels * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    mask = (targets != PH_PAD).float()
    return (ls * mask).sum() / mask.sum()


def teacher_inputs(targets):
    """[N, MAX_PRON] targets -> the decoder inputs: BOS, then the targets
    shifted right."""
    dec_in = np.zeros_like(targets)
    dec_in[:, 0] = PH_BOS
    dec_in[:, 1:] = targets[:, :-1]
    return dec_in


def run_epoch(model, opt, chars, dec_in, targets, order):
    """One epoch of steps: ``order`` [steps, batch] row indices into the
    device-resident chars / dec_in / targets -> the mean loss (a 0-d
    tensor)."""
    params = list(model.parameters())
    losses = []
    for idx in order:
        loss = smoothed_loss(model(chars[idx], dec_in[idx]), targets[idx])
        opt.step(torch.autograd.grad(loss, params))
        losses.append(loss.detach())
    return torch.stack(losses).mean()


def train(lexicon_path, out_path=DEFAULT_OUT, *, heldout=500, epochs=300,
          batch_size=512, lr=1e-3, seed=0, dropout=0.0, augment=False,
          avg_frac=0.0, train_size=0, device="cuda", log=print):
    """Train, write the weights, report on the held-out words -> a dict
    with each decoder's scores ("greedy", "beam4", "rules"; None without
    held-out words) and "epoch_seconds" (host clock per epoch, the device
    synchronised)."""
    device = torch.device(device)
    pairs = load_pairs(lexicon_path)
    train_pairs, held = split_pairs(pairs, heldout, seed)
    if train_size and train_size < len(train_pairs):
        # learning-curve ablation: subsample the train set with a split
        # INDEPENDENT of `seed` so every size sees the same held-out set
        sub = np.random.RandomState(12345).permutation(
            len(train_pairs))[:train_size]
        train_pairs = [train_pairs[i] for i in sub]
    log(f"lexicon: {len(pairs)} usable entries "
        f"({len(train_pairs)} train / {len(held)} held out)")
    if augment:
        exclude = ({w for w, _, _, _ in pairs}
                   | {w for w, _, _, _ in held})
        aug = augment_pairs(train_pairs, exclude)
        log(f"augmentation: +{len(aug)} rule-derived suffixed forms")
        train_pairs = train_pairs + aug

    targets_np = np.stack([t for _, _, _, t in train_pairs])
    chars = torch.as_tensor(np.stack([c for _, _, c, _ in train_pairs]),
                            device=device)
    dec_in = torch.as_tensor(teacher_inputs(targets_np), device=device)
    targets = torch.as_tensor(targets_np, device=device)
    N = len(train_pairs)
    steps_per_epoch = N // batch_size

    model = G2PModel(dropout=dropout, seed=seed).to(device).train()
    if dropout > 0:
        model.generator = torch.Generator(device=device).manual_seed(seed + 1)
    log(f"G2P params: {sum(p.numel() for p in model.parameters())}")
    opt = AdamW(model.parameters(),
                cosine_decay(lr, epochs * steps_per_epoch),
                weight_decay=WEIGHT_DECAY)

    rng = np.random.RandomState(seed)
    t0 = time.time()
    # Polyak averaging over the tail of training: running mean of
    # epoch-end params across the final avg_frac of epochs
    avg_start = epochs - int(epochs * avg_frac)
    avg, avg_n = None, 0
    for ep in range(1, epochs + 1):
        order = rng.permutation(N)[: steps_per_epoch * batch_size]
        order = torch.as_tensor(order.reshape(steps_per_epoch, batch_size),
                                device=device)
        mean_loss = run_epoch(model, opt, chars, dec_in, targets, order)
        if avg_frac > 0 and ep > avg_start:
            avg_n += 1
            with torch.no_grad():
                if avg is None:
                    avg = {k: v.detach().clone()
                           for k, v in model.tensors().items()}
                else:
                    w = 1.0 / avg_n
                    for k, v in model.tensors().items():
                        avg[k] += w * (v - avg[k])
        if ep % 25 == 0 or ep == epochs:
            log(f"epoch {ep}/{epochs}: loss={float(mean_loss):.4f} "
                f"({time.time() - t0:.1f}s)")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    epoch_seconds = (time.time() - t0) / max(epochs, 1)

    params = model.tensors()
    if avg is not None:
        params = avg
        log(f"Polyak-averaged the last {avg_n} epoch-end params")
    save_params(out_path, params)
    log(f"weights -> {out_path}")

    report = {"greedy": None, "beam4": None, "rules": None,
              "epoch_seconds": epoch_seconds}
    if not held:
        return report

    # ---- held-out evaluation: neural (greedy + beam) vs rule engine ----
    from fastspeech2_tpu_torch.text.letter_to_sound import letter_to_sound

    greedy = NeuralG2P(out_path, beam=1, device=device)
    report["greedy"] = evaluate(greedy.batch, held, "neural greedy", log)
    beam = NeuralG2P(out_path, beam=4, device=device)
    report["beam4"] = evaluate(beam.batch, held, "neural beam4", log)
    report["rules"] = evaluate(lambda ws: [letter_to_sound(w) for w in ws],
                               held, "rules", log)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lexicon", default="lexicon/ljspeech-mined.txt")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--heldout", type=int, default=500)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--augment", action="store_true",
                   help="add rule-derived suffixed forms to training")
    p.add_argument("--avg_frac", type=float, default=0.0,
                   help="Polyak-average epoch-end params over this final "
                        "fraction of epochs")
    p.add_argument("--train_size", type=int, default=0,
                   help="subsample the train set to N entries (0 = all): "
                        "learning-curve ablation, same held-out split")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    from fastspeech2_tpu_torch.utils.device import resolve_device

    return train(args.lexicon, args.out, heldout=args.heldout,
                 epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                 seed=args.seed, dropout=args.dropout, augment=args.augment,
                 avg_frac=args.avg_frac, train_size=args.train_size,
                 device=resolve_device(args.device))


if __name__ == "__main__":
    main()
