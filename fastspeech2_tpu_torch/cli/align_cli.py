"""In-framework forced alignment CLI (port of
``fastspeech2_tpu/cli/align_cli.py``).

    python -m fastspeech2_tpu_torch.cli.align_cli config/<ds>/preprocess.yaml \\
        [--phones_file F] [--device cuda|cpu]

walks the prepare_align output (raw_path/<speaker>/{*.wav,*.lab}),
aligns each utterance's phone sequence to its audio with the flat-start
Viterbi aligner (align/aligner.py) and writes MFA-compatible TextGrids to
<preprocessed_path>/TextGrid/<speaker>/ — the exact inputs the
Preprocessor consumes.  This replaces the reference's manual external-MFA
step (reference README "Alignment"; preprocessor/preprocessor.py:163-167
only reads TextGrids): the full corpus->features pipeline now runs with
no tools outside this framework.  The features, the emissions, the
Viterbi pass and the EM statistics run on the card unless ``--device cpu``
is given.

Phone sequences come from the configured lexicon + G2P (same front-end
as synthesis), or verbatim from an existing metadata file via
`--phones_file` (lines `basename|speaker|{PH ON ES}|raw text`) when
reference-preprocessed transcripts should be reused.
"""

import argparse
import os
import re

import numpy as np
import yaml

from fastspeech2_tpu_torch.align.aligner import (
    SILENCES,
    ForcedAligner,
    Utterance,
)
from fastspeech2_tpu_torch.align.features import alignment_features
from fastspeech2_tpu_torch.align.textgrid_writer import write_textgrid
from fastspeech2_tpu_torch.audio.stft import MelSpectrogram
from fastspeech2_tpu_torch.audio.wav import load_wav
from fastspeech2_tpu_torch.utils.device import resolve_device

_BRACES = re.compile(r"\{([^}]+)\}")


def phones_from_metadata(path):
    """metadata lines -> {basename: [phone, ...]}."""
    table = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) < 3:
                continue
            m = _BRACES.search(parts[2])
            if m:
                table[parts[0]] = m.group(1).split()
    return table


def phones_from_text(text, preprocess_config, lexicon=None,
                     oov_to_phones=None):
    """.lab text -> phone tokens via the synthesis G2P front-end (the
    lexicon, then the neural G2P and the rule engine for OOV words)."""
    from fastspeech2_tpu_torch.text.g2p import (
        english_to_phones,
        make_oov_to_phones,
        mandarin_to_phones,
        read_lexicon,
    )

    if lexicon is None:
        lexicon = read_lexicon(preprocess_config["path"]["lexicon_path"])
    language = preprocess_config["preprocessing"]["text"]["language"]
    if language == "zh":
        phones = mandarin_to_phones(text, lexicon)
    else:
        phones = english_to_phones(text, lexicon,
                                   oov_to_phones or make_oov_to_phones())
    return _BRACES.search(phones).group(1).split()


def _with_edge_silence(tokens):
    """Wrap with skippable 'sil' so untrimmed recordings align cleanly;
    interior pause tokens are likewise optional (they may take 0 frames)."""
    toks = list(tokens)
    optional = [t in SILENCES for t in toks]
    if not toks or toks[0] not in SILENCES:
        toks.insert(0, "sil")
        optional.insert(0, True)
    if toks[-1] not in SILENCES:
        toks.append("sil")
        optional.append(True)
    return toks, optional


def align_corpus(preprocess_config, phones_file=None, n_states=3,
                 n_iters=10, em_utts=128, batch_size=64, verbose=True,
                 device="cuda"):
    """Run the aligner over raw_path on ``device``; returns the written
    TextGrid paths."""
    pp = preprocess_config["preprocessing"]
    in_dir = preprocess_config["path"]["raw_path"]
    out_root = os.path.join(
        preprocess_config["path"]["preprocessed_path"], "TextGrid")
    sr = pp["audio"]["sampling_rate"]
    hop = pp["stft"]["hop_length"]
    mel_fn = MelSpectrogram(
        filter_length=pp["stft"]["filter_length"], hop_length=hop,
        win_length=pp["stft"]["win_length"],
        n_mel_channels=pp["mel"]["n_mel_channels"], sampling_rate=sr,
        mel_fmin=pp["mel"]["mel_fmin"],
        mel_fmax=pp["mel"]["mel_fmax"] or sr / 2)

    known = phones_from_metadata(phones_file) if phones_file else {}
    lexicon = oov_to_phones = None

    # gather utterances (host side)
    entries = []               # (speaker, basename, tokens, optional)
    wavs, lengths = [], []
    for speaker in sorted(os.listdir(in_dir)):
        spk_dir = os.path.join(in_dir, speaker)
        if not os.path.isdir(spk_dir):
            continue
        for wav_name in sorted(os.listdir(spk_dir)):
            if not wav_name.endswith(".wav"):
                continue
            base = wav_name[:-4]
            lab = os.path.join(spk_dir, f"{base}.lab")
            if base in known:
                tokens = known[base]
            elif os.path.exists(lab):
                if lexicon is None:
                    from fastspeech2_tpu_torch.text.g2p import (
                        make_oov_to_phones,
                        read_lexicon,
                    )

                    lexicon = read_lexicon(
                        preprocess_config["path"]["lexicon_path"])
                    oov_to_phones = make_oov_to_phones(device)
                with open(lab, encoding="utf-8") as f:
                    tokens = phones_from_text(
                        f.readline().strip(), preprocess_config, lexicon,
                        oov_to_phones)
            else:
                continue
            if not tokens:
                continue
            tokens, optional = _with_edge_silence(tokens)
            wav, _ = load_wav(os.path.join(spk_dir, wav_name),
                              target_sr=sr)
            entries.append((speaker, base, tokens, optional))
            wavs.append(wav)
            lengths.append(len(wav))
    if not entries:
        raise SystemExit(f"no alignable utterances under {in_dir}")

    # features in padded batches (one static shape per batch)
    utts = []
    order = np.argsort(lengths)[::-1]       # long first: tighter padding
    for s in range(0, len(order), batch_size):
        idx = order[s: s + batch_size]
        pad_to = max(lengths[i] for i in idx)
        batch = np.zeros((len(idx), pad_to), np.float32)
        for row, i in enumerate(idx):
            batch[row, : lengths[i]] = wavs[i]
        feats, n_frames = alignment_features(
            batch, [lengths[i] for i in idx], mel_fn, device=device)
        for row, i in enumerate(idx):
            speaker, base, tokens, optional = entries[i]
            utts.append((i, Utterance(
                feats=feats[row], n_frames=int(n_frames[row]),
                tokens=tokens, optional=optional)))
    utts.sort(key=lambda p: p[0])
    utts = [u for _, u in utts]

    inventory = sorted({t for u in utts for t in u.tokens})
    aligner = ForcedAligner(n_states=n_states, n_iters=n_iters,
                            device=device)
    fit_batch = utts[:em_utts]
    results = list(aligner.fit(fit_batch, phone_inventory=inventory,
                               verbose=verbose))
    for s in range(len(fit_batch), len(utts), batch_size):
        results += aligner.transform(utts[s: s + batch_size])

    written = []
    for (speaker, base, tokens, _), res in zip(entries, results):
        path = os.path.join(out_root, speaker, f"{base}.TextGrid")
        write_textgrid(path, tokens, res.durations.tolist(), hop, sr)
        written.append(path)
    if verbose:
        print(f"Aligned {len(written)} utterances -> {out_root}")
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config", help="path to preprocess.yaml")
    parser.add_argument("--phones_file", default=None,
                        help="metadata file supplying known phone "
                             "sequences (basename|spk|{phones}|text)")
    parser.add_argument("--n_states", type=int, default=3,
                        help="HMM states per phone (min phone duration "
                             "is 1 frame regardless; extra states are "
                             "skippable)")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--em_utts", type=int, default=128,
                        help="utterances used to fit the Gaussians; the "
                             "rest are aligned with the fitted model")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    with open(args.config) as f:
        config = yaml.safe_load(f)
    return align_corpus(config, phones_file=args.phones_file,
                        n_states=args.n_states, n_iters=args.iters,
                        em_utts=args.em_utts, batch_size=args.batch_size,
                        device=device)


if __name__ == "__main__":
    main()
