"""Synthetic preprocessed-corpus generator (a copy of
``fastspeech2_tpu/data/synthetic.py``, numpy only).

Writes a small corpus in the exact on-disk layout the reference's
preprocessing emits (SURVEY.md data-flow; preprocessor/preprocessor.py:
230-244, 115-151): per-utterance mel/pitch/energy/duration .npy files,
pipe-delimited metadata, stats.json, speakers.json.  Used by tests and the
benchmark harness so the full training/synthesis stack can run without the
LJSpeech corpus or MFA alignments.
"""

import json
import os

import numpy as np

from fastspeech2_tpu_torch.text.symbols import symbols

_ARPABET_START = 64  # first "@"-prefixed ARPAbet symbol id
_N_ARPABET = 84


def generate_corpus(
    out_dir,
    n_utterances=32,
    n_speakers=1,
    min_phones=8,
    max_phones=24,
    n_mels=80,
    seed=0,
    val_size=8,
):
    rng = np.random.RandomState(seed)
    for sub in ["mel", "pitch", "energy", "duration"]:
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    speakers = {f"spk{i}": i for i in range(n_speakers)}
    arp = [s[1:] for s in symbols[_ARPABET_START:_ARPABET_START + _N_ARPABET]]

    lines = []
    pitch_all, energy_all = [], []
    records = []
    for u in range(n_utterances):
        speaker = f"spk{u % n_speakers}"
        base = f"utt{u:04d}"
        n_ph = rng.randint(min_phones, max_phones + 1)
        phones = [arp[rng.randint(len(arp))] for _ in range(n_ph)]
        text = "{" + " ".join(phones) + "}"
        raw = " ".join(phones).lower()
        duration = rng.randint(2, 9, size=n_ph).astype(np.int64)
        T = int(duration.sum())
        mel = rng.randn(T, n_mels).astype(np.float32) * 1.2 - 5.0
        pitch = (rng.randn(n_ph) * 40 + 200).astype(np.float64)
        energy = np.abs(rng.randn(n_ph) * 20 + 35).astype(np.float32)
        records.append((speaker, base, duration, mel, pitch, energy))
        pitch_all.append(pitch)
        energy_all.append(energy)
        lines.append("|".join([base, speaker, text, raw]))

    pitch_cat = np.concatenate(pitch_all)
    energy_cat = np.concatenate(energy_all)
    p_mean, p_std = pitch_cat.mean(), pitch_cat.std() + 1e-9
    e_mean, e_std = energy_cat.mean(), energy_cat.std() + 1e-9

    p_min = p_max = e_min = e_max = None
    for speaker, base, duration, mel, pitch, energy in records:
        pitch_n = (pitch - p_mean) / p_std
        energy_n = (energy - e_mean) / e_std
        np.save(os.path.join(out_dir, "duration",
                             f"{speaker}-duration-{base}.npy"), duration)
        np.save(os.path.join(out_dir, "pitch",
                             f"{speaker}-pitch-{base}.npy"), pitch_n)
        np.save(os.path.join(out_dir, "energy",
                             f"{speaker}-energy-{base}.npy"), energy_n)
        np.save(os.path.join(out_dir, "mel", f"{speaker}-mel-{base}.npy"),
                mel)
        p_min = pitch_n.min() if p_min is None else min(p_min, pitch_n.min())
        p_max = pitch_n.max() if p_max is None else max(p_max, pitch_n.max())
        e_min = energy_n.min() if e_min is None else min(e_min, energy_n.min())
        e_max = energy_n.max() if e_max is None else max(e_max, energy_n.max())

    with open(os.path.join(out_dir, "speakers.json"), "w") as f:
        json.dump(speakers, f)
    with open(os.path.join(out_dir, "stats.json"), "w") as f:
        json.dump({
            "pitch": [float(p_min), float(p_max), float(p_mean), float(p_std)],
            "energy": [float(e_min), float(e_max), float(e_mean),
                       float(e_std)],
        }, f)
    with open(os.path.join(out_dir, "train.txt"), "w") as f:
        f.write("\n".join(lines[val_size:]) + "\n")
    with open(os.path.join(out_dir, "val.txt"), "w") as f:
        f.write("\n".join(lines[:val_size]) + "\n")
    return out_dir


def synthetic_preprocess_config(out_dir, n_mels=80):
    """A reference-schema preprocess config pointing at the corpus."""
    return {
        "dataset": "synthetic",
        "path": {
            "corpus_path": out_dir,
            "raw_path": out_dir,
            "preprocessed_path": out_dir,
            "lexicon_path": os.path.join(out_dir, "lexicon.txt"),
        },
        "preprocessing": {
            "val_size": 8,
            "text": {"text_cleaners": ["english_cleaners"],
                     "language": "en"},
            "audio": {"sampling_rate": 22050, "max_wav_value": 32768.0},
            "stft": {"filter_length": 1024, "hop_length": 256,
                     "win_length": 1024},
            "mel": {"n_mel_channels": n_mels, "mel_fmin": 0,
                    "mel_fmax": 8000},
            "pitch": {"feature": "phoneme_level", "normalization": True},
            "energy": {"feature": "phoneme_level", "normalization": True},
        },
    }
