"""Acoustic validation of forced alignments on real speech (port of
``fastspeech2_tpu/evaluation/align_validation.py``).

The flat-start aligner (``align/``) is unit-tested on synthetic
durations; this module validates its output on REAL recordings without an
external aligner (MFA is not installable offline): if phone boundaries are
placed correctly, the audio inside each segment must carry that phone
class's acoustic signature.  Measured per aligned TextGrid against the
trimmed waveform:

  - vowel voicing      fraction of frames inside vowel segments that the
                       port's DIO (audio/dio.py — the same estimator
                       the reference's pyworld call provides) marks voiced.
                       Correct vowel boundaries => high.
  - unvoiced leakage   voiced fraction inside unvoiced obstruents
                       (P T K F TH S SH CH HH).  Misplaced boundaries pull
                       neighbouring voiced material in => high values.
  - silence energy     mean frame RMS inside sp/spn/sil relative to speech
                       segments.  Correct silence spans => near zero.
  - boundary contrast  RMS ratio across each silence<->speech boundary
                       (2 frames each side).  Sharp if boundaries are
                       frame-accurate.

Reference behavioral match: the reference consumes MFA TextGrids at
preprocessor/preprocessor.py:163-167 and trusts them; this is the
in-framework quality gate for our replacement of that external stage.

DIO runs on the card unless ``--device cpu`` is given (one utterance at a
time, each zero-padded to the corpus's common length, as the JAX package
pads for one compiled shape, so the F0 tracks are the same).

    python -m fastspeech2_tpu_torch.evaluation.align_validation \
        config/LJSpeech10/preprocess.yaml [--device cuda|cpu]
"""

import argparse
import json
import os

import numpy as np
import torch

from fastspeech2_tpu_torch.preprocessing.textgrid import read_textgrid
from fastspeech2_tpu_torch.text.cmudict import valid_symbols

SILENCES = {"sp", "spn", "sil", ""}
UNVOICED = {"P", "T", "K", "F", "TH", "S", "SH", "CH", "HH"}
VOWELS = {s for s in valid_symbols if s[-1].isdigit()}


def _load_wav(path):
    from scipy.io import wavfile

    sr, y = wavfile.read(path)
    y = y.astype(np.float32)
    if y.dtype != np.float32 or np.abs(y).max() > 2.0:
        y = y / 32768.0
    return sr, y


def _frame_rms(y, hop, win=1024):
    n = 1 + len(y) // hop
    pad = np.pad(y, (win // 2, win))
    return np.asarray([
        np.sqrt(np.mean(np.square(pad[i * hop: i * hop + win])))
        for i in range(n)])


def _uniform_tier(tier):
    """Null hypothesis: same phone sequence spread uniformly over the
    same span.  An aligner carrying real boundary information must beat
    this on every metric."""
    from fastspeech2_tpu_torch.preprocessing.textgrid import (
        Interval,
        IntervalTier,
    )

    t0 = tier.intervals[0].start_time
    t1 = tier.intervals[-1].end_time
    k = len(tier.intervals)
    step = (t1 - t0) / max(k, 1)
    return IntervalTier(name="phones", intervals=[
        Interval(t0 + i * step, t0 + (i + 1) * step, iv.text)
        for i, iv in enumerate(tier.intervals)])


def validate_utterance(wav_path, textgrid_path, hop_length=256,
                       pad_to=None, null="aligned", device="cuda"):
    """-> dict of per-utterance metrics (see module docstring).

    pad_to: sample length to zero-pad the wav to before DIO (the JAX
    package's one static shape per corpus).
    null="uniform" scores the uniform-boundary null instead."""
    from fastspeech2_tpu_torch.audio.dio import dio_f0

    sr, y = _load_wav(wav_path)
    tg = read_textgrid(textgrid_path)
    tier = tg.get_tier_by_name("phones")
    if null == "uniform":
        tier = _uniform_tier(tier)

    n_real = 1 + len(y) // hop_length
    y_in = (np.pad(y, (0, max(pad_to - len(y), 0)))
            if pad_to and pad_to > len(y) else y)
    with torch.inference_mode():
        f0 = dio_f0(torch.as_tensor(np.asarray(y_in, np.float32),
                                    device=device),
                    sr, hop_length).cpu().numpy()[:n_real]
    voiced = f0 > 0
    rms = _frame_rms(y, hop_length)
    n = min(len(voiced), len(rms))

    def seg_frames(iv):
        a = int(round(iv.start_time * sr / hop_length))
        b = int(round(iv.end_time * sr / hop_length))
        return max(a, 0), min(b, n)

    vowel_voiced, vowel_n = 0, 0
    unv_voiced, unv_n = 0, 0
    sil_rms, speech_rms = [], []
    for iv in tier.intervals:
        a, b = seg_frames(iv)
        if b <= a:
            continue
        base = iv.text.rstrip("0123456789")
        if iv.text in SILENCES:
            sil_rms.extend(rms[a:b])
        else:
            speech_rms.extend(rms[a:b])
        if iv.text in VOWELS:
            vowel_voiced += int(voiced[a:b].sum())
            vowel_n += b - a
        elif base in UNVOICED:
            unv_voiced += int(voiced[a:b].sum())
            unv_n += b - a

    # boundary contrast: silence <-> speech transitions
    contrasts = []
    ivs = tier.intervals
    for prev, cur in zip(ivs, ivs[1:]):
        sil_prev = prev.text in SILENCES
        sil_cur = cur.text in SILENCES
        if sil_prev == sil_cur:
            continue
        t = int(round(cur.start_time * sr / hop_length))
        if t - 2 < 0 or t + 2 > n:
            continue
        left = float(np.mean(rms[t - 2: t])) + 1e-8
        right = float(np.mean(rms[t: t + 2])) + 1e-8
        quiet, loud = (left, right) if sil_prev else (right, left)
        contrasts.append(loud / quiet)

    return {
        "vowel_voiced_frac": vowel_voiced / max(vowel_n, 1),
        "unvoiced_voiced_frac": unv_voiced / max(unv_n, 1),
        "sil_to_speech_rms": (float(np.mean(sil_rms))
                              / max(float(np.mean(speech_rms)), 1e-8)
                              if sil_rms else 0.0),
        "boundary_contrast_median": (float(np.median(contrasts))
                                     if contrasts else float("nan")),
        "n_boundaries": len(contrasts),
        "n_vowel_frames": vowel_n,
        "n_unvoiced_frames": unv_n,
    }


def validate_corpus(preprocess_config, null="aligned", device="cuda"):
    raw = preprocess_config["path"]["raw_path"]
    tg_root = os.path.join(
        preprocess_config["path"]["preprocessed_path"], "TextGrid")
    hop = preprocess_config["preprocessing"]["stft"]["hop_length"]
    pairs = []
    for speaker in sorted(os.listdir(tg_root)):
        for f in sorted(os.listdir(os.path.join(tg_root, speaker))):
            if not f.endswith(".TextGrid"):
                continue
            base = f[: -len(".TextGrid")]
            wav = os.path.join(raw, speaker, base + ".wav")
            if os.path.exists(wav):
                pairs.append((base, wav, os.path.join(tg_root, speaker, f)))
    # one DIO length for the whole corpus
    pad_to = 0
    for _, wav, _ in pairs:
        sr, y = _load_wav(wav)
        pad_to = max(pad_to, len(y))
    pad_to = ((pad_to + 32767) // 32768) * 32768
    rows = {}
    for base, wav, tg in pairs:
        rows[base] = validate_utterance(wav, tg, hop, pad_to=pad_to,
                                        null=null, device=device)
    return rows


def main(argv=None):
    import yaml

    from fastspeech2_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("preprocess_config")
    p.add_argument("--null", choices=["aligned", "uniform"],
                   default="aligned",
                   help="'uniform' scores the uniform-boundary null "
                        "hypothesis for comparison")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    with open(args.preprocess_config) as f:
        pre = yaml.safe_load(f)
    rows = validate_corpus(pre, null=args.null, device=device)
    for base, r in rows.items():
        print(f"{base}: vowel_voiced={r['vowel_voiced_frac']:.3f} "
              f"unvoiced_leak={r['unvoiced_voiced_frac']:.3f} "
              f"sil/speech_rms={r['sil_to_speech_rms']:.3f} "
              f"boundary_contrast={r['boundary_contrast_median']:.1f} "
              f"(n={r['n_boundaries']})")
    agg = {
        k: float(np.mean([r[k] for r in rows.values()]))
        for k in ("vowel_voiced_frac", "unvoiced_voiced_frac",
                  "sil_to_speech_rms")
    }
    agg["boundary_contrast_median"] = float(np.median(
        [r["boundary_contrast_median"] for r in rows.values()
         if np.isfinite(r["boundary_contrast_median"])]))
    print("aggregate:", json.dumps({k: round(v, 4)
                                    for k, v in agg.items()}))
    return rows, agg


if __name__ == "__main__":
    main()
