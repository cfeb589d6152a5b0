"""Objective TTS quality metrics: MCD, F0 RMSE, voicing F1 (port of
``fastspeech2_tpu/evaluation/metrics.py``).

- MCD (mel-cepstral distortion, dB): 10/ln10 * sqrt(2 * sum_d (c_d-c'_d)^2)
  over DTW-aligned frames, cepstral c1..c12 from the port's log-mel front
  end (``audio/stft.py::MelSpectrogram`` -> DCT-II) evaluated FULL-BAND
  (fmax = sr/2; see mel_cepstra).
- F0 RMSE (Hz) over frames both estimators call voiced, plus voicing
  precision/recall/F1, with the port's DIO + StoneMask (``audio/dio.py``).

The spectra and the F0 tracks are computed on ``device`` (the card unless
the caller passes "cpu"); the DCT, the DTW and the statistics run in numpy
on the host, as in the JAX package.

    python -m fastspeech2_tpu_torch.evaluation.metrics REF.wav SYN.wav \\
        [--sr 22050] [--device cuda|cpu]
"""

import numpy as np
import torch


def _dct_ortho(x, n_out):
    """Orthonormal DCT-II over the last axis (scipy-free)."""
    n = x.shape[-1]
    k = np.arange(n_out)[:, None]
    basis = np.cos(np.pi * k * (2 * np.arange(n)[None, :] + 1) / (2 * n))
    basis *= np.sqrt(2.0 / n)
    basis[0] *= np.sqrt(0.5)
    return x @ basis.T


def mel_cepstra(wav, sr=22050, n_cep=13, hop_length=256, device="cuda"):
    """[T] float wav -> [frames, n_cep] mel cepstra (c0 included).

    Deliberately FULL-BAND (mel_fmax = sr/2), unlike the models' 8 kHz
    training mels: vocoder artifacts concentrate above 8 kHz and a quality
    metric should see them."""
    from fastspeech2_tpu_torch.audio.stft import MelSpectrogram

    mel_fn = MelSpectrogram(sampling_rate=sr, hop_length=hop_length,
                            mel_fmax=sr / 2.0)
    y = torch.as_tensor(np.asarray(wav, np.float32), device=device)
    with torch.inference_mode():
        mel, _ = mel_fn(y[None, :])
    logmel = mel[0].T.cpu().numpy()                   # [frames, n_mels]
    return _dct_ortho(logmel, n_cep)


def _dtw_path(cost, band=None):
    """DTW on a [A, B] local-cost matrix -> aligned index pairs.

    band (Sakoe-Chiba, in frames off the stretched diagonal) bounds the
    work to O(A*band) cells and prunes pathological warps; cells outside
    the band stay +inf, so minutes-long wavs stay tractable.
    """
    a, b = cost.shape
    acc = np.full((a + 1, b + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, a + 1):
        prev = acc[i - 1]
        cur = acc[i]
        if band is None:
            lo, hi = 1, b
        else:
            center = i * b / a
            lo = max(1, int(center - band))
            hi = min(b, int(center + band))
            if lo > hi:
                continue
        row = cost[i - 1]
        # min over the vertical/diagonal predecessors precomputes; the
        # horizontal (within-row) dependency is a running minimum
        base = np.minimum(prev[lo:hi + 1], prev[lo - 1:hi])
        running = np.inf
        for j in range(lo, hi + 1):
            running = min(base[j - lo], running)
            running = cur[j] = row[j - 1] + running
    path = []
    i, j = a, b
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        moves = ((acc[i - 1, j - 1], i - 1, j - 1),
                 (acc[i - 1, j], i - 1, j),
                 (acc[i, j - 1], i, j - 1))
        _, i, j = min(moves)
    path.reverse()
    return path


def mcd(ref_wav, syn_wav, sr=22050, n_cep=13, hop_length=256,
        device="cuda"):
    """Mel-cepstral distortion in dB between two waveforms (DTW-aligned,
    c0 excluded as is standard: it carries loudness, not timbre).

    Scale note: cepstra come from the DCT of the 80-band log-mel the
    models train on, not WORLD's warped mcep, so absolute values run
    higher than WORLD-based literature MCD.  Compare values produced by
    THIS function against each other."""
    cr = mel_cepstra(ref_wav, sr, n_cep, hop_length, device)[:, 1:]
    cs = mel_cepstra(syn_wav, sr, n_cep, hop_length, device)[:, 1:]
    # row-by-row cost avoids the [A, B, n_cep] broadcast tensor
    cost = np.empty((len(cr), len(cs)), np.float32)
    for i in range(len(cr)):
        d = cs - cr[i]
        cost[i] = np.sqrt(np.einsum("bc,bc->b", d, d))
    band = max(64, int(0.1 * max(len(cr), len(cs))))
    path = _dtw_path(cost, band=band)
    per_frame = np.asarray([cost[i, j] for i, j in path])
    return float(10.0 / np.log(10.0) * np.sqrt(2.0) * per_frame.mean())


def f0_metrics(ref_wav, syn_wav, sr=22050, hop_length=256, device="cuda"):
    """F0 RMSE (Hz, frames voiced in both) + voicing precision/recall/F1.

    Waveforms are compared frame for frame (copy-synthesis / vocoder
    evaluation); for duration-divergent pairs align externally first.
    """
    from fastspeech2_tpu_torch.audio.dio import dio_f0

    n = min(len(ref_wav), len(syn_wav))
    tracks = []
    for wav in (ref_wav, syn_wav):
        y = torch.as_tensor(np.asarray(wav[:n], np.float32), device=device)
        with torch.inference_mode():
            tracks.append(dio_f0(y, sr, hop_length).cpu().numpy())
    fr, fs = tracks
    n_frames = min(len(fr), len(fs))
    fr, fs = fr[:n_frames], fs[:n_frames]
    vr, vs = fr > 0, fs > 0
    both = vr & vs
    rmse = (float(np.sqrt(np.mean((fr[both] - fs[both]) ** 2)))
            if both.any() else float("nan"))
    tp = float(both.sum())
    precision = tp / max(float(vs.sum()), 1.0)
    recall = tp / max(float(vr.sum()), 1.0)
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"f0_rmse_hz": rmse, "voicing_precision": precision,
            "voicing_recall": recall, "voicing_f1": f1,
            "voiced_ref_frac": float(vr.mean()),
            "voiced_syn_frac": float(vs.mean())}


def main(argv=None):
    import argparse
    import json

    from fastspeech2_tpu_torch.audio.wav import load_wav
    from fastspeech2_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(
        description="Objective TTS metrics between two wavs (MCD dB, "
                    "F0 RMSE Hz, voicing F1)")
    ap.add_argument("ref_wav")
    ap.add_argument("syn_wav")
    ap.add_argument("--sr", type=int, default=22050)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ref, _ = load_wav(args.ref_wav, args.sr)
    syn, _ = load_wav(args.syn_wav, args.sr)
    out = {"mcd_db": round(mcd(ref, syn, args.sr, device=device), 3)}
    out.update({k: round(v, 4) for k, v in
                f0_metrics(ref, syn, args.sr, device=device).items()})
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
