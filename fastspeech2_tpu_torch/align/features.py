"""Acoustic features for forced alignment: MFCC + deltas + CMVN (port of
``fastspeech2_tpu/align/features.py``).

They are computed from the same MelSpectrogram as the training features
(audio/stft.py), so frame indices here are exactly training mel-frame
indices (hop 256 at 22.05 kHz) and alignment durations transfer to the
acoustic model without resampling.  The features are computed on the
device the caller names.
"""

import numpy as np
import torch

from fastspeech2_tpu_torch.audio.stft import MelSpectrogram


def _dct_matrix(n_out, n_in):
    """Orthonormal DCT-II basis [n_out, n_in] (scipy.fft.dct norm='ortho')."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    basis *= np.sqrt(2.0 / n_in)
    basis[0] *= np.sqrt(0.5)
    return basis.astype(np.float32)


def _delta(x, width=2):
    """HTK-style regression deltas over +-width frames. x: [B, T, D]."""
    num = torch.zeros_like(x)
    left = x[:, :1]
    right = x[:, -1:]
    for k in range(1, width + 1):
        fwd = torch.cat([x[:, k:], right.expand(-1, k, -1)], dim=1)
        bwd = torch.cat([left.expand(-1, k, -1), x[:, :-k]], dim=1)
        num = num + k * (fwd - bwd)
    denom = 2 * sum(k * k for k in range(1, width + 1))
    return num / denom


def mfcc_from_wav(wavs, mel_fn, n_mfcc):
    """[B, L] wavs -> [B, T, 3 * n_mfcc] MFCCs with deltas and
    delta-deltas."""
    logmel, _ = mel_fn(wavs)                      # [B, n_mels, T] (log)
    logmel = logmel.transpose(1, 2)               # [B, T, n_mels]
    dct = torch.as_tensor(_dct_matrix(n_mfcc, logmel.shape[-1]),
                          device=wavs.device)
    mfcc = torch.einsum("btm,cm->btc", logmel, dct)
    d1 = _delta(mfcc)
    d2 = _delta(d1)
    return torch.cat([mfcc, d1, d2], dim=-1)


def alignment_features(wavs, lengths, mel_fn: MelSpectrogram, n_mfcc=13,
                       device="cuda"):
    """Padded wav batch -> CMVN'd MFCC+deltas and per-utterance frame counts.

    wavs: [B, L] float in [-1, 1] (zero-padded); lengths: [B] sample counts.
    Returns (feats [B, T, 3*n_mfcc] float32 numpy, n_frames [B] int32)
    where frame t covers samples [t*hop, t*hop + n_fft) of the centered
    STFT, identical gridding to the training mels.
    """
    wavs = torch.as_tensor(np.stack(wavs).astype(np.float32), device=device)
    feats = mfcc_from_wav(wavs, mel_fn, n_mfcc)
    n_frames = np.asarray(
        [int(n) // mel_fn.hop_length + 1 for n in lengths], np.int32)
    # per-utterance CMVN over valid frames only
    t_idx = np.arange(feats.shape[1])
    m = torch.as_tensor(t_idx[None, :] < n_frames[:, None],
                        device=feats.device)[..., None]
    cnt = torch.clamp(m.sum(dim=1), min=1)        # [B, 1] frames
    mean = (feats * m).sum(dim=1, keepdim=True) / cnt[:, None]
    var = ((feats - mean) ** 2 * m).sum(dim=1, keepdim=True) / cnt[:, None]
    feats = (feats - mean) / torch.sqrt(var + 1e-8)
    return (feats * m).float().cpu().numpy(), n_frames
