"""Slaney-scale mel filterbank (librosa.filters.mel semantics; a copy of
``fastspeech2_tpu/audio/mel.py``, numpy only).

The reference builds its filterbank with librosa (audio/stft.py:145-149,
defaults: htk=False -> Slaney mel scale, norm='slaney'); this computes it
from the published Slaney formula.
"""

import numpy as np

_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = 15.0
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f * 3.0 / 200.0
    log_region = f >= _MIN_LOG_HZ
    mel = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ)
        / _LOGSTEP,
        mel,
    )
    return mel


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * 200.0 / 3.0
    log_region = m >= _MIN_LOG_MEL
    f = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(m, _MIN_LOG_MEL)
                                         - _MIN_LOG_MEL)),
        f,
    )
    return f


def mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax=None):
    """[n_mels, 1 + n_fft//2] triangular filters with Slaney normalization."""
    if fmax is None:
        fmax = sampling_rate / 2.0
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style energy normalization
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)
