"""WAV file IO and resampling (copy of ``fastspeech2_tpu/audio/wav.py``,
which is scipy only).

The reference loads audio with librosa.load (resampling to the config rate)
and writes int16 wavs with scipy (utils/tools.py:208-210, max_wav_value
32768).  Reading uses scipy.io.wavfile plus polyphase resampling.
"""

import math

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path, target_sr=None):
    """-> (float64 mono waveform in [-1, 1], sampling_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        y = data.astype(np.float64) / 32768.0
    elif data.dtype == np.int32:
        y = data.astype(np.float64) / 2147483648.0
    elif data.dtype == np.uint8:
        y = (data.astype(np.float64) - 128.0) / 128.0
    else:
        y = data.astype(np.float64)
    if y.ndim > 1:
        y = y.mean(axis=1)
    if target_sr is not None and target_sr != sr:
        g = math.gcd(int(target_sr), int(sr))
        y = resample_poly(y, target_sr // g, sr // g)
        sr = target_sr
    return y, sr


def save_wav(path, wav, sampling_rate, max_wav_value=32768.0):
    """Float waveform -> int16 wav (vocoder_infer scaling,
    utils/model.py:82-86)."""
    wav = np.asarray(wav, dtype=np.float64) * max_wav_value
    wav = np.clip(wav, -32768, 32767).astype(np.int16)
    wavfile.write(path, sampling_rate, wav)
