"""STFT, mel spectrogram, inverse STFT and Griffin-Lim in PyTorch (port of
``fastspeech2_tpu/audio/stft.py``).

Numerics follow the reference TacotronSTFT (audio/stft.py:130-178): reflect
padding of n_fft//2 samples, periodic Hann window, magnitude spectra,
Slaney mel filterbank, log-compression log(clamp(x, 1e-5)), and energy =
the per-frame L2 norm of the magnitude spectrum.  Tensors stay on the
device they come in on; the FFTs are ``torch.fft`` (cuFFT on the card).

Two places differ in form from the JAX package, not in value:

- The overlap-add of :func:`istft` is a sum of ceil(n_fft / hop) shifted
  reshapes (:func:`overlap_add`), added in the order of the JAX package's
  frame loop: no scatter and no atomics, so a run on the card repeats bit
  for bit.
- The initial phase of :func:`griffin_lim` cannot be JAX's
  (``jax.random.uniform(PRNGKey(seed))``): it is an argument, or
  :func:`random_phase` draws it on the CPU from a ``torch.Generator``
  seeded with ``seed`` and moves it to the device, so the card and the CPU
  start from the same phase.
"""

import dataclasses
import functools
import math

import numpy as np
import torch
from scipy.signal import get_window
from torch.nn import functional as F

from fastspeech2_tpu_torch.audio.mel import mel_filterbank


def _hann(win_length, n_fft):
    w = get_window("hann", win_length, fftbins=True)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        w = np.pad(w, (pad, n_fft - win_length - pad))
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window(win_length, n_fft, device):
    """The window on ``device``, made once: a copy from the host in every
    STFT would make the host wait for the card each time.  It is made
    outside inference mode even when first asked for inside it, so a
    later STFT that autograd differentiates (vocoder training) can save
    it for its backward."""
    with torch.inference_mode(False):
        return torch.as_tensor(_hann(win_length, n_fft), device=device)


@functools.lru_cache(maxsize=None)
def _mel_basis(sampling_rate, n_fft, n_mels, fmin, fmax, device):
    """The filterbank on ``device``, made once, as :func:`_window` is."""
    with torch.inference_mode(False):
        return torch.as_tensor(mel_filterbank(sampling_rate, n_fft, n_mels,
                                              fmin, fmax), device=device)


def frame_signal(y, n_fft, hop_length):
    """[B, T] -> [B, n_frames, n_fft] with reflect-centered frames."""
    pad = n_fft // 2
    y = F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return y.unfold(-1, n_fft, hop_length)


def stft_magnitude(y, n_fft, hop_length, win_length):
    """[B, T] float in [-1, 1] -> [B, 1 + n_fft//2, n_frames] magnitudes."""
    frames = frame_signal(y, n_fft, hop_length)
    spec = torch.fft.rfft(frames * _window(win_length, n_fft, y.device),
                          dim=-1)
    return spec.abs().transpose(1, 2).float()


def dynamic_range_compression(x, clip_val=1e-5):
    return torch.log(torch.clamp(x, min=clip_val))


def dynamic_range_decompression(x):
    return torch.exp(x)


@dataclasses.dataclass(frozen=True)
class MelSpectrogram:
    """Callable mel+energy extractor (TacotronSTFT equivalent)."""

    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 80
    sampling_rate: int = 22050
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0

    def mel_basis(self, device="cpu"):
        return _mel_basis(self.sampling_rate, self.filter_length,
                          self.n_mel_channels, self.mel_fmin, self.mel_fmax,
                          torch.device(device))

    def __call__(self, y):
        """y: [B, T] in [-1, 1] -> (mel [B, n_mels, F], energy [B, F])."""
        mag = stft_magnitude(
            y, self.filter_length, self.hop_length, self.win_length)
        mel = torch.einsum("mf,bft->bmt", self.mel_basis(y.device), mag)
        mel = dynamic_range_compression(mel)
        energy = torch.linalg.norm(mag, dim=1)
        return mel, energy


def overlap_add(frames, hop_length):
    """[B, n_frames, n] -> [B, hop * (n_frames - 1) + n]: frame i added at
    sample i * hop.

    Each frame is zero-padded to m = ceil(n / hop) blocks of hop samples;
    block j of every frame lands on row i + j of a [n_frames + m - 1, hop]
    grid, so the sum is m shifted reshapes.  They are added from j = m - 1
    down to 0, i.e. frame by frame in ascending order at every sample, as
    the JAX package's loop adds them (padding adds exact zeros)."""
    b, n_frames, n = frames.shape
    m = -(-n // hop_length)
    frames = F.pad(frames, (0, m * hop_length - n))
    sig = None
    for j in reversed(range(m)):
        block = frames[:, :, j * hop_length:(j + 1) * hop_length]
        part = F.pad(block, (0, 0, j, m - 1 - j)).reshape(b, -1)
        sig = part if sig is None else sig + part
    return sig[:, : hop_length * (n_frames - 1) + n]


def istft(magnitude, phase, n_fft, hop_length, win_length):
    """[B, n_bins, n_frames] magnitude and phase -> [B, hop * (n_frames-1)]
    by overlap-add with window-sum-square correction (reference
    audio/stft.py:83-122 semantics); n_fft//2 samples are cropped at each
    end."""
    spec = torch.polar(magnitude, phase)
    frames = torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1)
    window = _window(win_length, n_fft, magnitude.device)
    frames = frames * window
    n_frames = frames.shape[1]
    sig = overlap_add(frames, hop_length)
    wss = overlap_add((window ** 2).expand(1, n_frames, n_fft), hop_length)
    sig = torch.where(wss > 1e-11, sig / wss, sig)
    pad = n_fft // 2
    return sig[:, pad: sig.shape[1] - pad]


def random_phase(shape, seed, device):
    """Griffin-Lim's initial phase, uniform in [-pi, pi): drawn on the CPU
    from a ``torch.Generator`` seeded with ``seed``, then moved to
    ``device``."""
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    return (torch.rand(tuple(shape), generator=g) * (2.0 * math.pi)
            - math.pi).to(device)


def griffin_lim(magnitude, n_fft, hop_length, win_length, n_iters=30,
                seed=0, phase=None):
    """Phase recovery (reference audio/audio_processing.py:66-82):
    [B, n_bins, n_frames] magnitude -> [B, hop * (n_frames - 1)] waveform.
    ``phase``: the initial phase; by default :func:`random_phase` of
    ``seed``."""
    if phase is None:
        phase = random_phase(magnitude.shape, seed, magnitude.device)
    window = _window(win_length, n_fft, magnitude.device)
    for _ in range(n_iters):
        sig = istft(magnitude, phase, n_fft, hop_length, win_length)
        spec = torch.fft.rfft(frame_signal(sig, n_fft, hop_length) * window,
                              dim=-1)
        phase = torch.angle(spec).transpose(1, 2)
    return istft(magnitude, phase, n_fft, hop_length, win_length)
