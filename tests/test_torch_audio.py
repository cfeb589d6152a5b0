"""PyTorch port, the audio DSP (``fastspeech2_tpu_torch/audio``), against
the JAX package's ``fastspeech2_tpu/audio/{mel,stft}.py`` on the CPU.

Inputs: a tracked LJSpeech10 clip (``raw_data/LJSpeech10``) and numpy
seeds.  Tolerances: the filterbank is equal; magnitudes, mels and
energies within 1e-5 of the largest value of their kind (float32 FFTs of
1024 points, the same sums in another order), log-mels within 1e-3
absolute (bins near the 1e-5 clamp); the inverse STFT within
1e-6 absolute on a waveform of peak ~0.1; Griffin-Lim, fed JAX's initial
phase, within 1e-4 absolute on the float waveform in [-1, 1].
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from fastspeech2_tpu.audio import mel as jax_mel
from fastspeech2_tpu.audio import stft as jax_stft
from fastspeech2_tpu_torch.audio import mel, stft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = os.path.join(REPO, "raw_data", "LJSpeech10", "LJSpeech",
                    "LJ001-0012.wav")
N_FFT, HOP, WIN = 1024, 256, 1024


@pytest.fixture(scope="module")
def clip():
    """The first 1.5 s of a tracked clip as float in [-1, 1], [1, T]."""
    sr, wav = wavfile.read(CLIP)
    assert sr == 22050 and wav.dtype == np.int16
    return (wav[None, : int(1.5 * sr)] / 32768.0).astype(np.float32)


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (22050, 1024, 80, 0.0, 8000.0),     # LJSpeech, AISHELL3
    (16000, 512, 40, 50.0, None),
])
def test_mel_filterbank_matches_jax(sr, n_fft, n_mels, fmin, fmax):
    got = mel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    ref = jax_mel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    f = np.linspace(0.0, 11025.0, 97)
    np.testing.assert_array_equal(mel.hz_to_mel(f), jax_mel.hz_to_mel(f))
    np.testing.assert_array_equal(mel.mel_to_hz(mel.hz_to_mel(f)),
                                  jax_mel.mel_to_hz(jax_mel.hz_to_mel(f)))


def test_frames_and_window_match_jax(clip):
    got = stft.frame_signal(torch.from_numpy(clip), N_FFT, HOP).numpy()
    ref = np.asarray(jax_stft.frame_signal(jnp.asarray(clip), N_FFT, HOP))
    np.testing.assert_array_equal(got, ref)
    for win in (1024, 800):
        np.testing.assert_array_equal(stft._hann(win, N_FFT),
                                      jax_stft._hann(win, N_FFT))


def test_stft_magnitude_matches_jax(clip):
    got = stft.stft_magnitude(torch.from_numpy(clip), N_FFT, HOP,
                              WIN).numpy()
    ref = np.asarray(jax_stft.stft_magnitude(jnp.asarray(clip), N_FFT, HOP,
                                             WIN))
    assert got.shape == ref.shape == (1, 513, clip.shape[1] // HOP + 1)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(),
                               rtol=0)


def test_mel_spectrogram_matches_jax(clip):
    got_mel, got_energy = stft.MelSpectrogram()(torch.from_numpy(clip))
    ref_mel, ref_energy = jax_stft.MelSpectrogram()(jnp.asarray(clip))
    ref_mel, ref_energy = np.asarray(ref_mel), np.asarray(ref_energy)
    assert got_mel.shape == ref_mel.shape == (1, 80, ref_energy.shape[1])
    # the mel before its log within 1e-5 of its largest value; the log of
    # bins near the 1e-5 clamp turns an absolute error of ~1e-8 into
    # ~1e-3, so the log-mel is held at 1e-3
    lin = np.exp(ref_mel)
    np.testing.assert_allclose(np.exp(got_mel.numpy()), lin,
                               atol=1e-5 * lin.max(), rtol=0)
    np.testing.assert_allclose(got_mel.numpy(), ref_mel, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got_energy.numpy(), ref_energy,
                               atol=1e-5 * ref_energy.max(), rtol=0)
    x = np.abs(ref_mel[0, :, :5])
    np.testing.assert_allclose(
        stft.dynamic_range_decompression(
            stft.dynamic_range_compression(torch.from_numpy(x))).numpy(),
        np.asarray(jax_stft.dynamic_range_decompression(
            jax_stft.dynamic_range_compression(jnp.asarray(x)))),
        rtol=1e-6)


def test_istft_matches_jax():
    rng = np.random.default_rng(0)
    mag = np.abs(rng.standard_normal((2, 513, 30))).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
    got = stft.istft(torch.from_numpy(mag), torch.from_numpy(phase), N_FFT,
                     HOP, WIN).numpy()
    ref = np.asarray(jax_stft.istft(jnp.asarray(mag), jnp.asarray(phase),
                                    N_FFT, HOP, WIN))
    assert got.shape == ref.shape == (2, HOP * 29)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n,hop,n_frames", [(16, 4, 7), (10, 4, 5),
                                            (3, 5, 4)])
def test_overlap_add_is_the_frame_loop(n, hop, n_frames):
    """The shifted reshapes add frame i at sample i * hop, for a hop that
    divides the frame, one that does not, and one longer than it."""
    rng = np.random.default_rng(n + hop)
    frames = rng.standard_normal((2, n_frames, n)).astype(np.float32)
    ref = np.zeros((2, hop * (n_frames - 1) + n), np.float32)
    for i in range(n_frames):
        ref[:, i * hop: i * hop + n] += frames[:, i]
    got = stft.overlap_add(torch.from_numpy(frames), hop).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_iters", [0, 4, 30])
def test_griffin_lim_with_jax_initial_phase_matches_jax(clip, n_iters):
    mag = jax_stft.stft_magnitude(jnp.asarray(clip), N_FFT, HOP, WIN)
    mag = np.array(mag[:, :, :100])
    phase = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), mag.shape,
                                          minval=-np.pi, maxval=np.pi))
    ref = np.asarray(jax_stft.griffin_lim(jnp.asarray(mag), N_FFT, HOP, WIN,
                                          n_iters=n_iters))
    got = stft.griffin_lim(torch.from_numpy(mag), N_FFT, HOP, WIN,
                           n_iters=n_iters,
                           phase=torch.from_numpy(np.array(phase))).numpy()
    assert got.shape == ref.shape == (1, HOP * 99)
    assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_random_phase_is_seeded_and_in_range():
    a = stft.random_phase((1, 513, 40), 0, "cpu")
    assert torch.equal(a, stft.random_phase((1, 513, 40), 0, "cpu"))
    assert not torch.equal(a, stft.random_phase((1, 513, 40), 1, "cpu"))
    assert a.dtype == torch.float32
    assert float(a.min()) >= -np.pi and float(a.max()) < np.pi
    # griffin_lim draws it when no phase is given
    mag = torch.rand(1, 513, 12)
    torch.testing.assert_close(
        stft.griffin_lim(mag, N_FFT, HOP, WIN, n_iters=2, seed=3),
        stft.griffin_lim(mag, N_FFT, HOP, WIN, n_iters=2,
                         phase=stft.random_phase(mag.shape, 3, "cpu")),
        rtol=0, atol=0)
