"""YIN F0 estimation in PyTorch (port of ``fastspeech2_tpu/audio/f0.py``)
and the linear interpolation over unvoiced frames (numpy, copied).

YIN: difference function -> cumulative-mean normalization -> the first
local minimum under the threshold + parabolic interpolation, with the same
output contract as :func:`fastspeech2_tpu_torch.audio.dio.dio_f0`: one F0
value per mel frame, Hz, 0.0 at unvoiced frames.  Takes [T] or a [B, T]
batch, on any device.
"""

import numpy as np
import torch
from torch.nn import functional as F


def yin_f0(y, sampling_rate, hop_length, f0_floor: float = 71.0,
           f0_ceil: float = 800.0, threshold: float = 0.15):
    """y: [(B,) T] float waveform tensor -> [(B,) n_frames] F0 (Hz, 0 =
    unvoiced), n_frames = 1 + T // hop_length (the centered mel framing)."""
    y = torch.as_tensor(y).to(torch.float32)
    single = y.dim() == 1
    if single:
        y = y[None]
    device = y.device
    tau_max = int(sampling_rate / f0_floor) + 1
    tau_min = max(2, int(sampling_rate / f0_ceil))
    window = 2 * tau_max  # integration window per frame

    pad = window // 2
    y = F.pad(y, (pad, pad + window))
    n_frames = 1 + (y.shape[-1] - 2 * pad - window) // hop_length
    idx = (torch.arange(n_frames, device=device)[:, None] * hop_length
           + torch.arange(window + tau_max, device=device)[None, :])
    frames = y[:, idx]                               # [B, F, W + tau_max]

    # difference function d(tau) = r(0) + r_tau(0) - 2*corr(tau) via FFT
    x = frames
    x0 = x[..., :window]
    fft_len = 1
    while fft_len < (window + tau_max):
        fft_len *= 2
    fx = torch.fft.rfft(x, n=fft_len, dim=-1)
    fx0 = torch.fft.rfft(x0.flip(-1), n=fft_len, dim=-1)
    corr = torch.fft.irfft(fx * fx0, n=fft_len, dim=-1)[
        ..., window - 1: window - 1 + tau_max + 1]   # corr[tau]

    cumsq = torch.cumsum(x * x, dim=-1)
    r0 = cumsq[..., window - 1]
    sq = F.pad(cumsq, (1, 0))
    taus = torch.arange(tau_max + 1, device=device)
    r_tau = sq[..., taus + window] - sq[..., taus]
    d = r0[..., None] + r_tau - 2.0 * corr           # [B, F, tau_max+1]
    d = torch.clamp(d, min=0.0)

    # cumulative-mean-normalized difference
    tau = taus.to(d.dtype)
    csum = torch.cumsum(d[..., 1:], dim=-1)
    cmndf = torch.cat(
        [torch.ones_like(d[..., :1]),
         d[..., 1:] * tau[1:] / torch.clamp(csum, min=1e-12)], dim=-1)

    # first LOCAL MINIMUM of the cmndf in [tau_min, tau_max) under the
    # threshold; the global argmin when nothing crosses it
    in_range = (tau >= tau_min) & (tau < tau_max)
    prev = torch.cat([cmndf[..., :1], cmndf[..., :-1]], dim=-1)
    nxt = torch.cat([cmndf[..., 1:], cmndf[..., -1:]], dim=-1)
    is_min = (cmndf <= prev) & (cmndf <= nxt)
    below = is_min & (cmndf < threshold) & in_range
    big = torch.where(in_range, cmndf, torch.inf)
    # argmax of a 0/1 row is its first 1, as jnp.argmax gives it
    first_below = torch.argmax(below.to(torch.int32), dim=-1)
    any_below = torch.any(below, dim=-1)
    best = torch.where(any_below, first_below, torch.argmin(big, dim=-1))

    # parabolic interpolation around the minimum
    b_idx = torch.clamp(best, 1, tau_max - 1)
    dm = torch.gather(cmndf, -1, (b_idx - 1)[..., None])[..., 0]
    d0 = torch.gather(cmndf, -1, b_idx[..., None])[..., 0]
    dp = torch.gather(cmndf, -1, (b_idx + 1)[..., None])[..., 0]
    denom = dm + dp - 2.0 * d0
    shift = torch.where(torch.abs(denom) > 1e-12, 0.5 * (dm - dp) / denom,
                        0.0)
    shift = torch.clamp(shift, -1.0, 1.0)
    tau_refined = b_idx.to(d.dtype) + shift

    # silence gate: all-zero frames give d == 0 -> cmndf == 0, which would
    # read as "perfectly periodic"; require real signal energy
    has_energy = r0 / window > 1e-9
    voiced = any_below & (d0 < 0.5) & has_energy
    f0 = torch.where(voiced,
                     sampling_rate / torch.clamp(tau_refined, min=1.0), 0.0)
    return f0[0] if single else f0


def interpolate_unvoiced(f0):
    """Linear interpolation over unvoiced (zero) frames
    (numpy port of preprocessor/preprocessor.py:198-207 semantics)."""
    f0 = np.asarray(f0, dtype=np.float64).copy()
    voiced = f0 > 0
    if not voiced.any():
        return f0
    idx = np.arange(len(f0))
    f0[~voiced] = np.interp(idx[~voiced], idx[voiced], f0[voiced])
    return f0
