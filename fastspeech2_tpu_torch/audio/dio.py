"""DIO + StoneMask F0 estimation in PyTorch (port of
``fastspeech2_tpu/audio/dio.py``), float32, on tensors on any device.

The algorithm is the JAX package's (its docstring gives the derivation from
WORLD's dio.cpp and stonemask.cpp): band-limit the signal with
Nuttall-window low-pass filters at half-octave cutoffs, read four
interval-based period estimates per frame in each band, keep the
best-scoring band per frame, clean the contour, then refine each voiced
frame by the amplitude-weighted instantaneous frequency of its first six
harmonics.  One F0 value (Hz) per mel frame, 0.0 where unvoiced.

Every function takes a leading batch dimension where the JAX package is
vmapped over the preprocessor's DSP batch
(fastspeech2_tpu/preprocessing/preprocessor.py:259-275).  The JAX
package's associative scans for the previous and next event become
``torch.cummax`` and a flipped ``torch.cummin``; ``torch.round`` rounds
half to even as ``jnp.round`` does.  Arithmetic follows the JAX code's
order of operations in float32.
"""

import math

import torch


def _nuttall(n, length):
    """Nuttall window value at integer position ``n`` of ``length`` points
    (WORLD's matlabfunctions.cpp NuttallWindow)."""
    t = 2.0 * math.pi * n / (length - 1)
    return (0.355768 - 0.487396 * torch.cos(t)
            + 0.144232 * torch.cos(2 * t) - 0.012604 * torch.cos(3 * t))


def _lowpass(spec_y, fft_len, fs, cutoff):
    """Low-pass ``y`` (given as its rfft, [..., fft_len // 2 + 1]) with a
    Nuttall-window FIR whose support is 4 periods of the cutoff frequency
    (dio.cpp GetFilteredSignal), applied zero-phase."""
    device = spec_y.device
    half = int(round(fs / cutoff * 2.0))
    length = 2 * half + 1
    n = torch.arange(length, dtype=torch.float32, device=device)
    w = _nuttall(n, length)
    w = w / torch.sum(w)  # unit DC gain
    fw = torch.fft.rfft(w, n=fft_len)
    freq = torch.arange(fft_len // 2 + 1, dtype=torch.float32, device=device)
    # undo the linear phase of the centered tap (delay = half samples)
    angle = 2.0 * math.pi * freq * half / fft_len
    phase = torch.polar(torch.ones_like(angle), angle)
    return spec_y * fw * phase


def _take(values, index):
    """values [B, n] gathered at index [B, F] (or [F]) along the last dim."""
    if index.dim() == 1:
        index = index.expand(values.shape[0], -1)
    return torch.gather(values, 1, index)


def _prev_next(events, n):
    """events [B, n] bool -> (index of the last event at or before t, -1
    if none; index of the first event at or after t, n if none)."""
    idx = torch.arange(n, device=events.device)
    prev_idx = torch.cummax(torch.where(events, idx, -1), dim=-1).values
    nxt = torch.where(events, idx, n).flip(-1)
    next_idx = torch.cummin(nxt, dim=-1).values.flip(-1)
    return prev_idx, next_idx


def _event_f0(x, frame_pos, fs):
    """Four interval-based F0 tracks evaluated at ``frame_pos`` samples.

    x: [B, T] band-limited signals.  Returns [B, 4, F] F0 estimates in Hz
    (0 where no enclosing event pair exists), from the intervals between
    negative-going zero crossings, positive-going zero crossings, peaks,
    and dips (dio.cpp GetFourZeroCrossingIntervals).
    """
    dx = torch.diff(x, dim=-1, append=x[..., -1:])

    def track(sig):
        s0 = sig[..., :-1]
        s1 = sig[..., 1:]
        n = s0.shape[-1]
        cross = (s0 > 0) & (s1 <= 0)                    # negative-going
        # fractional crossing position between t and t+1
        denom = s0 - s1
        frac = torch.where(torch.abs(denom) > 1e-12, s0 / denom, 0.5)
        pos = torch.arange(n, dtype=torch.float32, device=sig.device) + frac
        prev_idx, next_idx = _prev_next(cross, n)
        fp = torch.clamp(frame_pos, 0, n - 1)
        j_i = prev_idx[..., fp]                          # crossing j
        k_i = next_idx[..., torch.clamp(fp + 1, max=n - 1)]  # crossing j+1
        valid = (j_i >= 0) & (k_i < n)
        # neighbours for midpoint interpolation: crossings j-1 and j+2
        jm1_i = _take(prev_idx, torch.clamp(j_i - 1, 0, n - 1))
        kp1_i = _take(next_idx, torch.clamp(k_i + 1, 0, n - 1))
        p_j = _take(pos, torch.clamp(j_i, 0, n - 1))
        p_k = _take(pos, torch.clamp(k_i, 0, n - 1))
        p_jm1 = _take(pos, torch.clamp(jm1_i, 0, n - 1))
        p_kp1 = _take(pos, torch.clamp(kp1_i, 0, n - 1))
        # interval values at their temporal midpoints (dio.cpp
        # GetF0CandidateContour: interp1 over (midpoint, fs/interval))
        v_mid = fs / torch.clamp(p_k - p_j, min=1.0)
        m_mid = 0.5 * (p_j + p_k)
        v_left = fs / torch.clamp(p_j - p_jm1, min=1.0)
        m_left = 0.5 * (p_jm1 + p_j)
        v_right = fs / torch.clamp(p_kp1 - p_k, min=1.0)
        m_right = 0.5 * (p_k + p_kp1)
        has_left = valid & (jm1_i >= 0) & (jm1_i < j_i)
        has_right = valid & (kp1_i < n) & (kp1_i > k_i)
        t = fp.to(torch.float32)

        def lerp(t0, v0, t1, v1):
            w = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-6),
                            0.0, 1.0)
            return v0 + w * (v1 - v0)

        right_val = torch.where(has_right,
                                lerp(m_mid, v_mid, m_right, v_right), v_mid)
        left_val = torch.where(has_left,
                               lerp(m_left, v_left, m_mid, v_mid), v_mid)
        f0 = torch.where(t >= m_mid, right_val, left_val)
        return torch.where(valid, f0, 0.0)

    return torch.stack([track(x), track(-x), track(dx), track(-dx)], dim=1)


def _dio_candidates(y, fs, hop_length, f0_floor, f0_ceil):
    """y [B, T] -> (best band's F0 [B, F], its score [B, F])."""
    T = y.shape[-1]
    n_frames = 1 + T // hop_length
    frame_pos = torch.arange(n_frames, device=y.device) * hop_length

    fft_len = 1
    while fft_len < T + int(round(fs / f0_floor * 4.0)):
        fft_len *= 2
    # 50 Hz low-cut (dio.cpp applies one before candidate search)
    spec = torch.fft.rfft(y - torch.mean(y, dim=-1, keepdim=True),
                          n=fft_len)
    freq = (torch.arange(fft_len // 2 + 1, device=y.device)
            * (fs / fft_len)).to(torch.float32)
    lowcut = torch.clamp((freq - 25.0) / 25.0, 0.0, 1.0)
    spec = spec * lowcut

    n_bands = int(math.ceil(math.log2(f0_ceil / f0_floor) * 2.0))
    cands, scores = [], []
    for k in range(n_bands):
        boundary = f0_floor * (2.0 ** ((k + 1) / 2.0))
        xk = torch.fft.irfft(_lowpass(spec, fft_len, fs, boundary),
                             n=fft_len)[..., :T]
        est = _event_f0(xk, frame_pos, fs)               # [B, 4, F]
        ok = torch.all(est > 0, dim=1)
        mean = torch.mean(est, dim=1)
        dev = torch.sqrt(torch.sum((est - mean[:, None]) ** 2, dim=1) / 3.0)
        in_range = ((mean >= max(f0_floor, boundary / 4.0))
                    & (mean <= f0_ceil) & (mean <= boundary * 1.1))
        good = ok & in_range
        score = torch.where(good, dev / torch.clamp(mean, min=1e-6),
                            math.inf)
        cands.append(mean)
        scores.append(score)
    cand = torch.stack(cands, dim=1)                     # [B, K, F]
    score = torch.stack(scores, dim=1)
    # the first of equal scores, as jnp.argmin takes it
    best = torch.argmin(score, dim=1, keepdim=True)
    f0 = torch.gather(cand, 1, best)[:, 0]
    best_score = torch.gather(score, 1, best)[:, 0]
    return f0, best_score


def _fix_contour(f0, score, allowed_range=0.1, score_max=0.15,
                 min_run=4):
    """Contour cleaning (dio.cpp FixF0Contour steps 1-2): unreliable scores
    -> 0; relative jumps > allowed_range -> 0; voiced runs shorter than
    ``min_run`` frames -> 0.  [B, F] -> [B, F]."""
    voiced = (f0 > 0) & (score < score_max) & torch.isfinite(score)
    f0 = torch.where(voiced, f0, 0.0)
    prev = torch.cat([f0[..., :1], f0[..., :-1]], dim=-1)
    jump = ((prev > 0) & (f0 > 0)
            & (torch.abs(f0 - prev) / torch.clamp(f0, min=1e-6)
               > allowed_range))
    f0 = torch.where(jump, 0.0, f0)
    # run-length of consecutive voiced frames via two scans
    last_unvoiced, next_unvoiced = _prev_next(f0 <= 0, f0.shape[-1])
    run = next_unvoiced - last_unvoiced - 1
    return torch.where(run >= min_run, f0, 0.0)


def _stonemask(y, f0, fs, hop_length, f0_floor):
    """Refine each voiced frame's F0 by the amplitude-weighted mean of
    instantaneous frequencies at harmonics 1..6 (stonemask.cpp).
    y [B, T], f0 [B, F] -> [B, F]."""
    T = y.shape[-1]
    n_frames = f0.shape[-1]
    device = y.device
    frame_pos = torch.arange(n_frames, device=device) * hop_length

    j_max = int(math.ceil(1.5 * fs / f0_floor)) + 1
    fft_size = 1
    while fft_size < 2 * (2 * j_max + 1):
        fft_size *= 2

    safe_f0 = torch.clamp(f0, min=f0_floor)
    half = torch.floor(1.5 * fs / safe_f0).to(torch.int32) + 1  # [B, F]
    j = torch.arange(-j_max, j_max + 1, device=device)           # [W]
    in_win = torch.abs(j) <= half[..., None]                     # [B, F, W]
    base_t = (j / fs).to(torch.float32)                          # seconds
    # Blackman window over +-1.5 periods (stonemask.cpp GetBaseIndex/
    # main_window)
    arg = 2.0 * math.pi * base_t * safe_f0[..., None] / 3.0
    w = (0.42 + 0.5 * torch.cos(arg) + 0.08 * torch.cos(2 * arg)) * in_win
    dw = torch.nn.functional.pad(-(w[..., 2:] - w[..., :-2]) / 2.0, (1, 1))

    gather = torch.clamp(frame_pos[:, None] + j[None, :], 0, T - 1)
    seg = y[:, gather] * in_win                                  # [B, F, W]

    spec = torch.fft.rfft(seg * w, n=fft_size, dim=-1)
    dspec = torch.fft.rfft(seg * dw, n=fft_size, dim=-1)
    power = torch.clamp(spec.real ** 2 + spec.imag ** 2, min=1e-12)
    bin_freq = (torch.arange(fft_size // 2 + 1, device=device)
                * (fs / fft_size)).to(torch.float32)
    inst = bin_freq + (
        spec.real * dspec.imag - spec.imag * dspec.real
    ) / power * fs / (2.0 * math.pi)

    num = torch.zeros_like(safe_f0)
    den = torch.zeros_like(safe_f0)
    for k in range(1, 7):
        b = torch.clamp(torch.round(k * safe_f0 * fft_size / fs).long(),
                        0, fft_size // 2)
        amp = torch.sqrt(torch.gather(power, -1, b[..., None])[..., 0])
        ifk = torch.gather(inst, -1, b[..., None])[..., 0]
        num = num + amp * ifk / k
        den = den + amp
    refined = num / torch.clamp(den, min=1e-12)
    good = ((f0 > 0) & (refined > f0_floor * 0.9)
            & (torch.abs(refined - f0) < 0.35 * f0))
    return torch.where(good, refined, torch.where(f0 > 0, f0, 0.0))


def dio_f0(y, sampling_rate, hop_length, f0_floor: float = 71.0,
           f0_ceil: float = 800.0):
    """y: [T] or [B, T] float waveform tensor -> [(B,) 1 + T // hop_length]
    F0 (Hz, 0 = unvoiced) on y's device.

    DIO candidate search + contour fix + StoneMask refinement; the JAX
    package's ``dio_f0`` row by row.
    """
    y = torch.as_tensor(y).to(torch.float32)
    single = y.dim() == 1
    if single:
        y = y[None]
    f0, score = _dio_candidates(y, int(sampling_rate), int(hop_length),
                                float(f0_floor), float(f0_ceil))
    f0 = _fix_contour(f0, score)
    f0 = _stonemask(y, f0, int(sampling_rate), int(hop_length),
                    float(f0_floor))
    return f0[0] if single else f0
