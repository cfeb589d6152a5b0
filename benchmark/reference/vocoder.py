"""The iSTFTNet generator (Kaneko et al., arXiv:2203.02395; HiFi-GAN's
generator with an inverse-STFT head, "C8C8I") in plain PyTorch, float32,
over a parameter dict in the HiFi-GAN state-dict names (conv_pre,
ups.{i}, resblocks.{i}.convs{1,2}.{j}, conv_post).

conv_pre -> per stage: leaky ReLU 0.1 -> transposed conv upsampling ->
the mean of the stage's MRF ResBlocks (ResBlock1: per dilation d,
x += conv_k(lrelu(conv_k,d(lrelu(x))))) -> leaky ReLU 0.01 -> conv_post ->
magnitude exp(clamp(., -20, 6)) and phase of an n_fft-point spectrum a
frame -> Hann-windowed overlap-add inverse STFT, normalised by the window's
sum of squares, (n_fft - hop) / 2 samples trimmed at each end.
"""

import numpy as np
import torch
from torch.nn import functional as F


def _istft(real, imag, n_fft, hop):
    dev = real.device
    k = np.arange(n_fft // 2 + 1)[:, None]
    t = np.arange(n_fft)[None, :]
    w = np.where((k == 0) | (k == n_fft // 2), 1.0, 2.0)
    ang = 2.0 * np.pi * k * t / n_fft
    c = torch.as_tensor(w * np.cos(ang) / n_fft, dtype=torch.float32,
                        device=dev)
    s = torch.as_tensor(-w * np.sin(ang) / n_fft, dtype=torch.float32,
                        device=dev)
    win = torch.as_tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft)
                                             / n_fft), dtype=torch.float32,
                          device=dev)
    frames = (real @ c + imag @ s) * win
    b, f, _ = frames.shape
    n = f * hop + n_fft - hop
    sig = torch.zeros(b, n, device=dev)
    wss = torch.zeros(n, device=dev)
    for j in range(n_fft // hop):
        for r in range(hop):
            sig[:, j * hop + r: j * hop + r + f * hop: hop] += \
                frames[:, :, j * hop + r]
            wss[j * hop + r: j * hop + r + f * hop: hop] += \
                win[j * hop + r] ** 2
    sig = sig / torch.where(wss > 1e-11, wss, torch.ones_like(wss))
    trim = (n_fft - hop) // 2
    return sig[:, trim: trim + f * hop]


def generate(params, cfg, mel):
    """mel [B, T, n_mels] -> float waveform [B, T * hop]; ``cfg`` is the
    generator's config (upsample rates and kernels, ResBlock kernels and
    dilations, iSTFT n_fft and hop)."""
    p = params

    def conv(x, name, dilation=1):
        w = p[name + ".weight"]
        k = w.shape[-1]
        return F.conv1d(x, w, p[name + ".bias"],
                        padding=(k * dilation - dilation) // 2,
                        dilation=dilation)

    x = conv(mel.transpose(1, 2), "conv_pre")
    kernels = cfg["resblock_kernel_sizes"]
    n = len(kernels)
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"],
                                   cfg["upsample_kernel_sizes"])):
        x = F.leaky_relu(x, 0.1)
        x = F.conv_transpose1d(x, p[f"ups.{i}.weight"],
                               p[f"ups.{i}.bias"], stride=u,
                               padding=(k - u) // 2)
        acc = None
        for j, dils in enumerate(cfg["resblock_dilation_sizes"]):
            r = f"resblocks.{i * n + j}"
            y = x
            for m, dil in enumerate(dils):
                t = conv(F.leaky_relu(y, 0.1), f"{r}.convs1.{m}", dil)
                y = y + conv(F.leaky_relu(t, 0.1), f"{r}.convs2.{m}")
            acc = y if acc is None else acc + y
        x = acc / n
    x = conv(F.leaky_relu(x, 0.01), "conv_post").transpose(1, 2)
    n_fft, hop = cfg["gen_istft_n_fft"], cfg["gen_istft_hop_size"]
    nb = n_fft // 2 + 1
    mag = torch.exp(torch.clamp(x[..., :nb], -20.0, 6.0))
    phase = x[..., nb:]
    return _istft(mag * torch.cos(phase), mag * torch.sin(phase), n_fft, hop)


def param_shapes(cfg, n_mels):
    """name -> shape of the generator's parameters (torch layouts)."""
    c = cfg["upsample_initial_channel"]
    out = {"conv_pre.weight": (c, n_mels, 7), "conv_pre.bias": (c,)}
    n = len(cfg["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"],
                                   cfg["upsample_kernel_sizes"])):
        out[f"ups.{i}.weight"] = (c, c // 2, k)
        out[f"ups.{i}.bias"] = (c // 2,)
        c //= 2
        for j, (rk, dils) in enumerate(zip(cfg["resblock_kernel_sizes"],
                                           cfg["resblock_dilation_sizes"])):
            for m in range(len(dils)):
                for conv in ("convs1", "convs2"):
                    name = f"resblocks.{i * n + j}.{conv}.{m}"
                    out[name + ".weight"] = (c, c, rk)
                    out[name + ".bias"] = (c,)
    nb = cfg["gen_istft_n_fft"] // 2 + 1
    out["conv_post.weight"] = (2 * nb, c, 7)
    out["conv_post.bias"] = (2 * nb,)
    return out


def init_params(cfg, n_mels, generator, device):
    """Fresh weights from ``generator`` in one call: N(0, 0.01) kernels,
    as HiFi-GAN initialises its convolutions, zero biases."""
    shapes = param_shapes(cfg, n_mels)
    sizes = {n: int(np.prod(s)) for n, s in shapes.items()}
    normal = torch.randn(sum(sizes.values()), generator=generator,
                         device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        chunk = normal[at:at + sizes[name]].view(shape)
        at += sizes[name]
        out[name] = ((chunk * 0.01).contiguous() if len(shape) > 1
                     else torch.zeros(shape, device=device))
    return out
