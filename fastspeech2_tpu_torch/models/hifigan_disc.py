"""HiFi-GAN discriminators, MPD and MSD (port of
``fastspeech2_tpu/models/hifigan_disc.py``).

* MultiPeriodDiscriminator: one 2-D conv stack per period p in (2, 3, 5,
  7, 11).  The waveform is padded to a multiple of p and folded to
  [B, 1, T/p, p], so periodic structure lands on the last axis.  Every
  (5, 1) conv but the last has stride 3 on the folded time axis.
* MultiScaleDiscriminator: three grouped 1-D conv stacks on the waveform,
  average-pooled by 2 between scales (AvgPool1d(4, 2, padding 2),
  count_include_pad=True).

Each sub-discriminator returns (feature maps, score).  Leaky-ReLU slope
0.1.  As in the JAX package there is no weight or spectral norm
(``hifigan_disc.py:14-17``).  Tensors are channels-first: the feature
maps are [B, C, T'] (MSD) and [B, C, T', p] (MPD, T' the folded time
after its strides); a score is [B, n], flattened in (T', p) order as the
JAX package flattens its channels-last [B, T', p, 1].  Module names follow
the upstream HiFi-GAN trainer:
``mpd.discriminators.{i}.convs.{j}``, ``...conv_post``, and the
same under ``msd``.  The convolutions are cuDNN calls on the card: the JAX
package runs them through XLA, outside any Pallas kernel.
"""

import torch
from torch import nn
from torch.nn import functional as F

LRELU_SLOPE = 0.1
PERIOD_CHANNELS = (32, 128, 512, 1024, 1024)
# (channels, kernel, stride, groups) of each MSD conv before conv_post
SCALE_LAYERS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16),
                (512, 41, 4, 16), (1024, 41, 4, 16), (1024, 41, 1, 16),
                (1024, 5, 1, 1))


class PeriodDiscriminator(nn.Module):
    """One MPD branch: fold at ``period``, then a (5, 1) conv stack and a
    (3, 1) conv_post."""

    def __init__(self, period, channels=PERIOD_CHANNELS):
        super().__init__()
        self.period = period
        ins = (1,) + tuple(channels[:-1])
        self.convs = nn.ModuleList(
            nn.Conv2d(c_in, c_out, (5, 1),
                      stride=(1 if i == len(channels) - 1 else 3, 1),
                      padding=(2, 0))
            for i, (c_in, c_out) in enumerate(zip(ins, channels)))
        self.conv_post = nn.Conv2d(channels[-1], 1, (3, 1), padding=(1, 0))

    def forward(self, y):
        """y: [B, T] -> (fmaps, score [B, T' * p])."""
        b, t = y.shape
        p = self.period
        pad = (p - t % p) % p
        if pad:
            # the JAX branch appends y[:, t-pad:] reversed, which includes
            # the last sample (``hifigan_disc.py:41-43``); torch's reflect
            # pad would exclude it
            y = torch.cat([y, y[:, t - pad:].flip(1)], dim=1)
        x = y.reshape(b, 1, -1, p)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return fmap, x.reshape(b, -1)


class ScaleDiscriminator(nn.Module):
    """One MSD branch: grouped 1-D conv stack over the waveform."""

    def __init__(self, layers=SCALE_LAYERS):
        super().__init__()
        convs, c_in = [], 1
        for ch, k, s, g in layers:
            convs.append(nn.Conv1d(c_in, ch, k, stride=s, padding=k // 2,
                                   groups=g))
            c_in = ch
        self.convs = nn.ModuleList(convs)
        self.conv_post = nn.Conv1d(c_in, 1, 3, padding=1)

    def forward(self, y):
        """y: [B, T] -> (fmaps, score [B, T'])."""
        x = y[:, None, :]
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return fmap, x[:, 0]


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods=(2, 3, 5, 7, 11), channels=PERIOD_CHANNELS):
        super().__init__()
        self.discriminators = nn.ModuleList(
            PeriodDiscriminator(p, tuple(channels)) for p in periods)

    def forward(self, y):
        fmaps, scores = [], []
        for d in self.discriminators:
            f, s = d(y)
            fmaps.append(f)
            scores.append(s)
        return fmaps, scores


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, n_scales=3, layers=SCALE_LAYERS):
        super().__init__()
        self.discriminators = nn.ModuleList(
            ScaleDiscriminator(tuple(tuple(l) for l in layers))
            for _ in range(n_scales))

    def forward(self, y):
        fmaps, scores = [], []
        x = y
        for i, d in enumerate(self.discriminators):
            if i > 0:
                x = F.avg_pool1d(x[:, None], 4, 2, padding=2,
                                 count_include_pad=True)[:, 0]
            f, s = d(x)
            fmaps.append(f)
            scores.append(s)
        return fmaps, scores


class HiFiGANDiscriminators(nn.Module):
    """MPD + MSD: y [B, T] -> (the MPD's fmaps then the MSD's, their
    scores), as the JAX module's one apply returns them."""

    def __init__(self, periods=(2, 3, 5, 7, 11), n_scales=3,
                 period_channels=PERIOD_CHANNELS, scale_layers=SCALE_LAYERS):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(tuple(periods),
                                            tuple(period_channels))
        self.msd = MultiScaleDiscriminator(n_scales, scale_layers)

    def forward(self, y):
        fp, sp = self.mpd(y)
        fs, ss = self.msd(y)
        return fp + fs, sp + ss
