"""MelGAN generator (port of ``fastspeech2_tpu/models/melgan.py``).

The reference pulls this model from torch.hub "descriptinc/melgan-neurips"
(utils/model.py:46-56): a reflection-padded conv stem, 4 transposed-conv
upsample stages (rates 8, 8, 2, 2, kernel 2r), each followed by 3 dilated
residual blocks (dilations 3^j), leaky_relu(0.2) activations and a tanh
output conv.  Full width is ngf 32: 512 -> 256 -> 128 -> 64 -> 32
channels (``configs/hifigan/config_melgan.json`` of the JAX package).

Module names are melgan-neurips' ``Generator``: one ``nn.Sequential``
named ``model`` (pad, conv, then per stage [leaky_relu, conv_transpose,
ResnetBlocks], then leaky_relu, pad, conv, tanh), each ResnetBlock's
``block.2`` (dilated conv), ``block.4`` (1x1 conv) and ``shortcut``.  The
reference divides the log-e mel by ln 10 before the network
(utils/model.py:78); that belongs to the caller (``MelGANVocoder``).
"""

from torch import nn


class ResnetBlock(nn.Module):
    def __init__(self, dim, dilation):
        super().__init__()
        self.block = nn.Sequential(
            nn.LeakyReLU(0.2),
            nn.ReflectionPad1d(dilation),
            nn.Conv1d(dim, dim, 3, dilation=dilation),
            nn.LeakyReLU(0.2),
            nn.Conv1d(dim, dim, 1))
        self.shortcut = nn.Conv1d(dim, dim, 1)

    def forward(self, x):
        return self.shortcut(x) + self.block(x)


class MelGANGenerator(nn.Module):
    def __init__(self, upsample_rates=(8, 8, 2, 2), ngf=32,
                 n_residual_layers=3, n_mel_channels=80):
        super().__init__()
        self.n_mel_channels = n_mel_channels
        mult = 2 ** len(upsample_rates)
        layers = [nn.ReflectionPad1d(3),
                  nn.Conv1d(n_mel_channels, mult * ngf, 7)]
        for r in upsample_rates:
            ch = mult * ngf // 2
            # padding r//2 + r%2 and output_padding r%2: exactly T*r frames,
            # the JAX package's crop of its VALID transposed conv
            layers += [nn.LeakyReLU(0.2),
                       nn.ConvTranspose1d(mult * ngf, ch, 2 * r, stride=r,
                                          padding=r // 2 + r % 2,
                                          output_padding=r % 2)]
            layers += [ResnetBlock(ch, 3 ** j)
                       for j in range(n_residual_layers)]
            mult //= 2
        layers += [nn.LeakyReLU(0.2), nn.ReflectionPad1d(3),
                   nn.Conv1d(ngf, 1, 7), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, mel):
        """mel: [B, T, n_mels] -> wav [B, T * prod(rates)]."""
        return self.model(mel.transpose(1, 2))[:, 0]
