"""FastSpeech 2 (Ren et al., arXiv:2006.04558) in plain PyTorch, float32,
as a function of a parameter dict named as the upstream PyTorch reference
(ming024/FastSpeech2) names its state dict.

The arithmetic follows the published model and the reference code:
post-LN FFT blocks (masked softmax attention, conv(k0) -> ReLU -> conv(k1)
feed-forward), the variance adaptor (duration, pitch, energy predictors of
two conv -> ReLU -> LayerNorm -> dropout layers and a linear head; pitch
and energy bucketized with searchsorted(side="left") against linear bins;
durations rounded, then clamped at 0), the length regulator, the mel
linear and a 5-layer PostNet of conv + BatchNorm whose frames past the
batch's longest mel are zero.  Its departures from the reference, shared
with the system under test: padded keys take -1e9 (not -inf), LayerNorm's
variance is E[x^2] - E[x]^2, BatchNorm in training mode takes its
statistics over the frames below the batch's longest mel only.

Dropout draws ``torch.rand(shape, generator=g) < keep`` once per dropout
site in forward order (encoder blocks: attention then feed-forward;
duration, pitch, energy predictors: two each; decoder blocks; the five
PostNet layers), so a generator seeded as a training step seeds its own
gives the step's masks.

``quant`` rounds both operands of every product (linear, convolution,
attention) before the float32 product: identity for the reference; the
controls pass a lower precision's rounding.
"""

import numpy as np
import torch
from torch.nn import functional as F

NEG_INF = -1e9
DURATION_BIAS = float(np.log(4.5))


def identity(t):
    return t


def sinusoid_table(n, d, device):
    pos = np.arange(n)[:, None]
    j = np.arange(d)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (j // 2) / d)
    table = np.zeros((n, d), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.as_tensor(table, dtype=torch.float32, device=device)


def bins(vmin, vmax, n_bins, device):
    return torch.as_tensor(np.linspace(vmin, vmax, n_bins - 1),
                           dtype=torch.float32, device=device)


class Model:
    """The forward pass over ``params`` (name -> float32 tensor) for the
    configuration ``cfg`` (a dict: widths, depths, dropout rates, the
    pitch/energy ranges)."""

    def __init__(self, params, cfg, quant=identity):
        self.p = params
        self.cfg = cfg
        self.q = quant
        self.gen = None
        self.train = False

    # -- building blocks --------------------------------------------------

    def linear(self, x, name):
        return (self.q(x) @ self.q(self.p[name + ".weight"]).t()
                + self.p[name + ".bias"])

    def conv(self, x, weight, bias, padding, dilation=1):
        """x [B, L, C] with a torch Conv1d weight [out, in, k]."""
        y = F.conv1d(self.q(x).transpose(1, 2), self.q(weight), bias,
                     padding=padding, dilation=dilation)
        return y.transpose(1, 2)

    def layer_norm(self, x, name):
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        return ((x - mean) * (torch.rsqrt(var + 1e-5)
                              * self.p[name + ".weight"])
                + self.p[name + ".bias"])

    def dropout(self, x, rate):
        if not self.train or rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=self.gen, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def attention(self, x, pad, name, n_head, rate):
        b, l, d = x.shape
        dh = d // n_head

        def heads(proj):
            y = self.linear(x, f"{name}.{proj}")
            return y.view(b, l, n_head, dh).transpose(1, 2)

        q, k, v = heads("w_qs"), heads("w_ks"), heads("w_vs")
        s = (self.q(q) @ self.q(k).transpose(-1, -2)) / (dh ** 0.5)
        s = s.masked_fill(pad[:, None, None, :], NEG_INF)
        a = torch.softmax(s, dim=-1)
        o = (self.q(a) @ self.q(v)).transpose(1, 2).reshape(b, l, d)
        o = self.linear(o, f"{name}.fc")
        return self.layer_norm(self.dropout(o, rate) + x,
                               f"{name}.layer_norm")

    def ffn(self, x, name, rate):
        k1, k2 = self.cfg["conv_kernel_size"]
        y = torch.relu(self.conv(x, self.p[f"{name}.w_1.weight"],
                                 self.p[f"{name}.w_1.bias"], (k1 - 1) // 2))
        y = self.conv(y, self.p[f"{name}.w_2.weight"],
                      self.p[f"{name}.w_2.bias"], (k2 - 1) // 2)
        return self.layer_norm(self.dropout(y, rate) + x,
                               f"{name}.layer_norm")

    def blocks(self, x, pad, stack, n_layers, n_head, rate):
        keep = (~pad)[..., None].to(x.dtype)
        for i in range(n_layers):
            name = f"{stack}.layer_stack.{i}"
            x = self.attention(x, pad, f"{name}.slf_attn", n_head, rate) * keep
            x = self.ffn(x, f"{name}.pos_ffn", rate) * keep
        return x

    def predictor(self, x, pad, name):
        rate = self.cfg["vp_dropout"]
        k = self.cfg["vp_kernel_size"]
        for j in (1, 2):
            c = f"{name}.conv_layer.conv1d_{j}.conv"
            x = torch.relu(self.conv(x, self.p[c + ".weight"],
                                     self.p[c + ".bias"], (k - 1) // 2))
            x = self.layer_norm(x, f"{name}.conv_layer.layer_norm_{j}")
            x = self.dropout(x, rate)
        y = self.linear(x, f"{name}.linear_layer").squeeze(-1)
        return y.masked_fill(pad, 0.0)

    def postnet(self, mel, beyond):
        """mel [B, T, n_mels]; beyond [B, T] True past the batch's longest
        mel -> the PostNet's residual."""
        n = self.cfg["postnet_n_convolutions"]
        k = self.cfg["postnet_kernel_size"]
        keep = (~beyond)[..., None].to(mel.dtype)
        x = mel
        for i in range(n):
            x = x * keep
            c = f"postnet.convolutions.{i}.0.conv"
            x = self.conv(x, self.p[c + ".weight"], self.p[c + ".bias"],
                          (k - 1) // 2)
            bn = f"postnet.convolutions.{i}.1"
            if self.train:
                cnt = torch.clamp(keep.sum(), min=1.0)
                mean = (x * keep).sum(dim=(0, 1)) / cnt
                var = torch.clamp((x * x * keep).sum(dim=(0, 1)) / cnt
                                  - mean * mean, min=0.0)
            else:
                mean = self.p[bn + ".running_mean"]
                var = self.p[bn + ".running_var"]
            x = ((x - mean) * torch.rsqrt(var + 1e-5) * self.p[bn + ".weight"]
                 + self.p[bn + ".bias"])
            if i != n - 1:
                x = torch.tanh(x)
            x = self.dropout(x, 0.5)
        return x

    # -- the forward pass -------------------------------------------------

    def forward(self, texts, src_lens, max_mel_len, d_targets, p_targets,
                e_targets, mel_lens=None, truncate=True):
        """Teacher-forced on durations and pitch/energy buckets (the
        values are bucketized here) -> dict of log_duration, pitch,
        energy (the predictions), mel, postnet_mel, mel_len, the masks.
        ``mel_lens`` None: mel lengths are the durations' sums.
        ``truncate``: the decoder cut to max_seq_len frames, as in
        training; inference past it runs uncut."""
        cfg, dev = self.cfg, texts.device
        B, P = texts.shape
        src_pad = torch.arange(P, device=dev)[None, :] >= src_lens[:, None]
        d = cfg["encoder_hidden"]
        x = (self.p["encoder.src_word_emb.weight"][texts]
             + sinusoid_table(P, d, dev)[None])
        x = self.blocks(x, src_pad, "encoder", cfg["encoder_layer"],
                        cfg["encoder_head"], cfg["encoder_dropout"])
        va = "variance_adaptor"
        log_d = self.predictor(x, src_pad, f"{va}.duration_predictor")
        pitch = self.predictor(x, src_pad, f"{va}.pitch_predictor")
        pb = bins(cfg["pitch_min"], cfg["pitch_max"], cfg["n_bins"], dev)
        x = x + self.p[f"{va}.pitch_embedding.weight"][
            torch.searchsorted(pb, p_targets.float().contiguous())]
        energy = self.predictor(x, src_pad, f"{va}.energy_predictor")
        eb = bins(cfg["energy_min"], cfg["energy_max"], cfg["n_bins"], dev)
        x = x + self.p[f"{va}.energy_embedding.weight"][
            torch.searchsorted(eb, e_targets.float().contiguous())]
        dur = d_targets.long().masked_fill(src_pad, 0)
        T = max_mel_len
        cum = torch.cumsum(dur, dim=1)
        total = cum[:, -1] if mel_lens is None else mel_lens.long()
        mel_len = torch.clamp(total, max=T)
        frames = torch.arange(T, device=dev)[None, :].expand(B, -1)
        idx = torch.clamp(torch.searchsorted(cum, frames.contiguous(),
                                             right=True), max=P - 1)
        x = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, d))
        mel_pad = frames >= mel_len[:, None]
        x = x * (~mel_pad)[..., None].to(x.dtype)
        Tc = min(T, cfg["max_seq_len"]) if truncate else T
        x, mel_pad = x[:, :Tc], mel_pad[:, :Tc]
        x = x + sinusoid_table(Tc, cfg["decoder_hidden"], dev)[None]
        x = self.blocks(x, mel_pad, "decoder", cfg["decoder_layer"],
                        cfg["decoder_head"], cfg["decoder_dropout"])
        mel = self.linear(x, "mel_linear")
        beyond = (torch.arange(Tc, device=dev)[None, :]
                  >= mel_len.max()).expand(B, -1)
        postnet_mel = mel + self.postnet(mel, beyond)
        return {"log_duration": log_d, "pitch": pitch, "energy": energy,
                "mel": mel, "postnet_mel": postnet_mel, "mel_len": mel_len,
                "src_pad": src_pad, "mel_pad": mel_pad}


def masked_mean(values, keep):
    keep = keep.to(values.dtype)
    return (values * keep).sum() / torch.clamp(keep.sum(), min=1.0)


def losses(out, mels, pitches, energies, durations):
    """The six training losses (total, mel L1, postnet L1, pitch MSE,
    energy MSE, log-duration MSE against log(d + 1)), phone-level pitch
    and energy."""
    src_keep, mel_keep = ~out["src_pad"], ~out["mel_pad"]
    t = out["mel"].shape[1]
    mels = mels[:, :t].float()
    pitch = masked_mean((out["pitch"] - pitches) ** 2, src_keep)
    energy = masked_mean((out["energy"] - energies) ** 2, src_keep)
    dur = masked_mean((out["log_duration"]
                       - torch.log(durations.float() + 1.0)) ** 2, src_keep)
    keep3 = mel_keep[:, :, None].expand_as(mels)
    mel = masked_mean((out["mel"] - mels).abs(), keep3)
    post = masked_mean((out["postnet_mel"] - mels).abs(), keep3)
    total = mel + post + dur + pitch + energy
    return torch.stack([total, mel, post, pitch, energy, dur])


def param_shapes(cfg):
    """name -> shape of every trainable parameter and BatchNorm buffer,
    in the upstream reference's state-dict names."""
    d, f = cfg["encoder_hidden"], cfg["conv_filter_size"]
    k1, k2 = cfg["conv_kernel_size"]
    out = {"encoder.src_word_emb.weight": (cfg["vocab_size"], d)}

    def block(name, dm):
        for proj in ("w_qs", "w_ks", "w_vs", "fc"):
            out[f"{name}.slf_attn.{proj}.weight"] = (dm, dm)
            out[f"{name}.slf_attn.{proj}.bias"] = (dm,)
        out[f"{name}.slf_attn.layer_norm.weight"] = (dm,)
        out[f"{name}.slf_attn.layer_norm.bias"] = (dm,)
        out[f"{name}.pos_ffn.w_1.weight"] = (f, dm, k1)
        out[f"{name}.pos_ffn.w_1.bias"] = (f,)
        out[f"{name}.pos_ffn.w_2.weight"] = (dm, f, k2)
        out[f"{name}.pos_ffn.w_2.bias"] = (dm,)
        out[f"{name}.pos_ffn.layer_norm.weight"] = (dm,)
        out[f"{name}.pos_ffn.layer_norm.bias"] = (dm,)

    for i in range(cfg["encoder_layer"]):
        block(f"encoder.layer_stack.{i}", d)
    vf, vk = cfg["vp_filter_size"], cfg["vp_kernel_size"]
    for v in ("duration", "pitch", "energy"):
        name = f"variance_adaptor.{v}_predictor"
        out[f"{name}.conv_layer.conv1d_1.conv.weight"] = (vf, d, vk)
        out[f"{name}.conv_layer.conv1d_1.conv.bias"] = (vf,)
        out[f"{name}.conv_layer.layer_norm_1.weight"] = (vf,)
        out[f"{name}.conv_layer.layer_norm_1.bias"] = (vf,)
        out[f"{name}.conv_layer.conv1d_2.conv.weight"] = (vf, vf, vk)
        out[f"{name}.conv_layer.conv1d_2.conv.bias"] = (vf,)
        out[f"{name}.conv_layer.layer_norm_2.weight"] = (vf,)
        out[f"{name}.conv_layer.layer_norm_2.bias"] = (vf,)
        out[f"{name}.linear_layer.weight"] = (1, vf)
        out[f"{name}.linear_layer.bias"] = (1,)
    for v in ("pitch", "energy"):
        out[f"variance_adaptor.{v}_embedding.weight"] = (cfg["n_bins"], d)
    for i in range(cfg["decoder_layer"]):
        block(f"decoder.layer_stack.{i}", cfg["decoder_hidden"])
    n_mels = cfg["n_mel_channels"]
    out["mel_linear.weight"] = (n_mels, cfg["decoder_hidden"])
    out["mel_linear.bias"] = (n_mels,)
    e, k = cfg["postnet_embedding_dim"], cfg["postnet_kernel_size"]
    n = cfg["postnet_n_convolutions"]
    for i in range(n):
        c_in = n_mels if i == 0 else e
        c_out = n_mels if i == n - 1 else e
        out[f"postnet.convolutions.{i}.0.conv.weight"] = (c_out, c_in, k)
        out[f"postnet.convolutions.{i}.0.conv.bias"] = (c_out,)
        for b in ("weight", "bias", "running_mean", "running_var"):
            out[f"postnet.convolutions.{i}.1.{b}"] = (c_out,)
    return out


def is_buffer(name):
    return name.endswith(("running_mean", "running_var"))


def init_params(cfg, generator, device):
    """Fresh weights drawn from ``generator`` (on ``device``) in one call:
    matrices and kernels N(0, 1) / sqrt(fan-in), embeddings N(0, 1) with
    the padding row 0, LayerNorm and BatchNorm scales 1, biases 0 but the
    duration head's (log 4.5: about 3.5 frames a phone), running mean 0
    and variance 1."""
    shapes = param_shapes(cfg)
    sizes = {n: int(np.prod(s)) for n, s in shapes.items()}
    normal = torch.randn(sum(sizes.values()), generator=generator,
                         device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        chunk = normal[at:at + sizes[name]].view(shape)
        at += sizes[name]
        if "emb" in name:
            t = chunk.clone()
            if name == "encoder.src_word_emb.weight":
                t[0] = 0.0
        elif len(shape) >= 2:
            t = chunk / float(np.prod(shape[1:])) ** 0.5
        elif name == "variance_adaptor.duration_predictor.linear_layer.bias":
            # fresh weights then give phones of some frames, not none
            t = torch.full(shape, DURATION_BIAS, device=device)
        elif name.endswith("running_var") or (
                name.endswith(".weight") and ("norm" in name
                                              or ".1.weight" in name)):
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        out[name] = t.contiguous()
    return out
