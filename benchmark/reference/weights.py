"""Trained weights, read from the tracked fp16 npz snapshots (flattened
Flax variable paths such as ``params/encoder/layer_0/slf_attn/w_qs/
Dense_0/kernel``), into the reference's parameter dicts (the upstream
PyTorch state-dict names and layouts).  numpy and torch only.

Layouts: a Dense kernel [in, out] is transposed; a Conv kernel [k, in, out]
becomes [out, in, k]; a ConvTranspose kernel [k, in, out] holds the
spatially flipped kernel and becomes [in, out, k] flipped back.
"""

import numpy as np
import torch


def _read(path):
    with np.load(path) as z:
        return {k: z[k].astype(np.float32) for k in z.files}


class _Map:
    def __init__(self, flat, device):
        self.flat = flat
        self.device = device
        self.used = set()
        self.out = {}

    def get(self, path):
        self.used.add(path)
        return torch.as_tensor(self.flat[path], device=self.device)

    def dense(self, name, path):
        self.out[name + ".weight"] = self.get(path + "/kernel").t().contiguous()
        self.out[name + ".bias"] = self.get(path + "/bias")

    def conv(self, name, path):
        self.out[name + ".weight"] = (self.get(path + "/kernel")
                                      .permute(2, 1, 0).contiguous())
        self.out[name + ".bias"] = self.get(path + "/bias")

    def conv_t(self, name, path):
        self.out[name + ".weight"] = (self.get(path + "/kernel").flip(0)
                                      .permute(1, 2, 0).contiguous())
        self.out[name + ".bias"] = self.get(path + "/bias")

    def norm(self, name, path):
        self.out[name + ".weight"] = self.get(path + "/scale")
        self.out[name + ".bias"] = self.get(path + "/bias")

    def done(self):
        left = sorted(set(self.flat) - self.used)
        if left:
            raise ValueError(f"arrays left unread: {left[:5]}")
        return self.out


def acoustic(path, cfg, device):
    m = _Map(_read(path), device)
    m.out["encoder.src_word_emb.weight"] = m.get(
        "params/encoder/src_word_emb/embedding")

    def block(name, src):
        for proj in ("w_qs", "w_ks", "w_vs", "fc"):
            m.dense(f"{name}.slf_attn.{proj}", f"{src}/slf_attn/{proj}/Dense_0")
        m.norm(f"{name}.slf_attn.layer_norm",
               f"{src}/slf_attn/TorchLayerNorm_0/LayerNorm_0")
        m.conv(f"{name}.pos_ffn.w_1", f"{src}/pos_ffn/w_1/Conv_0")
        m.conv(f"{name}.pos_ffn.w_2", f"{src}/pos_ffn/w_2/Conv_0")
        m.norm(f"{name}.pos_ffn.layer_norm",
               f"{src}/pos_ffn/TorchLayerNorm_0/LayerNorm_0")

    for i in range(cfg["encoder_layer"]):
        block(f"encoder.layer_stack.{i}", f"params/encoder/layer_{i}")
    for i in range(cfg["decoder_layer"]):
        block(f"decoder.layer_stack.{i}", f"params/decoder/layer_{i}")
    for v in ("duration", "pitch", "energy"):
        name = f"variance_adaptor.{v}_predictor"
        src = f"params/variance_adaptor/{v}_predictor"
        m.conv(f"{name}.conv_layer.conv1d_1.conv", f"{src}/conv1d_1/Conv_0")
        m.conv(f"{name}.conv_layer.conv1d_2.conv", f"{src}/conv1d_2/Conv_0")
        m.norm(f"{name}.conv_layer.layer_norm_1",
               f"{src}/TorchLayerNorm_0/LayerNorm_0")
        m.norm(f"{name}.conv_layer.layer_norm_2",
               f"{src}/TorchLayerNorm_1/LayerNorm_0")
        m.dense(f"{name}.linear_layer", f"{src}/linear_layer/Dense_0")
    for v in ("pitch", "energy"):
        m.out[f"variance_adaptor.{v}_embedding.weight"] = m.get(
            f"params/variance_adaptor/{v}_embedding/embedding")
    m.dense("mel_linear", "params/mel_linear/Dense_0")
    for i in range(cfg["postnet_n_convolutions"]):
        m.conv(f"postnet.convolutions.{i}.0.conv", f"params/postnet/conv_{i}")
        bn = f"postnet.convolutions.{i}.1"
        m.norm(bn, f"params/postnet/bn_{i}")
        m.out[bn + ".running_mean"] = m.get(f"batch_stats/postnet/bn_{i}/mean")
        m.out[bn + ".running_var"] = m.get(f"batch_stats/postnet/bn_{i}/var")
    return m.done()


def vocoder(path, cfg, device):
    flat = {k[len("params/"):] if k.startswith("params/") else k: v
            for k, v in _read(path).items()}
    m = _Map(flat, device)
    m.conv("conv_pre", "conv_pre")
    m.conv("conv_post", "conv_post")
    n = len(cfg["resblock_kernel_sizes"])
    for i in range(len(cfg["upsample_rates"])):
        m.conv_t(f"ups.{i}", f"up_{i}")
        for j, dils in enumerate(cfg["resblock_dilation_sizes"]):
            r = i * n + j
            for u in range(len(dils)):
                m.conv(f"resblocks.{r}.convs1.{u}", f"resblock_{r}/conv1_{u}")
                m.conv(f"resblocks.{r}.convs2.{u}", f"resblock_{r}/conv2_{u}")
    return m.done()
