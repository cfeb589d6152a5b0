"""Weight snapshots of the JAX package -> the port's state_dicts.

The tracked weights under ``weights/`` are fp16 npz files whose keys are
the flattened Flax variable paths ("params/encoder/layer_0/...").  This
module reads them (numpy only) and maps the tree onto the port's module
names, which are the upstream PyTorch reference's state-dict names.  The
names and transposes follow ``fastspeech2_tpu/convert/to_torch.py``
(acoustic model and HiFi-GAN, the iSTFT variant included) and
``convert/from_torch.py::melgan_params_from_torch`` (MelGAN).  Everything
happens in memory; nothing converted is written to disk.

Reference ``.pth.tar`` state dicts carry the port's names already:
:func:`fastspeech2_from_torch_state_dict` (acoustic model) drops the
buffers the port derives from the config, and :func:`fold_weight_norm`
(HiFi-GAN, and MelGAN through :func:`melgan_from_torch_state_dict`) folds
weight norm as ``fastspeech2_tpu/convert/from_torch.py:159-183`` does.

Every array of the tree must be consumed by the map: an array left over
raises, and ``load_state_dict(strict=True)`` catches the opposite case.
"""

import numpy as np
import torch

_SEP = "/"


def load_variables_npz(path):
    """npz -> nested variables dict; float leaves cast to float32."""
    variables = {}
    with np.load(path) as data:
        for key in data.files:
            node = variables
            parts = key.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            a = data[key]
            node[parts[-1]] = (a.astype(np.float32)
                               if np.issubdtype(a.dtype, np.floating) else a)
    return variables


def _flatten(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}{_SEP}{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(_flatten(v, path))
        else:
            flat[path] = v
    return flat


class _Mapper:
    """Builds a state_dict from a flattened Flax tree, recording which
    arrays were used."""

    def __init__(self, tree):
        self.flat = _flatten(tree)
        self.used = set()
        self.sd = {}

    def has(self, path):
        return path in self.flat

    def get(self, path):
        self.used.add(path)
        return torch.from_numpy(np.array(self.flat[path], np.float32))

    def linear(self, name, path):
        self.sd[name + ".weight"] = self.get(path + "/kernel").T.contiguous()
        self.sd[name + ".bias"] = self.get(path + "/bias")

    def conv1d(self, name, path):
        # flax [k, in, out] -> torch Conv1d [out, in, k]
        self.sd[name + ".weight"] = (
            self.get(path + "/kernel").permute(2, 1, 0).contiguous())
        self.sd[name + ".bias"] = self.get(path + "/bias")

    def conv2d(self, name, path):
        # flax [kh, kw, in, out] -> torch Conv2d [out, in, kh, kw]
        self.sd[name + ".weight"] = (
            self.get(path + "/kernel").permute(3, 2, 0, 1).contiguous())
        self.sd[name + ".bias"] = self.get(path + "/bias")

    def conv_transpose1d(self, name, path):
        # flax ConvTranspose [k, in, out] holds the spatially flipped
        # kernel -> torch ConvTranspose1d [in, out, k]
        k = self.get(path + "/kernel")
        self.sd[name + ".weight"] = k.flip(0).permute(1, 2, 0).contiguous()
        self.sd[name + ".bias"] = self.get(path + "/bias")

    def layer_norm(self, name, path):
        self.sd[name + ".weight"] = self.get(path + "/scale")
        self.sd[name + ".bias"] = self.get(path + "/bias")

    def embedding(self, name, path):
        self.sd[name + ".weight"] = self.get(path + "/embedding")

    def finish(self):
        unused = sorted(set(self.flat) - self.used)
        if unused:
            raise ValueError(f"arrays not mapped to the port: {unused}")
        return self.sd


def _fft_block(m, name, path):
    for proj in ("w_qs", "w_ks", "w_vs", "fc"):
        m.linear(f"{name}.slf_attn.{proj}", f"{path}/slf_attn/{proj}/Dense_0")
    m.layer_norm(f"{name}.slf_attn.layer_norm",
                 f"{path}/slf_attn/TorchLayerNorm_0/LayerNorm_0")
    m.conv1d(f"{name}.pos_ffn.w_1", f"{path}/pos_ffn/w_1/Conv_0")
    m.conv1d(f"{name}.pos_ffn.w_2", f"{path}/pos_ffn/w_2/Conv_0")
    m.layer_norm(f"{name}.pos_ffn.layer_norm",
                 f"{path}/pos_ffn/TorchLayerNorm_0/LayerNorm_0")


def _variance_predictor(m, name, path):
    m.conv1d(f"{name}.conv_layer.conv1d_1.conv", f"{path}/conv1d_1/Conv_0")
    m.conv1d(f"{name}.conv_layer.conv1d_2.conv", f"{path}/conv1d_2/Conv_0")
    m.layer_norm(f"{name}.conv_layer.layer_norm_1",
                 f"{path}/TorchLayerNorm_0/LayerNorm_0")
    m.layer_norm(f"{name}.conv_layer.layer_norm_2",
                 f"{path}/TorchLayerNorm_1/LayerNorm_0")
    m.linear(f"{name}.linear_layer", f"{path}/linear_layer/Dense_0")


def from_jax_params(variables, cfg):
    """{"params": ..., "batch_stats": ...} (numpy leaves) -> the state_dict
    of ``fastspeech2_tpu_torch.models.FastSpeech2(cfg)``."""
    m = _Mapper(variables)
    m.embedding("encoder.src_word_emb", "params/encoder/src_word_emb")
    for i in range(cfg.encoder_layer):
        _fft_block(m, f"encoder.layer_stack.{i}",
                   f"params/encoder/layer_{i}")
    for name in ("duration", "pitch", "energy"):
        _variance_predictor(m, f"variance_adaptor.{name}_predictor",
                            f"params/variance_adaptor/{name}_predictor")
    for name in ("pitch", "energy"):
        m.embedding(f"variance_adaptor.{name}_embedding",
                    f"params/variance_adaptor/{name}_embedding")
    for i in range(cfg.decoder_layer):
        _fft_block(m, f"decoder.layer_stack.{i}",
                   f"params/decoder/layer_{i}")
    m.linear("mel_linear", "params/mel_linear/Dense_0")
    for i in range(cfg.postnet_n_convolutions):
        m.conv1d(f"postnet.convolutions.{i}.0.conv",
                 f"params/postnet/conv_{i}")
        bn = f"postnet.convolutions.{i}.1"
        m.sd[bn + ".weight"] = m.get(f"params/postnet/bn_{i}/scale")
        m.sd[bn + ".bias"] = m.get(f"params/postnet/bn_{i}/bias")
        n = m.sd[bn + ".weight"].shape[0]
        stats = f"batch_stats/postnet/bn_{i}"
        m.sd[bn + ".running_mean"] = (
            m.get(stats + "/mean") if m.has(stats + "/mean")
            else torch.zeros(n))
        m.sd[bn + ".running_var"] = (
            m.get(stats + "/var") if m.has(stats + "/var")
            else torch.ones(n))
        m.sd[bn + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    if cfg.multi_speaker:
        m.embedding("speaker_emb", "params/speaker_emb")
    return m.finish()


def hifigan_from_jax_params(variables, n_upsamples, n_resblock_kernels=3):
    """Flax HiFi-GAN generator variables ({"params": ...} or the bare
    params) -> the state_dict of the port's generator: conv_pre, ups.*,
    resblocks.*.convs{1,2}.*, conv_post."""
    tree = variables["params"] if "params" in variables else variables
    m = _Mapper(tree)
    m.conv1d("conv_pre", "conv_pre")
    m.conv1d("conv_post", "conv_post")
    for i in range(n_upsamples):
        m.conv_transpose1d(f"ups.{i}", f"up_{i}")
    for i in range(n_upsamples * n_resblock_kernels):
        j = 0
        while m.has(f"resblock_{i}/conv1_{j}/kernel"):
            m.conv1d(f"resblocks.{i}.convs1.{j}", f"resblock_{i}/conv1_{j}")
            m.conv1d(f"resblocks.{i}.convs2.{j}", f"resblock_{i}/conv2_{j}")
            j += 1
    return m.finish()


def discriminators_from_jax_params(variables, periods=(2, 3, 5, 7, 11)):
    """Flax ``HiFiGANDiscriminators`` variables ({"params": ...} or the
    bare params) -> the state_dict of
    ``models.hifigan_disc.HiFiGANDiscriminators(periods, ...)``: the MPD
    branch of ``periods[i]`` is ``mpd.discriminators.{i}``, each scale of
    the MSD ``msd.discriminators.{i}``; a grouped conv's [k, in/g, out]
    kernel becomes [out, in/g, k], the groups in the same order.  The layer
    and scale counts are read off the tree."""
    tree = variables["params"] if "params" in variables else variables
    m = _Mapper(tree)

    def stack(name, path, conv):
        j = 0
        while m.has(f"{path}/conv_{j}/kernel"):
            conv(f"{name}.convs.{j}", f"{path}/conv_{j}")
            j += 1
        conv(f"{name}.conv_post", f"{path}/conv_post")

    for i, p in enumerate(periods):
        stack(f"mpd.discriminators.{i}", f"mpd/period_{p}", m.conv2d)
    i = 0
    while m.has(f"msd/scale_{i}/conv_post/kernel"):
        stack(f"msd.discriminators.{i}", f"msd/scale_{i}", m.conv1d)
        i += 1
    return m.finish()


def melgan_from_jax_params(variables):
    """Flax MelGAN generator variables ({"params": ...} or the bare params)
    -> the state_dict of ``models.melgan.MelGANGenerator``: the
    melgan-neurips ``model.<idx>`` names that
    ``convert/from_torch.py::melgan_params_from_torch`` reads (pad and
    conv_pre, then per stage [leaky_relu, conv_transpose, ResnetBlocks],
    then leaky_relu, pad and conv_post).  The stage and residual-block
    counts are read off the tree."""
    tree = variables["params"] if "params" in variables else variables
    m = _Mapper(tree)
    n_stages = n_res = 0
    while m.has(f"up_{n_stages}/kernel"):
        n_stages += 1
    while m.has(f"res_0_{n_res}/shortcut/kernel"):
        n_res += 1
    m.conv1d("model.1", "conv_pre")
    idx = 2
    for i in range(n_stages):
        m.conv_transpose1d(f"model.{idx + 1}", f"up_{i}")
        idx += 2                            # leaky_relu, conv_transpose
        for j in range(n_res):
            path = f"res_{i}_{j}"
            m.conv1d(f"model.{idx}.block.2", f"{path}/conv_dilated")
            m.conv1d(f"model.{idx}.block.4", f"{path}/conv_1x1")
            m.conv1d(f"model.{idx}.shortcut", f"{path}/shortcut")
            idx += 1
    m.conv1d(f"model.{idx + 2}", "conv_post")   # after leaky_relu, pad
    return m.finish()


def fold_weight_norm(state_dict):
    """A reference generator state_dict (HiFi-GAN, MelGAN) with weight norm
    -> plain ``.weight`` keys: weight = g * v / ||v||, the norm over every
    axis but 0, as remove_weight_norm() gives at load (reference
    utils/model.py:68); keys whose weight norm was already removed (plain
    ``.weight``) pass through."""
    sd = {}
    for key, value in state_dict.items():
        value = torch.as_tensor(value, dtype=torch.float32)
        if key.endswith(".weight_v"):
            continue
        if key.endswith(".weight_g"):
            prefix = key[:-len(".weight_g")]
            v = torch.as_tensor(state_dict[prefix + ".weight_v"],
                                dtype=torch.float32)
            axes = tuple(range(1, v.dim()))
            norm = torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))
            sd[prefix + ".weight"] = value * v / norm
        else:
            sd[key] = value
    return sd


def melgan_from_torch_state_dict(state_dict):
    """A melgan-neurips checkpoint -> the port's MelGAN state_dict: the
    generator of a training checkpoint (``model_g``, or ``generator`` in
    the port's own vocoder checkpoints and lean exports) when present, the
    ``mel2wav.`` prefix stripped (as ``fastspeech2_tpu/synthesis/
    vocoder.py:114-115`` and ``convert/from_torch.py:199`` do), weight norm
    folded."""
    for key in ("model_g", "generator"):
        if key in state_dict:
            state_dict = state_dict[key]
            break
    return fold_weight_norm({k.split("mel2wav.")[-1]: v
                             for k, v in state_dict.items()})


# buffers the reference registers that the port derives from the config
_REGENERATED = ("encoder.position_enc", "decoder.position_enc",
                "variance_adaptor.pitch_bins", "variance_adaptor.energy_bins")


def fastspeech2_from_torch_state_dict(state_dict, cfg):
    """A reference FastSpeech2 state_dict (``ckpt["model"]`` of a reference
    ``.pth.tar``) -> the port's, which has the same names.  What
    ``convert/from_torch.py:109-156`` treats specially is mapped: the
    position tables and pitch/energy bins, which the port derives from the
    config, are dropped; ``speaker_emb`` is read for a multi-speaker config
    only; a PostNet BatchNorm saved without ``num_batches_tracked`` gets 0.
    Anything else that does not match fails the strict load."""
    sd = {}
    for key, value in state_dict.items():
        if key not in _REGENERATED:
            value = torch.as_tensor(value)
            sd[key] = value.float() if value.is_floating_point() else value
    if not cfg.multi_speaker:
        sd.pop("speaker_emb.weight", None)
    for i in range(cfg.postnet_n_convolutions):
        sd.setdefault(f"postnet.convolutions.{i}.1.num_batches_tracked",
                      torch.zeros((), dtype=torch.long))
    return sd
