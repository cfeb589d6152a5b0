"""Typed configuration for the PyTorch FastSpeech 2 port.

Reads the same three-YAML-per-dataset schema as the JAX package
(config/<ds>/{preprocess,model,train}.yaml) and flattens it, together with
the corpus stats.json / speakers.json, into immutable dataclasses.  Field
names and defaults are those of ``fastspeech2_tpu/configs/config.py`` so a
config built by either package describes the same model and training; the
kernel-selection and rematerialisation fields are left out (on CUDA the
port always runs its kernels).
"""

import dataclasses
import json
import os
import warnings
from typing import Sequence, Tuple

import yaml


def load_yaml_configs(preprocess_path, model_path, train_path):
    configs = []
    for path in (preprocess_path, model_path, train_path):
        with open(path) as f:
            configs.append(yaml.safe_load(f))
    return tuple(configs)


@dataclasses.dataclass(frozen=True)
class FastSpeech2Config:
    """Everything the acoustic model needs, statically."""

    # transformer
    vocab_size: int = 361
    encoder_layer: int = 4
    encoder_head: int = 2
    encoder_hidden: int = 256
    decoder_layer: int = 6
    decoder_head: int = 2
    decoder_hidden: int = 256
    conv_filter_size: int = 1024
    conv_kernel_size: Tuple[int, int] = (9, 1)
    encoder_dropout: float = 0.2
    decoder_dropout: float = 0.2
    # variance predictor
    vp_filter_size: int = 256
    vp_kernel_size: int = 3
    vp_dropout: float = 0.5
    # variance embedding
    pitch_quantization: str = "linear"   # 'linear' | 'log'
    energy_quantization: str = "linear"
    n_bins: int = 256
    pitch_min: float = 0.0
    pitch_max: float = 1.0
    energy_min: float = 0.0
    energy_max: float = 1.0
    pitch_feature_level: str = "phoneme_level"   # | 'frame_level'
    energy_feature_level: str = "phoneme_level"
    # postnet
    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_n_convolutions: int = 5
    # sizes
    n_mel_channels: int = 80
    max_seq_len: int = 1000
    multi_speaker: bool = False
    n_speaker: int = 1

    @classmethod
    def build(cls, preprocess_config, model_config):
        """Flatten reference-schema YAML dicts into a config; the
        pitch/energy ranges come from preprocessed_path/stats.json and the
        speaker count from speakers.json."""
        pp = preprocess_config["preprocessing"]
        tr = model_config["transformer"]
        vp = model_config["variance_predictor"]
        ve = model_config["variance_embedding"]
        pre_path = preprocess_config["path"]["preprocessed_path"]
        stats_path = os.path.join(pre_path, "stats.json")
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                stats = json.load(f)
        else:
            # unit-range bins are right for random weights only: the
            # variance adaptor bins pitch/energy against the corpus stats
            # the weights were trained with
            warnings.warn(
                f"stats.json not found under {pre_path!r}; using unit "
                "pitch/energy ranges. Synthesis from TRAINED weights will "
                "mis-bin pitch and energy.", stacklevel=2)
            stats = {"pitch": [0.0, 1.0], "energy": [0.0, 1.0]}
        multi = bool(model_config.get("multi_speaker", False))
        n_speaker = 1
        speakers_path = os.path.join(pre_path, "speakers.json")
        if multi and os.path.exists(speakers_path):
            with open(speakers_path) as f:
                n_speaker = len(json.load(f))
        postnet = model_config.get("postnet", {})
        return cls(
            encoder_layer=tr["encoder_layer"],
            encoder_head=tr["encoder_head"],
            encoder_hidden=tr["encoder_hidden"],
            decoder_layer=tr["decoder_layer"],
            decoder_head=tr["decoder_head"],
            decoder_hidden=tr["decoder_hidden"],
            conv_filter_size=tr["conv_filter_size"],
            conv_kernel_size=tuple(tr["conv_kernel_size"]),
            encoder_dropout=tr["encoder_dropout"],
            decoder_dropout=tr["decoder_dropout"],
            vp_filter_size=vp["filter_size"],
            vp_kernel_size=vp["kernel_size"],
            vp_dropout=vp["dropout"],
            pitch_quantization=ve["pitch_quantization"],
            energy_quantization=ve["energy_quantization"],
            n_bins=ve["n_bins"],
            pitch_min=float(stats["pitch"][0]),
            pitch_max=float(stats["pitch"][1]),
            energy_min=float(stats["energy"][0]),
            energy_max=float(stats["energy"][1]),
            pitch_feature_level=pp["pitch"]["feature"],
            energy_feature_level=pp["energy"]["feature"],
            n_mel_channels=pp["mel"]["n_mel_channels"],
            max_seq_len=model_config["max_seq_len"],
            multi_speaker=multi,
            n_speaker=n_speaker,
            postnet_embedding_dim=postnet.get("embedding_dim", 512),
            postnet_kernel_size=postnet.get("kernel_size", 5),
            postnet_n_convolutions=postnet.get("n_convolutions", 5),
        )


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Noam Adam settings (train.yaml ``optimizer`` block)."""

    batch_size: int = 16
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-9
    weight_decay: float = 0.0
    grad_clip_thresh: float = 1.0
    grad_acc_step: int = 1
    warm_up_step: int = 4000
    anneal_steps: Sequence[int] = (300000, 400000, 500000)
    anneal_rate: float = 0.3
    # "bfloat16" stores Adam's first moment in bfloat16; float32 by default
    mu_dtype: str = "float32"

    @classmethod
    def build(cls, train_config):
        o = train_config["optimizer"]
        return cls(
            batch_size=o["batch_size"],
            betas=tuple(o["betas"]),
            eps=float(o["eps"]),
            weight_decay=float(o.get("weight_decay", 0.0)),
            grad_clip_thresh=float(o["grad_clip_thresh"]),
            grad_acc_step=int(o.get("grad_acc_step", 1)),
            warm_up_step=int(o["warm_up_step"]),
            anneal_steps=tuple(o["anneal_steps"]),
            anneal_rate=float(o["anneal_rate"]),
            mu_dtype=str(o.get("mu_dtype", "float32")),
        )


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Duty periods (train.yaml ``step`` block)."""

    total_step: int = 900000
    log_step: int = 100
    synth_step: int = 1000
    val_step: int = 1000
    save_step: int = 100000

    @classmethod
    def build(cls, train_config):
        s = train_config["step"]
        return cls(
            total_step=s["total_step"],
            log_step=s["log_step"],
            synth_step=s["synth_step"],
            val_step=s["val_step"],
            save_step=s["save_step"],
        )
