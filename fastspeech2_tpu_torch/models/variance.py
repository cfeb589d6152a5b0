"""Variance adaptor: duration/pitch/energy predictors + length regulation
(port of ``fastspeech2_tpu/models/variance.py``).

Kept exactly as the JAX package has it:

* durations are rounded FIRST, then scaled by d_control, clamped at 0 and
  floored; padded phones get 0 (variance.py:152-167);
* pitch/energy bucketize with searchsorted(side="left") (:100, :110);
* the energy branch honours e_control (the reference passes p_control
  there, model/modules.py:124,146; the JAX package fixes that, :8-11).

At the compute dtype (models/common.py) the predictors run at the
activations' dtype, the embeddings are cast to it, and the bucketize and
the duration rounding read their values in float32 (:100, :110,
:152-168).
"""

import numpy as np
import torch
from torch import nn

from fastspeech2_tpu_torch.models.common import (
    Conv,
    Dropout,
    LayerNorm,
    Linear,
)
from fastspeech2_tpu_torch.ops.length_regulator import length_regulate
from fastspeech2_tpu_torch.ops.masking import (
    fill_masked,
    pad_mask_from_lengths,
)


class _ConvLayer(nn.Module):
    """Holds the predictor's convs under the reference's names
    (variance_predictor.conv_layer.{conv1d_1,layer_norm_1,dropout_1,...})."""

    def __init__(self, d_in, filter_size, kernel_size, dropout):
        super().__init__()
        self.conv1d_1 = Conv(d_in, filter_size, kernel_size)
        self.layer_norm_1 = LayerNorm(filter_size)
        self.dropout_1 = Dropout(dropout)
        self.conv1d_2 = Conv(filter_size, filter_size, kernel_size)
        self.layer_norm_2 = LayerNorm(filter_size)
        self.dropout_2 = Dropout(dropout)

    def forward(self, x):
        y = self.dropout_1(self.layer_norm_1(torch.relu(self.conv1d_1(x))))
        return self.dropout_2(self.layer_norm_2(torch.relu(self.conv1d_2(y))))


class VariancePredictor(nn.Module):
    """(conv -> ReLU -> LN -> dropout) x 2 -> linear -> squeeze; padded
    entries = 0 (reference model/modules.py:197-250; JAX package
    models/variance.py:29-57)."""

    def __init__(self, d_in, filter_size, kernel_size, dropout):
        super().__init__()
        self.conv_layer = _ConvLayer(d_in, filter_size, kernel_size, dropout)
        self.linear_layer = Linear(filter_size, 1)

    def forward(self, x, pad_mask):
        y = self.linear_layer(self.conv_layer(x)).squeeze(-1)
        return fill_masked(y, pad_mask)


def _make_bins(vmin, vmax, n_bins, quantization):
    if quantization == "log":
        edges = np.exp(np.linspace(np.log(vmin), np.log(vmax), n_bins - 1))
    else:
        edges = np.linspace(vmin, vmax, n_bins - 1)
    return torch.as_tensor(edges, dtype=torch.float32)


class VarianceAdaptor(nn.Module):
    """Reference model/modules.py:17-158 with gather length regulation."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        d, f, k = cfg.encoder_hidden, cfg.vp_filter_size, cfg.vp_kernel_size
        self.duration_predictor = VariancePredictor(d, f, k, cfg.vp_dropout)
        self.pitch_predictor = VariancePredictor(d, f, k, cfg.vp_dropout)
        self.energy_predictor = VariancePredictor(d, f, k, cfg.vp_dropout)
        self.register_buffer("pitch_bins", _make_bins(
            cfg.pitch_min, cfg.pitch_max, cfg.n_bins,
            cfg.pitch_quantization), persistent=False)
        self.register_buffer("energy_bins", _make_bins(
            cfg.energy_min, cfg.energy_max, cfg.n_bins,
            cfg.energy_quantization), persistent=False)
        self.pitch_embedding = nn.Embedding(cfg.n_bins, d)
        self.energy_embedding = nn.Embedding(cfg.n_bins, d)

    @staticmethod
    def _variance_embedding(predictor, embed, bins, x, target, pad_mask,
                            control, offset):
        prediction = predictor(x, pad_mask)
        if target is not None:
            ids = torch.searchsorted(bins, target.float().contiguous())
        else:
            # control scales the predicted (normalized) variance like the
            # reference; offset (default 0) lets callers express absolute
            # control on z-scored features (synthesis/pipeline.py).  A
            # float32 tensor control (the fused dispatch's) promotes a
            # bfloat16 prediction to float32, as the JAX pipeline's
            # jnp.float32 scalars do
            if torch.is_tensor(control):
                prediction = prediction.to(
                    torch.promote_types(prediction.dtype, control.dtype))
            prediction = prediction * control + offset
            ids = torch.searchsorted(bins, prediction.float().contiguous())
        return prediction, embed(ids).to(x.dtype)

    def forward(self, x, src_pad_mask, mel_pad_mask=None, max_mel_len=None,
                pitch_target=None, energy_target=None, duration_target=None,
                p_control=1.0, e_control=1.0, d_control=1.0, p_offset=0.0,
                e_offset=0.0):
        cfg = self.cfg
        log_duration_prediction = self.duration_predictor(x, src_pad_mask)

        pitch_prediction = energy_prediction = None
        if cfg.pitch_feature_level == "phoneme_level":
            pitch_prediction, emb = self._variance_embedding(
                self.pitch_predictor, self.pitch_embedding, self.pitch_bins,
                x, pitch_target, src_pad_mask, p_control, p_offset)
            x = x + emb
        if cfg.energy_feature_level == "phoneme_level":
            energy_prediction, emb = self._variance_embedding(
                self.energy_predictor, self.energy_embedding,
                self.energy_bins, x, energy_target, src_pad_mask, e_control,
                e_offset)
            x = x + emb

        if duration_target is not None:
            duration_rounded = duration_target.to(torch.int32)
        else:
            # round FIRST, then scale and floor (reference
            # model/modules.py:132-135 and LengthRegulator's int())
            duration_rounded = torch.floor(torch.clamp(
                torch.round(torch.exp(log_duration_prediction.float())
                            - 1.0)
                * d_control, min=0.0)).to(torch.int32)
            duration_rounded = duration_rounded.masked_fill(src_pad_mask, 0)
        if max_mel_len is None:
            max_mel_len = cfg.max_seq_len
        x, mel_len = length_regulate(x, duration_rounded, max_mel_len)
        if duration_target is None or mel_pad_mask is None:
            mel_pad_mask = pad_mask_from_lengths(mel_len, max_mel_len)

        if cfg.pitch_feature_level == "frame_level":
            pitch_prediction, emb = self._variance_embedding(
                self.pitch_predictor, self.pitch_embedding, self.pitch_bins,
                x, pitch_target, mel_pad_mask, p_control, p_offset)
            x = x + emb
        if cfg.energy_feature_level == "frame_level":
            energy_prediction, emb = self._variance_embedding(
                self.energy_predictor, self.energy_embedding,
                self.energy_bins, x, energy_target, mel_pad_mask, e_control,
                e_offset)
            x = x + emb

        x = fill_masked(x, mel_pad_mask)
        return (x, pitch_prediction, energy_prediction,
                log_duration_prediction, duration_rounded, mel_len,
                mel_pad_mask)
