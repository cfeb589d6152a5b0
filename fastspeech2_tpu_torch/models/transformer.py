"""FFT-block transformer encoder/decoder (port of
``fastspeech2_tpu/models/transformer.py``).

Post-LN residual multi-head self-attention followed by a
conv(k=9) -> ReLU -> conv(k=1) position-wise FFN, padded rows zeroed after
each sublayer, sinusoid position encodings built for the length at hand.
Module names follow the upstream reference's state dict
(encoder.layer_stack.N.slf_attn.w_qs, ...).

The attention core is kernel K1 forward and K3 backward
(ops/cuda_attention.py).  In eval mode the whole FFN sublayer is kernel K2
(ops/cuda_ffn.py); in training mode the FFN runs its plain path with
dropout after the second conv, as the JAX package's training path does
(fastspeech2_tpu/models/transformer.py:162-189).  On CUDA tensors the
wrappers always launch their kernels; on CPU tensors they compute their
plain versions.  Dropout follows the attention's output projection, in
training mode only.

Everything runs at the activations' dtype, which the Encoder sets
(models/common.py): in bfloat16, the residual adds round to bfloat16, the
LayerNorms run in float32 and cast back, and the position encodings are
added in bfloat16, at the JAX modules' cast points.

Under tensor parallel (a ``parallel.Mesh`` whose model axis is above 1;
rules in ``parallel/sharding.py``) each rank holds n_head / model of the
heads and d_inner / model of the FFN's hidden channels.  The attention
runs its own heads through K1 (and K3 backward); the partial products of
``fc`` and of ``w_2`` are summed over the model group, and their biases
added once after the sum, before the dropout, residual and LayerNorm.  The
input of the split layers passes through ``comm.copy_to_model``, whose
backward sums the partial input gradients.  The FFN then runs its plain
path in either mode: K2's in-kernel LayerNorm needs the whole hidden sum
(the JAX package takes its XLA path there too,
fastspeech2_tpu/ops/pallas_ffn.py:139-144).
"""

import torch
from torch import nn
from torch.nn import functional as F

from fastspeech2_tpu_torch.models.common import Dropout, LayerNorm, Linear
from fastspeech2_tpu_torch.ops.cuda_attention import fused_attention
from fastspeech2_tpu_torch.ops.cuda_ffn import (
    conv1d_same,
    fused_conv_ffn,
    pack_ffn_weights,
    residual_layer_norm,
)
from fastspeech2_tpu_torch.ops.masking import fill_masked
from fastspeech2_tpu_torch.ops.positional import sinusoid_position_encoding
from fastspeech2_tpu_torch.parallel.comm import (
    copy_to_model,
    reduce_from_model,
)
from fastspeech2_tpu_torch.parallel.mesh import SINGLE

PAD_ID = 0


def _local(n, mesh, what):
    if n % mesh.model:
        raise ValueError(f"{what} {n} does not split over a model axis of "
                         f"{mesh.model}")
    return n // mesh.model


def _row_split_linear(x, linear, group):
    """``linear`` whose input dim is split over ``group``: the partial
    products summed, then the bias (module docstring)."""
    if group is None:
        return linear(x)
    y = reduce_from_model(F.linear(x, linear.weight.to(x.dtype)), group)
    return y + linear.bias.to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Post-LN residual MHA (reference transformer/SubLayers.py:8-57);
    n_head / mesh.model heads on this rank."""

    def __init__(self, n_head, d_model, dropout, mesh=SINGLE):
        super().__init__()
        self.d_head = d_model // n_head
        self.n_head = _local(n_head, mesh, "n_head")
        self.group = mesh.model_group
        self.w_qs = Linear(d_model, self.n_head * self.d_head)
        self.w_ks = Linear(d_model, self.n_head * self.d_head)
        self.w_vs = Linear(d_model, self.n_head * self.d_head)
        self.fc = Linear(self.n_head * self.d_head, d_model)
        self.layer_norm = LayerNorm(d_model)
        self.dropout = Dropout(dropout)

    def forward(self, x, key_pad_mask):
        b, l, _ = x.shape
        x_in = copy_to_model(x, self.group)

        def proj(linear):
            y = linear(x_in).view(b, l, self.n_head, self.d_head)
            return y.transpose(1, 2).contiguous()      # [B, H, L, Dh]

        out = fused_attention(proj(self.w_qs), proj(self.w_ks),
                              proj(self.w_vs), key_pad_mask)
        out = out.transpose(1, 2).reshape(b, l, self.n_head * self.d_head)
        out = _row_split_linear(out, self.fc, self.group)
        return self.layer_norm(self.dropout(out) + x)


def ffn_train(x, w1, b1, w2, b2, ln_scale, ln_bias, dropout, group=None):
    """The FFN sublayer in training mode, as the JAX package's training
    path computes it (fastspeech2_tpu/models/transformer.py:171-189): each
    conv's product rounded to x's dtype and its bias added in it, dropout
    at x's dtype, the residual and the LayerNorm in float32, the output
    rounded to x's dtype.  (K2 and its plain version add b1 in float32 and
    round only h: in bfloat16 the two paths round differently.)  With a
    model ``group``, w1/b1 hold this rank's hidden channels and w2 its
    input rows: the second conv's partial products are summed over the
    group before b2."""
    dt = x.dtype
    y = torch.relu(conv1d_same(copy_to_model(x, group), w1.to(dt))
                   + b1.to(dt))
    y = conv1d_same(y, w2.to(dt))
    if group is not None:
        y = reduce_from_model(y, group)
    y = y + b2.to(dt)
    return residual_layer_norm(dropout(y), x, ln_scale, ln_bias)


class PositionwiseFeedForward(nn.Module):
    """conv1d(k0) -> ReLU -> conv1d(k1) -> dropout -> post-LN residual
    (reference transformer/SubLayers.py:60-93): kernel K2 in eval mode,
    :func:`ffn_train` in training mode.  K2's weight pack is made once for
    the no-grad forwards and again only when a weight is replaced, moved or
    changed in place, or the dtype changes."""

    def __init__(self, d_model, d_inner, kernel_size, dropout, mesh=SINGLE):
        super().__init__()
        d_inner = _local(d_inner, mesh, "d_inner")
        self.group = mesh.model_group
        self.w_1 = nn.Conv1d(d_model, d_inner, kernel_size[0],
                             padding=(kernel_size[0] - 1) // 2)
        self.w_2 = nn.Conv1d(d_inner, d_model, kernel_size[1],
                             padding=(kernel_size[1] - 1) // 2)
        self.layer_norm = LayerNorm(d_model)
        self.dropout = Dropout(dropout)
        self._pack = self._pack_key = None

    def _apply(self, fn, *args, **kwargs):
        # .to() / .cuda() / .cpu() give the weights new storage
        self._pack = self._pack_key = None
        return super()._apply(fn, *args, **kwargs)

    def _packed(self, w1, w2, dtype):
        key = (dtype,) + tuple((t.data_ptr(), t._version)
                               for t in (self.w_1.weight, self.w_2.weight))
        if key != self._pack_key:
            self._pack = pack_ffn_weights(w1, w2, dtype)
            self._pack_key = key
        return self._pack

    def forward(self, x):
        # torch Conv1d [out, in, k] -> the JAX layout [k, in, out], a view
        w1 = self.w_1.weight.permute(2, 1, 0)
        w2 = self.w_2.weight.permute(2, 1, 0)
        args = (x, w1, self.w_1.bias, w2, self.w_2.bias,
                self.layer_norm.weight, self.layer_norm.bias)
        if self.training or self.group is not None:
            return ffn_train(*args, dropout=self.dropout, group=self.group)
        packed = None
        if x.device.type == "cuda" and not (torch.is_grad_enabled() and any(
                t.requires_grad for t in args)):
            packed = self._packed(w1, w2, x.dtype)
        return fused_conv_ffn(*args, packed=packed)


class FFTBlock(nn.Module):
    """Self-attention + conv FFN, zeroing padded rows after each sublayer
    (reference transformer/Layers.py:11-30)."""

    def __init__(self, d_model, n_head, d_inner, kernel_size, dropout,
                 mesh=SINGLE):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, dropout, mesh)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, kernel_size,
                                               dropout, mesh)

    def forward(self, x, pad_mask):
        x = fill_masked(self.slf_attn(x, pad_mask), pad_mask)
        return fill_masked(self.pos_ffn(x), pad_mask)


def _blocks(cfg, n_layers, n_head, d_model, dropout, mesh):
    return nn.ModuleList(
        FFTBlock(d_model, n_head, cfg.conv_filter_size, cfg.conv_kernel_size,
                 dropout, mesh)
        for _ in range(n_layers))


class Encoder(nn.Module):
    """Phone embedding + PE + N x FFTBlock (reference
    transformer/Models.py:33-100).  The embedding and the position
    encoding are cast to ``dtype``, the compute dtype of everything
    after."""

    def __init__(self, cfg, dtype=torch.float32, mesh=SINGLE):
        super().__init__()
        self.dtype = dtype
        self.d_model = cfg.encoder_hidden
        self.src_word_emb = nn.Embedding(cfg.vocab_size, cfg.encoder_hidden,
                                         padding_idx=PAD_ID)
        self.layer_stack = _blocks(cfg, cfg.encoder_layer, cfg.encoder_head,
                                   cfg.encoder_hidden, cfg.encoder_dropout,
                                   mesh)

    def forward(self, src_seq, src_pad_mask):
        pe = sinusoid_position_encoding(src_seq.shape[1], self.d_model,
                                        dtype=self.dtype,
                                        device=src_seq.device)
        x = self.src_word_emb(src_seq).to(self.dtype) + pe[None]
        for block in self.layer_stack:
            x = block(x, src_pad_mask)
        return x


class Decoder(nn.Module):
    """PE + N x FFTBlock over frames.  With ``truncate_to_max_len`` it cuts
    the frames to max_seq_len like the reference's training path
    (transformer/Models.py:154-162); inference re-dispatches pass False."""

    def __init__(self, cfg, mesh=SINGLE):
        super().__init__()
        self.d_model = cfg.decoder_hidden
        self.max_seq_len = cfg.max_seq_len
        self.layer_stack = _blocks(cfg, cfg.decoder_layer, cfg.decoder_head,
                                   cfg.decoder_hidden, cfg.decoder_dropout,
                                   mesh)

    def forward(self, x, mel_pad_mask, truncate_to_max_len=True):
        if truncate_to_max_len and x.shape[1] > self.max_seq_len:
            x = x[:, : self.max_seq_len]
            # contiguous: K1 takes the mask as a dense [B, L] array
            mel_pad_mask = mel_pad_mask[:, : self.max_seq_len].contiguous()
        pe = sinusoid_position_encoding(x.shape[1], self.d_model,
                                        dtype=x.dtype, device=x.device)
        x = x + pe[None]
        for block in self.layer_stack:
            x = block(x, mel_pad_mask)
        return x, mel_pad_mask
