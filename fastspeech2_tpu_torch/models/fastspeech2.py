"""FastSpeech 2 acoustic model (port of
``fastspeech2_tpu/models/fastspeech2.py``).

encoder -> (+ speaker embedding) -> variance adaptor -> decoder ->
mel linear -> PostNet residual.  The caller fixes the phone length P and
the frame length T; the data's lengths travel as length vectors + masks.
``model.train()`` is the JAX package's ``train=True``: dropout on, the
PostNet's BatchNorm on masked batch statistics; ``model.eval()`` is
``train=False``.  ``dtype`` is the JAX model's compute dtype (float32 or
bfloat16; parameters stay float32): the activations are made at it and
every layer computes at it (models/common.py), so the mel and the
predictions come out at it.

``mesh`` (``parallel.Mesh``): the FFT blocks hold this rank's shard of
the model axis (models/transformer.py), and the batch-wide quantities
span the data axis: the batch's max mel length, past which the PostNet
zeroes frames (fastspeech2_tpu/models/fastspeech2.py:142-149), and in
training mode the PostNet's BatchNorm statistics.  Every data rank must
then run each forward, on its rows of one batch (a training step) or on
the same rows (the loop's validation and samples).
"""

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from fastspeech2_tpu_torch.models.common import Linear
from fastspeech2_tpu_torch.models.postnet import PostNet
from fastspeech2_tpu_torch.models.transformer import Decoder, Encoder
from fastspeech2_tpu_torch.models.variance import VarianceAdaptor
from fastspeech2_tpu_torch.ops.masking import pad_mask_from_lengths
from fastspeech2_tpu_torch.parallel.comm import all_reduce
from fastspeech2_tpu_torch.parallel.mesh import SINGLE


class FastSpeech2Output(NamedTuple):
    """The reference's 10-tuple forward output (model/fastspeech2.py:99-110)."""

    mel: torch.Tensor                # [B, T, n_mels] pre-PostNet
    postnet_mel: torch.Tensor        # [B, T, n_mels]
    pitch_prediction: torch.Tensor   # [B, P] or [B, T]
    energy_prediction: torch.Tensor
    log_duration_prediction: torch.Tensor  # [B, P]
    duration_rounded: torch.Tensor   # [B, P] int
    src_pad_mask: torch.Tensor       # [B, P] True = pad
    mel_pad_mask: torch.Tensor       # [B, T] True = pad
    src_len: torch.Tensor            # [B]
    mel_len: torch.Tensor            # [B]


class FastSpeech2(nn.Module):

    def __init__(self, cfg, dtype=torch.float32, mesh=SINGLE):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.mesh = mesh
        self.data_group = mesh.data_group
        self.encoder = Encoder(cfg, dtype, mesh)
        self.variance_adaptor = VarianceAdaptor(cfg)
        self.decoder = Decoder(cfg, mesh)
        self.mel_linear = Linear(cfg.decoder_hidden, cfg.n_mel_channels)
        self.postnet = PostNet(cfg.n_mel_channels, cfg.postnet_embedding_dim,
                               cfg.postnet_kernel_size,
                               cfg.postnet_n_convolutions, mesh.data_group)
        if cfg.multi_speaker:
            self.speaker_emb = nn.Embedding(cfg.n_speaker, cfg.encoder_hidden)

    def forward(self, speakers, texts, src_lens, mel_lens=None,
                max_mel_len=None, p_targets=None, e_targets=None,
                d_targets=None, p_control=1.0, e_control=1.0, d_control=1.0,
                p_offset=0.0, e_offset=0.0, truncate_decoder=True):
        """Teacher-forced (training and evaluation) with mel_lens,
        max_mel_len (the batch's static frame length T) and the p/e/d
        targets; inference without them.  truncate_decoder=True mirrors
        the reference's training-time cut to max_seq_len; inference
        re-dispatches pass False (no cut).  The mel targets are the loss's,
        not the forward's (the JAX forward takes and ignores them)."""
        out = self.front(speakers, texts, src_lens, mel_lens, max_mel_len,
                         p_targets, e_targets, d_targets, p_control,
                         e_control, d_control, p_offset, e_offset,
                         truncate_decoder)
        batch_max = all_reduce(out.mel_len.max(), self.data_group,
                               op=dist.ReduceOp.MAX)
        return self.with_postnet(out, batch_max)

    def front(self, speakers, texts, src_lens, mel_lens=None,
              max_mel_len=None, p_targets=None, e_targets=None,
              d_targets=None, p_control=1.0, e_control=1.0, d_control=1.0,
              p_offset=0.0, e_offset=0.0, truncate_decoder=True):
        """Everything up to ``mel_linear``: the output with
        ``postnet_mel`` None.  A caller that splits one batch over several
        replicas runs this on each, then :meth:`with_postnet` with the
        whole batch's max mel length."""
        src_pad_mask = pad_mask_from_lengths(src_lens, texts.shape[1])
        mel_pad_mask = (pad_mask_from_lengths(mel_lens, max_mel_len)
                        if mel_lens is not None else None)

        x = self.encoder(texts, src_pad_mask)
        if self.cfg.multi_speaker:
            x = x + self.speaker_emb(speakers).to(x.dtype)[:, None, :]

        (x, pitch_prediction, energy_prediction, log_duration_prediction,
         duration_rounded, mel_len, mel_pad_mask) = self.variance_adaptor(
            x, src_pad_mask, mel_pad_mask=mel_pad_mask,
            max_mel_len=max_mel_len, pitch_target=p_targets,
            energy_target=e_targets, duration_target=d_targets,
            p_control=p_control, e_control=e_control, d_control=d_control,
            p_offset=p_offset, e_offset=e_offset)

        x, mel_pad_mask = self.decoder(x, mel_pad_mask,
                                       truncate_to_max_len=truncate_decoder)
        return FastSpeech2Output(
            mel=self.mel_linear(x), postnet_mel=None,
            pitch_prediction=pitch_prediction,
            energy_prediction=energy_prediction,
            log_duration_prediction=log_duration_prediction,
            duration_rounded=duration_rounded, src_pad_mask=src_pad_mask,
            mel_pad_mask=mel_pad_mask, src_len=src_lens, mel_len=mel_len)

    def with_postnet(self, out, batch_max):
        """``out`` with its PostNet mel.  Frames at or past ``batch_max``
        (a 0-d tensor: the batch's max mel length) are zero for the
        PostNet, as in the reference's exact-length batch."""
        mel = out.mel
        t_idx = torch.arange(mel.shape[1], device=mel.device)
        beyond_batch_max = (t_idx[None, :] >= batch_max).expand(
            mel.shape[0], -1)
        return out._replace(
            postnet_mel=mel + self.postnet(mel, frame_mask=beyond_batch_max))
