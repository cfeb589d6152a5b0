"""FastSpeech 2 training loss (port of ``fastspeech2_tpu/models/loss.py``).

Six scalars: total, mel L1, postnet-mel L1, pitch MSE, energy MSE and
log-duration MSE against log(d + 1).  Each is a masked mean over the kept
phones or frames; ``row_keep`` drops whole rows (the loader's duplicate
rows that pad a partial batch) from every mean.
"""

from typing import NamedTuple

import torch

from fastspeech2_tpu_torch.ops.masking import masked_mean


class LossOutput(NamedTuple):
    total: torch.Tensor
    mel: torch.Tensor
    postnet_mel: torch.Tensor
    pitch: torch.Tensor
    energy: torch.Tensor
    duration: torch.Tensor


def fastspeech2_loss(config, output, mel_targets, pitch_targets,
                     energy_targets, duration_targets, row_keep=None):
    """output: a FastSpeech2Output; mel_targets [B, T, n_mels] (cut here to
    the output's frame length, which the decoder may have truncated);
    pitch/energy targets [B, P] or [B, T]; duration_targets [B, P] int;
    row_keep: optional [B] bool, False = row left out."""
    src_keep = ~output.src_pad_mask
    mel_keep = ~output.mel_pad_mask
    if row_keep is not None:
        src_keep = src_keep & row_keep[:, None]
        mel_keep = mel_keep & row_keep[:, None]

    t = output.mel.shape[1]
    mel_targets = mel_targets[:, :t, :].float()
    log_duration_targets = torch.log(duration_targets.float() + 1.0)

    def variance_keep(level):
        return src_keep if level == "phoneme_level" else mel_keep

    pitch_loss = masked_mean(
        (output.pitch_prediction.float() - pitch_targets.float()) ** 2,
        variance_keep(config.pitch_feature_level))
    energy_loss = masked_mean(
        (output.energy_prediction.float() - energy_targets.float()) ** 2,
        variance_keep(config.energy_feature_level))
    duration_loss = masked_mean(
        (output.log_duration_prediction.float() - log_duration_targets) ** 2,
        src_keep)
    frame_keep = mel_keep[:, :, None].expand_as(mel_targets)
    mel_loss = masked_mean((output.mel.float() - mel_targets).abs(),
                           frame_keep)
    postnet_mel_loss = masked_mean(
        (output.postnet_mel.float() - mel_targets).abs(), frame_keep)

    total = (mel_loss + postnet_mel_loss + duration_loss + pitch_loss
             + energy_loss)
    return LossOutput(total=total, mel=mel_loss, postnet_mel=postnet_mel_loss,
                      pitch=pitch_loss, energy=energy_loss,
                      duration=duration_loss)
