"""Export teacher-forced predicted mels for vocoder fine-tuning (port of
``fastspeech2_tpu/cli/export_mels_cli.py``):

    python -m fastspeech2_tpu_torch.cli.export_mels_cli -p PRE.yaml \\
        -m MODEL.yaml -t TRAIN.yaml --weights_npz ACOUSTIC.npz \\
        [--split train.txt] [--batch_size 16] [--teacher_force {d,pde}] \\
        [--dtype float32|bfloat16] [--device cpu]

Runs the acoustic model in eval mode over a preprocessed corpus split with
the ground-truth durations forced (so predicted frame i lines up with
ground-truth samples [i*hop, (i+1)*hop)), and with ``--teacher_force pde``
the pitch and energy targets too (``d``, the default, lets the model
predict them).  Each batch is padded to train.yaml's buckets, capped at
max_seq_len, and the forward runs at its full frame length.  Writes
``<preprocessed_path>/mel_pred/<speaker>-mel-<basename>.npy``, [T,
n_mels] float32, the ``mel_pred`` that ``train_vocoder_cli --mel_source
pred|mixed`` reads.  The weights come from ``--weights_npz``,
``--restore_step`` (the port's checkpoint) or ``--torch_ckpt``.  On the
card each forward launches K1 and K2 in all ten FFT blocks, at
``--dtype``.
"""

import argparse
import os

import numpy as np
import torch

from fastspeech2_tpu_torch.cli.common import add_dtype_arg, dtype_from_flag
from fastspeech2_tpu_torch.cli.synthesize_cli import (
    add_weights_args,
    load_model_for_inference,
)
from fastspeech2_tpu_torch.configs.config import load_yaml_configs
from fastspeech2_tpu_torch.data.dataset import FeatureDataset, collate_batch
from fastspeech2_tpu_torch.training.step import batch_to_device
from fastspeech2_tpu_torch.utils.device import resolve_device


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-p", "--preprocess_config", required=True)
    parser.add_argument("-m", "--model_config", required=True)
    parser.add_argument("-t", "--train_config", required=True)
    add_weights_args(parser)
    parser.add_argument("--split", default="train.txt")
    parser.add_argument("--batch_size", type=int, default=16)
    add_dtype_arg(parser, "float32")
    parser.add_argument("--teacher_force", choices=["d", "pde"], default="d",
                        help="variance targets forced besides durations: "
                             "'d' predicts pitch and energy, 'pde' forces "
                             "them too")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    """-> the number of mels written."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    preprocess_config, model_config, train_config = load_yaml_configs(
        args.preprocess_config, args.model_config, args.train_config)
    model, cfg = load_model_for_inference(
        preprocess_config, model_config, args.weights_npz, device,
        train_config=train_config, restore_step=args.restore_step,
        torch_ckpt=args.torch_ckpt, dtype=dtype_from_flag(args.dtype))

    dataset = FeatureDataset(args.split, preprocess_config)
    out_dir = os.path.join(
        preprocess_config["path"]["preprocessed_path"], "mel_pred")
    os.makedirs(out_dir, exist_ok=True)
    bucket = train_config.get("bucket", {})
    text_bucket = int(bucket.get("text", 32))
    mel_bucket = int(bucket.get("mel", 160))
    force_pe = args.teacher_force == "pde"

    n = len(dataset)
    written = 0
    for start in range(0, n, args.batch_size):
        samples = [dataset[i] for i in range(
            start, min(start + args.batch_size, n))]
        batch = collate_batch(samples, text_bucket, mel_bucket,
                              max_mel_len=cfg.max_seq_len)
        t = batch_to_device(batch, device)
        with torch.inference_mode():
            out = model(t["speakers"], t["texts"], t["src_lens"],
                        mel_lens=t["mel_lens"],
                        max_mel_len=batch["mels"].shape[1],
                        p_targets=t["pitches"] if force_pe else None,
                        e_targets=t["energies"] if force_pe else None,
                        d_targets=t["durations"])
        mel_pred = out.postnet_mel.float().cpu().numpy()
        for b, s in enumerate(samples):
            T = int(batch["mel_lens"][b])
            spk = dataset.speaker[start + b]
            np.save(os.path.join(out_dir, f"{spk}-mel-{s['id']}.npy"),
                    mel_pred[b, :T])
            written += 1
    print(f"Wrote {written} predicted mels to {out_dir}")
    return written


if __name__ == "__main__":
    main()
