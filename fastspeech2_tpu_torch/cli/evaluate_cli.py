"""Validation-set evaluation CLI (port of
``fastspeech2_tpu/cli/evaluate_cli.py``, its loss mode):

    python -m fastspeech2_tpu_torch.cli.evaluate_cli -p PRE.yaml \\
        -m MODEL.yaml -t TRAIN.yaml \\
        (--restore_step N | --weights_npz F | --torch_ckpt F) \\
        [--synth [--vocoder_ckpt F]] [--dtype float32|bfloat16] \\
        [--device cuda|cpu]

Prints the sample-weighted mean teacher-forced losses over val.txt in eval
mode (the loader's duplicate rows left out), one "Validation Step" line,
from the port's own checkpoint ``<ckpt_path>/<N>.pth.tar``, a tracked
npz snapshot or a reference-format ``.pth.tar``.  Runs on the card unless
``--device cpu`` is given, at the compute ``--dtype`` (float32 by
default, as in the JAX CLI).  ``--synth`` also writes the first
validation utterance's synthesized sample to result_path, as the training
loop's duty makes it: ``val_step_<N>.png`` (where matplotlib is
installed) and, through model.yaml's vocoder (``--vocoder_ckpt`` or its
seeded init), ``val_step_<N>_{reconstructed,synthesized}.wav``.  Not
ported yet: --objective (with --split and --save_dir).
"""

import argparse
import os

from fastspeech2_tpu_torch.cli.common import add_dtype_arg, dtype_from_flag
from fastspeech2_tpu_torch.cli.synthesize_cli import (
    add_weights_args,
    load_model_for_inference,
)
from fastspeech2_tpu_torch.configs.config import (
    OptimConfig,
    load_yaml_configs,
)
from fastspeech2_tpu_torch.data.dataset import FeatureDataset
from fastspeech2_tpu_torch.training.loop import evaluate, loss_line
from fastspeech2_tpu_torch.utils.device import resolve_device


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-p", "--preprocess_config", required=True)
    parser.add_argument("-m", "--model_config", required=True)
    parser.add_argument("-t", "--train_config", required=True)
    add_weights_args(parser)
    add_dtype_arg(parser, "float32")
    parser.add_argument("--synth", action="store_true",
                        help="also write a synth-sample figure and wavs to "
                             "result_path, like the in-loop duty")
    parser.add_argument("--vocoder_ckpt", default=None,
                        help="vocoder weights for --synth (npz or .pth.tar)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    """-> the six mean validation losses."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    preprocess_config, model_config, train_config = load_yaml_configs(
        args.preprocess_config, args.model_config, args.train_config)
    model, cfg = load_model_for_inference(
        preprocess_config, model_config, args.weights_npz, device,
        train_config=train_config, restore_step=args.restore_step,
        torch_ckpt=args.torch_ckpt, dtype=dtype_from_flag(args.dtype))
    val_dataset = FeatureDataset("val.txt", preprocess_config)
    losses = evaluate(model, val_dataset,
                      OptimConfig.build(train_config).batch_size, cfg,
                      device)
    print(loss_line(f"Validation Step {args.restore_step or 0}", losses))
    if args.synth:
        write_synth_sample(args, preprocess_config, model_config,
                           train_config, model, cfg, val_dataset, device)
    return losses


def write_synth_sample(args, preprocess_config, model_config, train_config,
                       model, cfg, val_dataset, device):
    """The first validation utterance through synth_one_sample
    (fastspeech2_tpu/cli/evaluate_cli.py:79-104) -> the written paths."""
    from scipy.io import wavfile

    from fastspeech2_tpu_torch.data.dataset import collate_batch
    from fastspeech2_tpu_torch.synthesis.vocoder import get_vocoder
    from fastspeech2_tpu_torch.training.loop import synth_one_sample

    vocoder = get_vocoder(model_config, preprocess_config, args.vocoder_ckpt,
                          device)
    batch = collate_batch([val_dataset[0]], max_mel_len=cfg.max_seq_len)
    fig, wav_rec, wav_pred = synth_one_sample(model, batch,
                                              preprocess_config, vocoder)
    result_path = train_config["path"]["result_path"]
    os.makedirs(result_path, exist_ok=True)
    base = os.path.join(result_path, f"val_step_{args.restore_step or 0}")
    written = []
    if fig is not None:
        from matplotlib import pyplot as plt

        fig.savefig(base + ".png")
        plt.close(fig)
        written.append(base + ".png")
    sr = preprocess_config["preprocessing"]["audio"]["sampling_rate"]
    for name, wav in (("reconstructed", wav_rec), ("synthesized", wav_pred)):
        wavfile.write(f"{base}_{name}.wav", sr, wav)
        written.append(f"{base}_{name}.wav")
    print(f"Synth sample written to {', '.join(written)}")
    return written


if __name__ == "__main__":
    main()
