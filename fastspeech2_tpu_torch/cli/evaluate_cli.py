"""Validation-set evaluation CLI (port of
``fastspeech2_tpu/cli/evaluate_cli.py``, its loss mode):

    python -m fastspeech2_tpu_torch.cli.evaluate_cli -p PRE.yaml \\
        -m MODEL.yaml -t TRAIN.yaml \\
        (--restore_step N | --weights_npz F | --torch_ckpt F) \\
        [--device cuda|cpu]

Prints the sample-weighted mean teacher-forced losses over val.txt in eval
mode (the loader's duplicate rows left out), one "Validation Step" line,
from the port's own checkpoint ``<ckpt_path>/<N>.pth.tar``, a tracked
npz snapshot or a reference-format ``.pth.tar``.  Runs on the card unless
``--device cpu`` is given, in float32.  Not ported yet: --synth and
--objective (with --split, --save_dir, --vocoder_ckpt).
"""

import argparse

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
        torch_ckpt=args.torch_ckpt)
    losses = evaluate(model, FeatureDataset("val.txt", preprocess_config),
                      OptimConfig.build(train_config).batch_size, cfg,
                      device)
    print(loss_line(f"Validation Step {args.restore_step or 0}", losses))
    return losses


if __name__ == "__main__":
    main()
