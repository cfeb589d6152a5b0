"""Acoustic-model training CLI (port of
``fastspeech2_tpu/cli/train_cli.py``):

    python -m fastspeech2_tpu_torch.cli.train_cli -p PRE.yaml -m MODEL.yaml \\
        -t TRAIN.yaml [--restore_step N|-1] [--max_steps N] \\
        [--dtype bfloat16|float32] [--device cuda|cpu]

Prints loss lines every log_step and validation lines every val_step, and
writes ``<ckpt_path>/<step>.pth.tar`` every save_step and at the end.
``--restore_step -1`` resumes from the latest checkpoint, if any.  Runs on
the card (``--device cuda``, the default) unless ``--device cpu`` is given.
``--dtype`` is the compute dtype, bfloat16 by default as in the JAX CLI;
parameters, checkpoints and the optimizer stay float32.
"""

import argparse

from fastspeech2_tpu_torch.cli.common import add_dtype_arg, dtype_from_flag
from fastspeech2_tpu_torch.configs.config import load_yaml_configs
from fastspeech2_tpu_torch.training.checkpoint import latest_step
from fastspeech2_tpu_torch.training.loop import train
from fastspeech2_tpu_torch.utils.device import resolve_device


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--restore_step", type=int, default=0,
                        help="checkpoint step to resume from; -1 resumes "
                             "from the latest checkpoint if any")
    parser.add_argument("-p", "--preprocess_config", required=True)
    parser.add_argument("-m", "--model_config", required=True)
    parser.add_argument("-t", "--train_config", required=True)
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop early after this many steps")
    add_dtype_arg(parser, "bfloat16")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    """-> (model, optimizer, final step)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    configs = load_yaml_configs(args.preprocess_config, args.model_config,
                                args.train_config)
    restore_step = args.restore_step
    if restore_step == -1:
        restore_step = latest_step(configs[2]["path"]["ckpt_path"]) or 0
        print(f"Resuming from step {restore_step}")
    return train(*configs, restore_step=restore_step,
                 dtype=dtype_from_flag(args.dtype), max_steps=args.max_steps,
                 device=device)


if __name__ == "__main__":
    main()
