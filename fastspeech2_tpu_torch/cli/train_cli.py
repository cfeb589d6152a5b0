"""Acoustic-model training CLI (port of
``fastspeech2_tpu/cli/train_cli.py``):

    python -m fastspeech2_tpu_torch.cli.train_cli -p PRE.yaml -m MODEL.yaml \\
        -t TRAIN.yaml [--restore_step N|-1] [--max_steps N] \\
        [--dtype float32] [--device cuda|cpu]

Prints loss lines every log_step and validation lines every val_step, and
writes ``<ckpt_path>/<step>.pth.tar`` every save_step and at the end.
``--restore_step -1`` resumes from the latest checkpoint, if any.  Runs on
the card (``--device cuda``, the default) unless ``--device cpu`` is given.
``--dtype`` is float32: the attention kernels K1 and K3 take float32 only
so far, so bfloat16 (the JAX CLI's default) is refused.
"""

import argparse

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
    parser.add_argument("--dtype", choices=["float32", "bfloat16"],
                        default="float32",
                        help="compute dtype; only float32 is ported")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    """-> (model, optimizer, final step)."""
    args = build_parser().parse_args(argv)
    if args.dtype != "float32":
        raise SystemExit(
            f"--dtype {args.dtype}: the port trains in float32 only (its "
            "attention kernels K1 and K3 take float32); pass --dtype "
            "float32")
    device = resolve_device(args.device)
    configs = load_yaml_configs(args.preprocess_config, args.model_config,
                                args.train_config)
    restore_step = args.restore_step
    if restore_step == -1:
        restore_step = latest_step(configs[2]["path"]["ckpt_path"]) or 0
        print(f"Resuming from step {restore_step}")
    return train(*configs, restore_step=restore_step,
                 max_steps=args.max_steps, device=device)


if __name__ == "__main__":
    main()
