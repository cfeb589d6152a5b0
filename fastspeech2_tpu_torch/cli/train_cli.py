"""Acoustic-model training CLI (port of
``fastspeech2_tpu/cli/train_cli.py``):

    python -m fastspeech2_tpu_torch.cli.train_cli -p PRE.yaml -m MODEL.yaml \\
        -t TRAIN.yaml [--restore_step N|-1] [--max_steps N] \\
        [--dtype bfloat16|float32] [--profile_dir DIR] [--vocoder_ckpt F] \\
        [--device cuda|cpu]

Prints loss lines every log_step and validation lines every val_step, and
writes ``<ckpt_path>/<step>.pth.tar`` every save_step and at the end.
``--restore_step -1`` resumes from the latest checkpoint, if any.  Runs on
the card (``--device cuda``, the default) unless ``--device cpu`` is given.
``--dtype`` is the compute dtype, bfloat16 by default as in the JAX CLI;
parameters, checkpoints and the optimizer stay float32.
``--profile_dir`` writes a torch.profiler trace of steps 11-20 there.
The synth_step duty draws the mel figure; with ``--vocoder_ckpt`` it also
vocodes the sample through model.yaml's vocoder on those weights (the JAX
CLI passes no vocoder, so its duty draws the figure only).

Data parallel, as the JAX CLI spreads the batch over every device it
sees: start one process per card under ``torchrun``,

    torchrun --standalone --nproc_per_node 4 \
        -m fastspeech2_tpu_torch.cli.train_cli -p ... -m ... -t ...

Each rank takes ``cuda:<LOCAL_RANK>`` and joins an NCCL world (gloo with
``--device cpu``); the data axis is gcd(micro-batch, world)
(``training/loop.py``).  Without torchrun (no WORLD_SIZE) it runs in one
process as before.
"""

import argparse

from fastspeech2_tpu_torch.cli.common import add_dtype_arg, dtype_from_flag
from fastspeech2_tpu_torch.configs.config import load_yaml_configs
from fastspeech2_tpu_torch.parallel.mesh import init_from_torchrun
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
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of steps 11-20 "
                             "there")
    parser.add_argument("--vocoder_ckpt", default=None,
                        help="vocoder weights for the synth_step duty's "
                             "wavs (npz or .pth.tar; without it the duty "
                             "draws the figure only)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    """-> (model, optimizer, final step)."""
    args = build_parser().parse_args(argv)
    device = init_from_torchrun(resolve_device(args.device))
    configs = load_yaml_configs(args.preprocess_config, args.model_config,
                                args.train_config)
    restore_step = args.restore_step
    if restore_step == -1:
        restore_step = latest_step(configs[2]["path"]["ckpt_path"]) or 0
        print(f"Resuming from step {restore_step}")
    vocoder = None
    if args.vocoder_ckpt:
        from fastspeech2_tpu_torch.synthesis.vocoder import get_vocoder

        vocoder = get_vocoder(configs[1], configs[0], args.vocoder_ckpt,
                              device)
    return train(*configs, restore_step=restore_step,
                 dtype=dtype_from_flag(args.dtype), max_steps=args.max_steps,
                 device=device, vocoder=vocoder,
                 profile_dir=args.profile_dir)


if __name__ == "__main__":
    main()
