"""The compute-dtype flag the three CLIs share (the JAX package's
``fastspeech2_tpu/cli/common.py:25-26``): ``--dtype float32|bfloat16``,
parameters staying float32 either way."""

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def add_dtype_arg(parser, default):
    parser.add_argument("--dtype", choices=sorted(DTYPES), default=default,
                        help=f"compute dtype (default {default}; parameters "
                             "stay float32)")


def dtype_from_flag(name):
    return DTYPES[name]
