"""Sinusoidal positional encodings (port of
``fastspeech2_tpu/ops/positional.py``).

    angle(pos, j) = pos / 10000^(2*(j//2)/d)
    PE[pos, 2i] = sin(angle), PE[pos, 2i+1] = cos(angle)

The table is built in float64 numpy for the length at hand, then cast, as
the JAX package does; it has no fixed maximum length.  A table on the card
is made once per (length, width, dtype) and kept: a copy from the host in
every forward would make the host wait for the card, and cannot be
captured in a CUDA graph (synthesis/graphs.py, which keeps the tables its
graphs read: ops/device_cache.py).
"""

import numpy as np
import torch

from fastspeech2_tpu_torch.ops.device_cache import cached_constant


def _table(n_position, d_hid):
    pos = np.arange(n_position)[:, None]
    j = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (j // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


@cached_constant(maxsize=64)
def _device_table(n_position, d_hid, dtype, device):
    # made outside inference mode, so that training can use it too
    with torch.inference_mode(False):
        return torch.as_tensor(_table(n_position, d_hid), dtype=dtype,
                               device=device)


def sinusoid_position_encoding(n_position, d_hid, dtype=torch.float32,
                               device=None):
    """[n_position, d_hid] sinusoid table (on the card: a shared one, not to
    be written to)."""
    device = torch.device(device or "cpu")
    if device.type == "cuda":
        return _device_table(n_position, d_hid, dtype, device)
    return torch.as_tensor(_table(n_position, d_hid), dtype=dtype,
                           device=device)
