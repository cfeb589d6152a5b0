"""Data and tensor parallelism (port of ``fastspeech2_tpu/parallel/``)."""

from fastspeech2_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SINGLE,
    Mesh,
    init_distributed,
    make_mesh,
)
from fastspeech2_tpu_torch.parallel.sharding import (
    shard_state_dict,
    split_dim,
    unshard_state_dict,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "SINGLE",
    "Mesh",
    "init_distributed",
    "make_mesh",
    "shard_state_dict",
    "split_dim",
    "unshard_state_dict",
]
