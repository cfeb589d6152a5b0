"""The (data, model) process groups: the port's counterpart of
``fastspeech2_tpu/parallel/mesh.py``.

The JAX package runs one program over a ``jax.sharding.Mesh`` with a
"data" axis (the batch) and a "model" axis (tensor parallel over the
attention heads and the FFN's hidden channels), and XLA inserts the
all-reduces.  PyTorch's idiom is one process per card under ``torchrun``
with ``torch.distributed``: :func:`make_mesh` splits the world into those
two kinds of groups, and the modules call the collectives themselves
(``parallel/comm.py``).

Rank r of the world is (data rank, model rank) = divmod(r, model): the
ranks of one model group are neighbours, as ``mesh_utils`` lays a
(data, model) grid over the devices.  Ranks at or beyond data * model
take part in building the groups and then sit idle, as the JAX trainer
leaves the devices beyond its mesh idle.

The backend is the caller's choice, made once at
:func:`init_distributed` (and, for the groups, here): NCCL across cards;
gloo for the CPU tests and for two ranks sharing one card (NCCL refuses
two ranks on one GPU, gloo copies CUDA tensors through the host for its
all-reduce and broadcast).  Nothing here picks a backend by catching a
failure.  One more group is gloo whatever the backend: the host group,
which sums flags that live on the host, so that the train loop's
per-step preemption check does not wait for the card.
"""

import datetime
import os
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) grid.  ``data_group`` and
    ``model_group`` are the process groups of this rank's data column and
    model row, or None where that axis has size 1 (no collective then).
    ``host_group`` is a gloo group over the whole grid for flags held on
    the host (:func:`agree`), None in one process."""

    data: int
    model: int
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = None
    model_group: Any = None
    host_group: Any = None
    active: bool = True

    @property
    def size(self):
        return self.data * self.model

    @property
    def rank(self):
        return self.data_rank * self.model + self.model_rank

    @property
    def is_main(self):
        """Rank 0 of the grid: the one that writes logs and checkpoints."""
        return self.active and self.rank == 0


SINGLE = Mesh(1, 1)


def init_distributed(backend, init_method="env://", world_size=None,
                     rank=None, timeout_s=600):
    """``torch.distributed.init_process_group`` with an explicit backend
    ("nccl" or "gloo").  ``init_method`` "env://" reads torchrun's
    MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK; a ``FileStore`` path
    ("file://...") or "tcp://localhost:PORT" with world_size and rank
    serves processes started by hand."""
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def init_from_torchrun(device):
    """Under ``torchrun`` (WORLD_SIZE above 1): join the world, NCCL on
    ``cuda:<LOCAL_RANK>`` or gloo on the CPU, and return this rank's
    device; otherwise return ``device`` as it is (one process)."""
    if int(os.environ.get("WORLD_SIZE", "1")) == 1:
        return device
    if device.type == "cuda":
        device = torch.device(f"cuda:{os.environ['LOCAL_RANK']}")
        torch.cuda.set_device(device)
    init_distributed("nccl" if device.type == "cuda" else "gloo")
    return device


def make_mesh(data=None, model=1, backend=None):
    """The (data, model) groups over the initialised world, as
    ``make_mesh(data, model)`` lays a mesh over the JAX devices.

    data=None takes world // model.  Raises where data * model exceeds the
    world.  Every rank must call this, with the same arguments, since
    building a group is collective.  Without an initialised world, only
    (1, 1) is possible and gives the one-process mesh."""
    if not dist.is_initialized():
        if (data or 1) * model != 1:
            raise ValueError(f"a ({data}, {model}) mesh needs "
                             "torch.distributed to be initialised")
        return SINGLE
    world = dist.get_world_size()
    if data is None:
        if world % model:
            raise ValueError(f"world {world} is not a multiple of model "
                             f"{model}")
        data = world // model
    if data < 1 or model < 1 or data * model > world:
        raise ValueError(f"mesh (data {data}, model {model}) does not fit "
                         f"a world of {world}")
    backend = backend or dist.get_backend()
    rank = dist.get_rank()
    data_groups = [dist.new_group([d * model + m for d in range(data)],
                                  backend=backend)
                   if data > 1 else None for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)],
                                   backend=backend)
                    if model > 1 else None for d in range(data)]
    host_group = (dist.new_group(list(range(data * model)), backend="gloo")
                  if data * model > 1 else None)
    if rank >= data * model:
        return Mesh(data, model, active=False)
    d, m = divmod(rank, model)
    return Mesh(data, model, d, m, data_groups[m], model_groups[d],
                host_group)


def agree(flag, mesh):
    """True on every rank of the grid when ``flag`` is True on any: a
    preemption signal that reaches one rank a step before another must
    stop them all at the same step.  The flag is summed on the host, over
    gloo, so the check never waits for the card's queued work."""
    if mesh.size == 1:
        return flag
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())
