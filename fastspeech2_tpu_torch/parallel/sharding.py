"""Tensor-parallel partition rules over the port's state-dict names (the
Megatron rules of ``fastspeech2_tpu/parallel/sharding.py:20-31``).

The FFT blocks split over the model group: the attention's QKV
projections (``w_qs``, ``w_ks``, ``w_vs``) and the FFN's first conv
(``w_1``) on their output (head or hidden) dimension, the attention's
output projection (``fc``) and the FFN's second conv (``w_2``) on their
input dimension, so each sublayer needs one all-reduce.  Everything else
(embeddings, the variance adaptor, ``mel_linear``, the PostNet, every
LayerNorm, and the biases of ``fc`` and ``w_2``, which are added once
after the all-reduce) is replicated.

PyTorch's layouts: ``Linear.weight`` is [out, in], ``Conv1d.weight``
[out, in, k], so "output" is dim 0 and "input" dim 1.  Checkpoints always
hold the whole state dict: :func:`shard_state_dict` takes it to one rank's
shard, :func:`unshard_state_dict` gathers the shards back, so a
checkpoint written at any (data, model) layout resumes at any other.
"""

import re

import torch

from fastspeech2_tpu_torch.parallel.comm import all_reduce

# (name regex, split dim); first match wins, no match = replicated
_RULES = [
    (r".*\.slf_attn\.(w_qs|w_ks|w_vs)\.(weight|bias)", 0),
    (r".*\.slf_attn\.fc\.weight", 1),
    (r".*\.pos_ffn\.w_1\.(weight|bias)", 0),
    (r".*\.pos_ffn\.w_2\.weight", 1),
]


def split_dim(name):
    """The dim a state-dict entry splits on over the model group, or None
    (replicated)."""
    for pattern, dim in _RULES:
        if re.fullmatch(pattern, name):
            return dim
    return None


def _chunk(t, dim, rank, size):
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of a {tuple(t.shape)} tensor does not "
                         f"split {size} ways")
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n).clone()


def shard_state_dict(state, rank, size):
    """A whole state dict -> model rank ``rank``'s shard of ``size``."""
    if size == 1:
        return dict(state)
    return {k: (v if split_dim(k) is None
                else _chunk(v, split_dim(k), rank, size))
            for k, v in state.items()}


def unshard_state_dict(state, rank, size, group):
    """This rank's shard -> the whole state dict, on every rank of the
    model ``group``.  The gather is an all-reduce of zero-filled whole
    tensors holding each rank's block (exact: every element is one shard's
    value plus zeros), so it needs only the collective both backends take
    for CUDA tensors."""
    if size == 1:
        return dict(state)
    out = {}
    for k, v in state.items():
        dim = split_dim(k)
        if dim is None:
            out[k] = v
            continue
        shape = list(v.shape)
        n = shape[dim]
        shape[dim] = n * size
        whole = torch.zeros(shape, dtype=v.dtype, device=v.device)
        whole.narrow(dim, rank * n, n).copy_(v)
        out[k] = all_reduce(whole, group)
    return out


def _by_name(values, names):
    return dict(zip(names, values))


def shard_optimizer_state(state, names, rank, size):
    """An optimizer state dict of the whole model (``mu``, ``nu``: lists
    aligned with the parameters ``names``) -> this rank's shard."""
    out = dict(state)
    for key in ("mu", "nu"):
        sharded = shard_state_dict(_by_name(state[key], names), rank, size)
        out[key] = [sharded[n] for n in names]
    return out


def unshard_optimizer_state(state, names, rank, size, group):
    out = dict(state)
    for key in ("mu", "nu"):
        # mu may be bfloat16: gathered as float32, then cast back (exact)
        shards = {n: v.float() for n, v in zip(names, state[key])}
        whole = unshard_state_dict(shards, rank, size, group)
        out[key] = [whole[n].to(v.dtype) for n, v in zip(names, state[key])]
    return out
