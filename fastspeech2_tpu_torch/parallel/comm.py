"""The collectives the sharded and data-parallel paths call, with the
gradients each one needs.

Megatron's pair for tensor parallel over a model group:

* :func:`copy_to_model` ("f") marks a replicated activation entering
  column-split layers: the identity forward, an all-reduce of the
  gradient backward, since each rank's share of those layers gives only
  part of the gradient of their common input.
* :func:`reduce_from_model` ("g") sums the partial outputs of row-split
  layers: an all-reduce forward, the identity backward, since every rank
  then holds the same replicated activation and its whole gradient.

:func:`all_reduce_sum` is an all-reduce with an all-reduce backward: for
sums that each data rank adds to (the PostNet's BatchNorm statistics),
where every rank's share of the loss depends on the total.  With a None
group each of them is the identity.  A bfloat16 tensor is summed in
float32 and rounded back once.
"""

import torch
import torch.distributed as dist


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """A reduced copy of ``t`` over ``group`` (no gradient); ``t`` itself
    when the group is None."""
    if group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, op=op, group=group)
    return t


def _summed(t, group):
    """A new tensor: ``t`` summed over ``group``, in float32 for a
    bfloat16 or float16 ``t``."""
    low = t.dtype in (torch.bfloat16, torch.float16)
    buf = t.float() if low else t.contiguous().clone()
    dist.all_reduce(buf, group=group)
    return buf.to(t.dtype) if low else buf


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def copy_to_model(x, group):
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return x if group is None else _ReduceFromModel.apply(x, group)


def all_reduce_sum(x, group):
    return x if group is None else _AllReduceSum.apply(x, group)


def all_reduce_flat(tensors, group, scale=None):
    """Sum a list of tensors over ``group`` in one collective (flattened
    into one buffer), optionally times ``scale`` -> a new list."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if scale is not None:
        flat = flat * scale
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out
