"""Collectives over one process group, each differentiable with its
adjoint: what ``psum``, ``all_to_all`` and the sharding constraints of
the reference's GSPMD programs become in torch.

The gradient convention is Megatron's.  A tensor that every process of a
group holds alike (replicated) carries, on every process, the whole
gradient of the one loss; a tensor each process holds a different part
of (a slice, or a partial sum) carries the gradient of its own part.
Each operation below moves between the two, and its backward is the
move the other way:

========================  ==========================  ====================
operation                 forward                     backward
========================  ==========================  ====================
``all_reduce``            sum of the partials         identity
``copy_to``               identity                    sum (all-reduce)
``all_gather``            concatenate the slices      reduce-scatter
``reduce_scatter``        sum, then keep one slice    all-gather
``all_to_all``            exchange chunks of dim 0    the exchange back
``gather_replicated``     concatenate the slices      keep one's own slice
``split``                 keep one's own slice        all-gather
``scale_grad``            identity                    times a constant
========================  ==========================  ====================

``all_gather`` feeds a computation each process does on its own part (a
column-parallel product); ``gather_replicated`` one that every process
does alike.  Over a group of one each operation is the identity and
issues nothing.  ``gather_into``, ``take_chunk`` and ``all_reduce_max``
are the plain (not differentiated) forms.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def group_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def gather_into(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """The group's slices concatenated along ``dim`` in rank order."""
    n = group_size(group)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    n = group_size(group)
    src = x.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def take_chunk(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim``."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    c = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * c, c)


def all_reduce_max(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Element-wise max over the group (no gradient)."""
    if group_size(group) == 1:
        return x
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_into(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter(dy, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return gather_into(dy, ctx.dim, ctx.group), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_into(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return take_chunk(dy, ctx.dim, ctx.group).contiguous(), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return take_chunk(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return gather_into(dy, ctx.dim, ctx.group), None, None


def _exchange(x: torch.Tensor, group: Group) -> torch.Tensor:
    out = torch.empty_like(x.contiguous())
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _exchange(dy, ctx.group), None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return dy * ctx.scale, None


def all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum of the group's partials; the gradient passes as it is."""
    return x if group_size(group) == 1 else _AllReduce.apply(x, group)


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the group."""
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """Slices concatenated along ``dim``; gradient reduce-scattered."""
    return x if group_size(group) == 1 else _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """Partials summed, this rank's slice along ``dim`` kept; gradient
    all-gathered."""
    return (x if group_size(group) == 1
            else _ReduceScatter.apply(x, dim, group))


def gather_replicated(x: torch.Tensor, dim: int,
                      group: Group) -> torch.Tensor:
    """Slices concatenated along ``dim`` for a computation every rank does
    alike; the gradient's own slice kept."""
    return (x if group_size(group) == 1
            else _GatherReplicated.apply(x, dim, group))


def split(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """This rank's slice of a replicated ``x``; gradient all-gathered."""
    return x if group_size(group) == 1 else _Split.apply(x, dim, group)


def all_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Chunk ``j`` of dim 0 goes to rank ``j``; chunk ``i`` of the result
    came from rank ``i``.  The gradient is exchanged back."""
    return x if group_size(group) == 1 else _AllToAll.apply(x, group)


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x`` as it is; its gradient times ``scale``."""
    return x if scale == 1 else _ScaleGrad.apply(x, scale)


__all__ = ["group_size", "gather_into", "take_chunk", "all_reduce_max",
           "all_reduce", "copy_to", "all_gather", "reduce_scatter",
           "gather_replicated", "split", "all_to_all", "scale_grad"]
