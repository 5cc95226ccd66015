"""The collectives of the data-parallel step and the mesh server.

Only `all_reduce` (SUM) is used, so the same code runs on NCCL and on gloo
with CUDA tensors (two ranks that share one card go over gloo: NCCL
refuses two ranks on one device). A gather is a zero-padded all-reduce, and
a broadcast an all-reduce to which every rank but the source adds zeros.
Every function takes `group=None` as "no group": the local value, so one
code path serves a single process and a mesh, and a world of one computes
the same bits as no mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def index(group) -> int:
    """This rank's place in `group` (0 without one)."""
    return 0 if group is None else dist.get_rank(group)


class _AllReduceSum(torch.autograd.Function):
    """sum over the group's ranks of x, under autograd: each rank's output is
    the same sum, so the gradient of x is the sum of every rank's incoming
    gradient (SyncBatchNorm's rule)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group, *, differentiable: bool = False) -> torch.Tensor:
    """A new tensor: x summed over the group (x itself without a group)."""
    if group is None:
        return x
    if differentiable:
        return _AllReduceSum.apply(x, group)
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


def broadcast_(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """x of the group's rank `src` on every rank, in place: every other rank
    zeroes x and the group sums it. Every rank must pass the same shape and
    dtype."""
    if group is None:
        return x
    if index(group) != src:
        x.zero_()
    dist.all_reduce(x, group=group)
    return x


def gather(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """Every rank's x concatenated along `axis` in rank order, on every rank:
    each rank's x placed in zeros of `size` times its extent there and summed
    over the group (x itself without a group). Every rank must pass the same
    shape."""
    if group is None:
        return x
    axis = axis % x.dim()
    n, c = size(group), x.shape[axis]
    out = x.new_zeros(x.shape[:axis] + (n * c,) + x.shape[axis + 1:])
    out.narrow(axis, index(group) * c, c).copy_(x)
    dist.all_reduce(out, group=group)
    return out
