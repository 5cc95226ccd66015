"""Tensor parallelism over the mesh's 'model' axis: what GSPMD does for the
JAX package, done by hand.

The JAX package places the variables with `variables_shardings(...,
tensor_parallel=True)` (`parallel/mesh.py`): every dense kernel and block
4's conv split on their output axis over 'model', the rest replicated. XLA
then partitions the jitted step and inserts the collectives those
placements imply. Here each rank holds its contiguous slice of every split
leaf, and of its Adam moments (`shard_flat`, `shard_train_state`), and the
forward applies the placements by path (`models/roomnet.py:forward`'s `tp`):

  * a conv kernel split on its output channels runs column-parallel:
    `gather_model(conv3x3(copy_to_model(x), k_local), -1)`. The conv kernel
    launches on this rank's output channels; every rank then holds all of
    them and computes the same function downstream;
  * a split dense kernel is gathered whole (`gather_model(k, -1)`) before
    the head, which stays one launch.

Both collectives are all-reduces (the gather zero-padded,
`collectives.gather`), so they run on NCCL and on gloo alike. With `group=None` ("no group") they are
the identity, and over a group of one rank they copy: a world of one
computes the same bits as no mesh.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from . import collectives as C


def split_axes(shardings: dict) -> dict[str, int]:
    """{path: axis} of every leaf whose NamedSharding's spec names 'model'
    (one axis each)."""
    out = {}
    for path, sharding in shardings.items():
        axes = [i for i, a in enumerate(sharding.spec) if a == "model"]
        if len(axes) > 1:
            raise ValueError(f"{path}: split over 'model' on {len(axes)} axes; one is supported")
        if axes:
            out[path] = axes[0]
    return out


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The placements the forward applies: {path: axis split over 'model'}
    and this rank's group along 'model' (None: no group)."""

    axes: dict
    group: object = None


def tensor_parallel(shardings: dict, mesh) -> TensorParallel:
    """The forward's and the step's `tp` for `shardings` on `mesh`."""
    return TensorParallel(split_axes(shardings), mesh.group("model"))


def _local_slice(t: torch.Tensor, axis: int, n: int, i: int, path: str) -> torch.Tensor:
    if t.shape[axis] % n:
        raise ValueError(f"{path}: axis {axis} of {tuple(t.shape)} does not split over {n} ranks along 'model'")
    c = t.shape[axis] // n
    return t.narrow(axis, i * c, c).clone()


def shard_flat(flat: dict, shardings: dict, mesh) -> dict:
    """This rank's slice of every leaf that `shardings` splits over 'model'
    (contiguous along the split axis, rank m of the row holding slice m);
    other leaves as they are. Raises ValueError where mesh.shape["model"]
    does not divide that axis."""
    axes, n, i = split_axes(shardings), int(mesh.shape["model"]), int(mesh.coords[1])
    return {k: _local_slice(v, axes[k], n, i, k) if k in axes else v for k, v in flat.items()}


def unshard_flat(local: dict, shardings: dict, mesh) -> dict:
    """The whole tensors from every rank's slices, on every rank (detached).
    A collective over 'model': every rank of the row must call it."""
    axes, group = split_axes(shardings), mesh.group("model")
    return {k: C.gather(v.detach(), group, axes[k]) if k in axes else v for k, v in local.items()}


def shard_train_state(state, shardings: dict, mesh):
    """A TrainState holding this rank's slices of the split trainable leaves
    and of their Adam moments; the BN moving stats and the count stay
    replicated, as in the JAX package."""
    opt = state.opt_state
    return state._replace(train_vars=shard_flat(state.train_vars, shardings, mesh),
                          opt_state=opt._replace(mu=shard_flat(opt.mu, shardings, mesh),
                                                 nu=shard_flat(opt.nu, shardings, mesh)))


def unshard_train_state(state, shardings: dict, mesh):
    """The inverse of `shard_train_state`, on every rank (a collective)."""
    opt = state.opt_state
    return state._replace(train_vars=unshard_flat(state.train_vars, shardings, mesh),
                          opt_state=opt._replace(mu=unshard_flat(opt.mu, shardings, mesh),
                                                 nu=unshard_flat(opt.nu, shardings, mesh)))


class _GatherModel(torch.autograd.Function):
    """Forward: every rank's slice along `axis`. Backward: this rank's slice
    of the incoming gradient, not summed: every rank computes the same
    function downstream, so the incoming gradients are already equal."""

    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.index, ctx.width = axis % x.dim(), C.index(group), x.shape[axis]
        return C.gather(x.contiguous(), group, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.axis, ctx.index * ctx.width, ctx.width).contiguous(), None, None


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity. Backward: the incoming gradient summed over
    the group (each rank's holds only its output channels' part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def gather_model(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """x of every rank of `group` concatenated along `axis`, under autograd
    (x itself without a group)."""
    if group is None:
        return x
    return _GatherModel.apply(x, axis, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """x, whose gradient is summed over `group` (x itself without a group)."""
    if group is None:
        return x
    return _CopyToModel.apply(x, group)
