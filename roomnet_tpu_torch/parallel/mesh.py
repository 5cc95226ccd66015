"""The rank mesh and placement descriptors (port of
roomnet_tpu/parallel/mesh.py).

Axes, as in the JAX package:
  * 'data'  — data parallelism over the batch. Each rank along it holds its
    rows of every global batch; the port's step computes the single-device
    function of the global batch (BN moments, loss and accuracy over every
    real row), as XLA does under `P("data")` shardings.
  * 'model' — tensor parallelism. `variables_shardings(...,
    tensor_parallel=True)` splits the dense kernels and block 4's conv on
    their output axis over it; `parallel/tensor.py` applies those placements
    in the training step (`make_train_step(..., tp=...)`), as GSPMD applies
    them to the JAX step. The Trainer, like the JAX Trainer, applies none:
    its ranks along 'model' hold the same rows and compute the same values.

A JAX mesh is an array of devices in one program; here it is an array of
ranks, one process each, with this rank's coordinates, its device, and the
process groups along its two axes for the collectives.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from . import distributed

__all__ = ["Mesh", "make_mesh", "NamedSharding", "batch_sharding", "replicated", "variables_shardings", "P"]


class Mesh:
    """An (n_data, n_model) grid of the group's ranks, rank = d * n_model + m.

    devices: the rank grid (the JAX mesh's device array); axis_names
    ("data", "model"); shape {"data": n_data, "model": n_model}; rank and
    coords (this rank's (d, m)); device (this rank's device). Its groups:
    the column `devices[:, m]` along 'data' and the row `devices[d, :]`
    along 'model'; an axis that spans the world is the world's group."""

    axis_names = ("data", "model")

    def __init__(self, n_data: int, n_model: int, device: torch.device):
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_data < 1 or n_model < 1 or n_data * n_model != world:
            raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks; the group has "
                             f"{world}, and every rank must be on the mesh")
        self.devices = np.arange(world).reshape(n_data, n_model)
        self.shape = {"data": n_data, "model": n_model}
        self.rank = rank
        self.coords = divmod(rank, n_model)
        self.device = torch.device(device)
        # dist.new_group is collective: every rank makes every group, in
        # one order (the data columns, then the model rows), and keeps its
        # own. An axis of size 1 makes groups of one rank, whose collectives
        # are copies: a world of one computes the same bits as no mesh.
        self._groups = {"data": self._axis_group([self.devices[:, m] for m in range(n_model)], self.coords[1]),
                        "model": self._axis_group([self.devices[d, :] for d in range(n_data)], self.coords[0])}

    @staticmethod
    def _axis_group(lines: list, mine: int):
        if len(lines) == 1:
            return dist.group.WORLD
        groups = [dist.new_group([int(r) for r in line]) for line in lines]
        return groups[mine]

    def group(self, axis: str = "data"):
        """The process group along this rank's `axis` ('data' or 'model')."""
        return self._groups[axis]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, rank={self.rank}, coords={self.coords}, device={self.device})"


def make_mesh(n_data: int | None = None, n_model: int = 1, *, devices=None) -> Mesh:
    """The mesh over every rank of the process group; without a group, a
    world of one over a FileStore (`distributed.start_single`).

    n_data: default world // n_model. devices: this rank's device (a device
    or its name), or a sequence of one device per rank; default
    `distributed.local_device()`.
    """
    if devices is None or isinstance(devices, (str, torch.device)):
        device = distributed.local_device(devices)
    else:
        device = None
    distributed.start_single(device)
    world = dist.get_world_size()
    if device is None:
        device = torch.device(list(devices)[dist.get_rank()])
    if n_data is None:
        n_data = world // n_model
    return Mesh(n_data, n_model, device)


class P(tuple):
    """A partition spec: one entry per array axis, a mesh axis name or None
    (replicated); `P()` replicates every axis."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where an array lives on the mesh: a descriptor, as JAX's is."""

    mesh: Mesh
    spec: P


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """The leading (batch) axis over 'data'; the rest replicated."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def variables_shardings(flat_paths, mesh: Mesh, *, tensor_parallel: bool = False) -> dict:
    """{path: NamedSharding} for a flat variable dict. With
    tensor_parallel=True, dense kernels split their output axis and the
    widest conv (128 channels, block 4) its output channels over 'model';
    everything else is replicated."""
    out = {}
    for path in flat_paths:
        spec = P()
        if tensor_parallel:
            if path.startswith("dense/") and path.endswith("/kernel"):
                spec = P(None, "model")
            elif path == "blocks/3/conv/0":  # 128-channel conv, HWIO last axis
                spec = P(None, None, None, "model")
        out[path] = NamedSharding(mesh, spec)
    return out
