"""Process-group set-up (port of roomnet_tpu/parallel/distributed.py).

JAX's `jax.distributed.initialize` joins one process per host and lets XLA
insert the collectives. Here every process is one rank of a
`torch.distributed` process group, holding one device, and the port issues
its collectives itself (`parallel/collectives.py`). Launch one process per
card with torchrun, which sets WORLD_SIZE, RANK, LOCAL_RANK and
MASTER_ADDR/PORT:

    torchrun --nproc-per-node N -m roomnet_tpu_torch train --data-parallel ...

On one process this is a no-op, as in the JAX package; `parallel/mesh.py:
make_mesh` then starts a world of one itself.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

_device: torch.device | None = None  # this rank's device, set by initialize()
_single_dir: str | None = None  # start_single's FileStore directory


def local_device(device=None) -> torch.device:
    """This rank's device: the caller's, else the one `initialize` chose,
    else the card LOCAL_RANK names (cuda:0 without it); "cuda" without an
    index is that card too. Raises without a GPU and without an explicit
    device, as `default_device` does."""
    from .. import default_device

    if device is None and _device is not None:
        return _device
    dev = default_device(device)  # raises without a GPU and without a device
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None, device=None,
               timeout_s: float = 600.0) -> bool:
    """Join the process group when a multi-process launch is detected.

    Returns True when distributed mode is active. Safe to call
    unconditionally: without an explicit address, and without either
    COORDINATOR_ADDRESS or torchrun's WORLD_SIZE > 1 with MASTER_ADDR in the
    environment, it does nothing and returns False.

    coordinator_address: "host:port" (TCP), or any init_method URL
    ("tcp://...", "file:///path/store"). Without it the address is
    COORDINATOR_ADDRESS, or torchrun's environment (env://).
    num_processes / process_id: the world size and this rank; default
    WORLD_SIZE and RANK.
    backend: default "nccl" when this rank's device is cuda, else "gloo".
    NCCL refuses two ranks on one card; pass backend="gloo" there.
    device: this rank's device (`local_device`).
    timeout_s: how long a collective waits for its peers before it raises.
    """
    global _device
    env = os.environ
    torchrun = int(env.get("WORLD_SIZE", "1")) > 1 and bool(env.get("MASTER_ADDR"))
    address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if address is None and not torchrun:
        return False
    if dist.is_initialized():
        return True
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if address is None:
        init_method = "env://"
    else:
        init_method = address if "://" in address else f"tcp://{address}"
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method=init_method,
                            world_size=world, rank=rank, timeout=timedelta(seconds=timeout_s))
    _device = dev
    return True


def start_single(device=None) -> None:
    """A world of one over a FileStore in a temporary directory (removed by
    `shutdown`): the counterpart of a JAX mesh over one device. No-op inside
    a group."""
    global _device, _single_dir
    if dist.is_initialized():
        return
    import tempfile

    dev = local_device(device)
    _single_dir = tempfile.mkdtemp(prefix="roomnet_pg_")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{os.path.join(_single_dir, 'store')}", world_size=1, rank=0)
    _device = dev


def shutdown() -> None:
    """Leave the process group (no-op outside one)."""
    global _device, _single_dir
    if dist.is_initialized():
        dist.destroy_process_group()
    if _single_dir is not None:
        import shutil

        shutil.rmtree(_single_dir, ignore_errors=True)
    _device = _single_dir = None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(n_model: int = 1):
    """A mesh over every rank of the group (`make_mesh(n_model=n_model)`)."""
    from .mesh import make_mesh

    return make_mesh(n_model=n_model)
