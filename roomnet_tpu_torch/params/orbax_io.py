"""The sharded, asynchronous checkpoint store (port of
roomnet_tpu/params/orbax_io.py), backed by `torch.distributed.checkpoint`
(DCP). It keeps the JAX class's name and surface, so `ckpt_backend="orbax"`
and `--ckpt-backend orbax` keep their meaning, and the reference Saver's
semantics (keep-all, acc+step names, resume-latest; network.py:77-126).

A checkpoint is a directory ``roomnet--{suffix}--{step}`` holding DCP's
``.metadata`` and ``*.distcp`` files, with the npz store's flat keys: the
variable paths, ``opt/<key>`` and ``meta/step``. Under a process group the
save is collective: every rank calls it, each replicated tensor is written
once, and rank 0 writes ``.metadata`` last, so a directory without it is an
unfinished save and is not listed. `async_save=True` returns once the
tensors are copied to host memory and writes in a thread; `wait()` blocks
until the write has landed. The save's collectives run over a gloo group of
the store's own, made at the first save, so that a write in flight never
interleaves with the training step's collectives. Loading reads every file
on one process, whatever the topology that wrote it.

The JAX package's orbax directories (OCDBT, written by orbax) are not DCP
and are not read: the store and `params/checkpoint.py:open_store` refuse
them by name. Convert one with the JAX package: load it with
`roomnet_tpu.params.orbax_io.OrbaxCheckpointStore` and save it with its
npz `CheckpointStore`, which both packages read.
"""

from __future__ import annotations

import os
import re
import shutil
from glob import glob
from typing import Any

import numpy as np
import torch

from ..models.roomnet import DEFAULT_CONFIG, RoomNetConfig
from . import schema
from .checkpoint import CheckpointStore as _NpzStore
from .checkpoint import _numpy

CKPT_DIR_RE = re.compile(r"roomnet--(?P<suffix>.*?)--(?P<step>\d+)$")
DCP_METADATA = ".metadata"
# Files of an orbax checkpoint directory (the JAX package's store).
JAX_ORBAX_FILES = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


class JaxOrbaxCheckpoint(RuntimeError):
    """A checkpoint directory written by the JAX package's orbax store."""


def is_jax_orbax_dir(path: str) -> bool:
    return (os.path.isdir(path) and not os.path.exists(os.path.join(path, DCP_METADATA))
            and any(os.path.exists(os.path.join(path, f)) for f in JAX_ORBAX_FILES))


def jax_orbax_dirs(model_dir: str) -> list[str]:
    return sorted(p for p in glob(os.path.join(model_dir, "roomnet--*--*"))
                  if CKPT_DIR_RE.search(os.path.basename(p)) and is_jax_orbax_dir(p))


def refuse_jax_orbax(paths: list[str]) -> None:
    if paths:
        raise JaxOrbaxCheckpoint(
            f"{paths[0]}{f' (and {len(paths) - 1} more)' if len(paths) > 1 else ''} was written by the JAX "
            "package's orbax store, which this package does not read (its DCP directories are another format). "
            "Convert it with roomnet_tpu: load it with roomnet_tpu.params.orbax_io.OrbaxCheckpointStore, then "
            "save it with roomnet_tpu.params.checkpoint.CheckpointStore (npz, read by both packages)")


class OrbaxCheckpointStore:
    """The CheckpointStore surface over DCP directories (module docstring)."""

    def __init__(self, model_dir: str = "all_trained_models/trained_models_orbax", *, async_save: bool = True):
        self.model_dir = os.path.abspath(model_dir)
        os.makedirs(self.model_dir, exist_ok=True)
        refuse_jax_orbax(jax_orbax_dirs(self.model_dir))
        self.async_save = async_save
        self._pending = None  # the in-flight async save
        self._group = None  # the gloo group of collective saves, made at the first (by every rank at once)

    def _path(self, step: int, suffix: str | None) -> str:
        sfx = suffix if suffix is not None else "none"
        return os.path.join(self.model_dir, f"roomnet--{sfx}--{step}")

    def save(self, variables: Any, step: int, *, suffix: str | None = None,
             opt_state_flat: dict | None = None) -> str:
        """Save variables (and the optimizer state under its flat keys);
        collective under a process group. An earlier async save is waited
        for first."""
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        flat = {k: torch.from_numpy(np.array(v)) for k, v in schema.flatten_variables(variables).items()}
        for k, v in (opt_state_flat or {}).items():
            flat[f"opt/{k}"] = torch.from_numpy(np.array(_numpy(v)))
        flat["meta/step"] = torch.tensor(step, dtype=torch.int64)
        path = self._path(step, suffix)
        self.wait()
        if dist.is_initialized() and self._group is None:
            self._group = dist.new_group(backend="gloo")
        # Without a process group DCP saves on this process alone.
        kw = dict(checkpoint_id=path, process_group=self._group)
        if self.async_save:
            self._pending = dcp.async_save(flat, **kw)
        else:
            dcp.save(flat, **kw)
        return path

    def wait(self):
        """Block until the in-flight async save (if any) has landed."""
        pending, self._pending = self._pending, None
        if pending is not None:
            getattr(pending, "upload_completion", pending).result()

    def list_checkpoints(self) -> list[tuple[int, str, str]]:
        """Every finished checkpoint dir as (step, suffix, path), step-sorted."""
        out = []
        for p in glob(os.path.join(self.model_dir, "roomnet--*--*")):
            m = CKPT_DIR_RE.search(os.path.basename(p))
            if m and os.path.isfile(os.path.join(p, DCP_METADATA)):
                out.append((int(m.group("step")), m.group("suffix"), p))
        out.sort(key=lambda t: (t[0], t[2]))
        return out

    # The npz store's retention, shared: only _delete differs, since a
    # checkpoint here is a directory.
    prune = _NpzStore.prune

    @staticmethod
    def _delete(path: str):
        shutil.rmtree(path)

    def latest_path(self) -> str | None:
        ckpts = self.list_checkpoints()
        return max(ckpts, key=lambda t: t[0])[2] if ckpts else None

    def load(self, path: str | None = None, *, cfg: RoomNetConfig = DEFAULT_CONFIG,
             restore_head: bool = True, with_opt_state: bool = False):
        """(var_flat, step[, opt_flat]) as host numpy, or None when `path` is
        None and the dir holds no finished checkpoint. Read on this process
        alone, whatever topology wrote it; the target is built from the
        checkpoint's own metadata. `cfg` is the JAX package's signature."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.metadata import TensorStorageMetadata

        del cfg
        if path is None:
            path = self.latest_path()
            if path is None:
                return None
        refuse_jax_orbax([path] if is_jax_orbax_dir(path) else [])
        meta = dcp.FileSystemReader(path).read_metadata()
        target = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
                  for k, m in meta.state_dict_metadata.items() if isinstance(m, TensorStorageMetadata)}
        dcp.load(target, checkpoint_id=path, no_dist=True)
        raw = {k: v.numpy() for k, v in target.items()}
        step = int(raw.pop("meta/step", np.asarray(0)))
        opt_flat = {k[len("opt/"):]: v for k, v in raw.items() if k.startswith("opt/")}
        var_flat = {k: v for k, v in raw.items() if not k.startswith(("opt/", "meta/"))}
        if not restore_head:
            var_flat = {k: v for k, v in var_flat.items() if not k.startswith("dense/")}
            opt_flat = {}
        if with_opt_state:
            return var_flat, step, opt_flat
        return var_flat, step
