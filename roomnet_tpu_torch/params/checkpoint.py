"""Checkpoint store with the reference's Saver semantics (port of
roomnet_tpu/params/checkpoint.py).

Reference behaviours kept (network.py:77-126):
  * keep-all: every save is retained (`max_to_keep=0`, network.py:80);
  * names carry validation accuracy and step: ``roomnet--{acc}--{step}.npz``
    (network.py:98-102);
  * resume-latest: load() with no path picks the max step from the file
    names (network.py:110-118);
  * partial restore: `restore_head=False` leaves the dense head out, so a
    changed `flat_len` re-initialises it (network.py:78, :242);
  * the inference export strips the optimizer state (network.py:94-97).

The files are the JAX package's, byte for byte in layout: a flat
``{path: array}`` npz (params/schema.py), the optimizer state under
``opt/`` in the JAX package's key names (``opt/count``, ``opt/mu/<path>``,
``opt/nu/<path>``; train/optimizer.py:flatten_opt_state) and the step under
``meta/step``. A checkpoint written by either package loads in the other.

The sharded, asynchronous store is `params/orbax_io.py` (DCP directories);
`open_store` picks the store a model dir holds.
"""

from __future__ import annotations

import json
import os
import re
import time
from glob import glob
from typing import Any

import numpy as np
import torch

from ..models.roomnet import DEFAULT_CONFIG, RoomNetConfig, Variables
from . import schema

CKPT_RE = re.compile(r"roomnet--(?P<suffix>.*?)--(?P<step>\d+)\.npz$")


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_flat(flat: dict[str, np.ndarray], out_path: str, meta: dict | None = None):
    """The npz and its ``roomnet_tpu_flat_npz_v1`` json manifest (a copy of
    roomnet_tpu/params/convert_tf.py:save_flat, the one writer of that
    format in each package)."""
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, **flat)
    manifest = {
        "format": "roomnet_tpu_flat_npz_v1",
        "num_params": int(sum(int(np.prod(v.shape)) for v in flat.values())),
        "tensors": {k: list(v.shape) for k, v in sorted(flat.items())},
    }
    if meta:
        manifest.update(meta)
    with open(os.path.splitext(out_path)[0] + ".json", "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)


def open_store(model_dir: str):
    """The model dir's store, as the JAX package detects it: npz files win
    if present; else a dir of DCP checkpoint directories is an
    `OrbaxCheckpointStore` (synchronous saves); else an npz store, empty
    until its first save. A dir of the JAX package's orbax directories
    raises `orbax_io.JaxOrbaxCheckpoint`, naming them."""
    if glob(os.path.join(model_dir, "roomnet--*--*.npz")):
        return CheckpointStore(model_dir)
    from . import orbax_io

    orbax_io.refuse_jax_orbax(orbax_io.jax_orbax_dirs(model_dir))
    if glob(os.path.join(model_dir, "roomnet--*--*", orbax_io.DCP_METADATA)):
        return orbax_io.OrbaxCheckpointStore(model_dir, async_save=False)
    return CheckpointStore(model_dir)


class CheckpointStore:
    def __init__(self, model_dir: str = "all_trained_models/trained_models"):
        self.model_dir = model_dir
        os.makedirs(model_dir, exist_ok=True)
        # Sweep leftovers of interrupted atomic saves. Age-gated: a second
        # process on a live training dir must not delete the trainer's
        # in-flight tmp file out from under its os.replace.
        cutoff = time.time() - 3600.0
        for p in glob(os.path.join(model_dir, "*.tmp.npz")):
            try:
                if os.path.getmtime(p) < cutoff:
                    os.unlink(p)
            except OSError:
                pass

    def _path(self, step: int, suffix: str | None) -> str:
        sfx = suffix if suffix is not None else "none"
        return os.path.join(self.model_dir, f"roomnet--{sfx}--{step}.npz")

    def save(self, variables: Variables, step: int, *, suffix: str | None = None,
             opt_state_flat: dict[str, Any] | None = None) -> str:
        """Save variables (and optimizer state, tensors or arrays, under its
        flat keys). Keep-all semantics."""
        flat = schema.flatten_variables(variables)
        for k, v in (opt_state_flat or {}).items():
            flat[f"opt/{k}"] = _numpy(v)
        flat["meta/step"] = np.asarray(step, dtype=np.int64)
        path = self._path(step, suffix)
        # Atomic write: resume-latest picks the max-step file, so an
        # interrupted save must never leave a truncated one. The temp name
        # keeps the .npz extension, which np.savez would otherwise append.
        tmp = path[: -len(".npz")] + ".tmp.npz"
        np.savez(tmp, **flat)
        os.replace(tmp, path)
        return path

    def list_checkpoints(self) -> list[tuple[int, str, str]]:
        """Every checkpoint in the dir as (step, suffix, path), step-sorted.
        The suffix is the accuracy string of a regular save, or a marker
        ('interrupt', 'stall', 'none')."""
        out = []
        for p in glob(os.path.join(self.model_dir, "roomnet--*--*.npz")):
            m = CKPT_RE.search(os.path.basename(p))
            if m:
                out.append((int(m.group("step")), m.group("suffix"), p))
        out.sort(key=lambda t: (t[0], t[2]))
        return out

    def prune(self, keep_last: int, *, keep_best: bool = True) -> list[str]:
        """Opt-in retention: delete all but the newest `keep_last` regular
        checkpoints. Markers (non-numeric suffix) are never deleted, nor,
        with keep_best, the max-accuracy save. Returns the deleted paths."""
        if keep_last < 1:
            raise ValueError("keep_last must be >= 1")
        regular = []
        for step, suffix, path in self.list_checkpoints():
            try:
                acc = float(suffix)
            except ValueError:
                continue
            regular.append((step, acc, path))
        keep = {p for _, _, p in regular[-keep_last:]}
        if keep_best and regular:
            keep.add(max(regular, key=lambda t: (t[1], t[0]))[2])
        deleted = []
        for _, _, p in regular:
            if p in keep:
                continue
            try:
                self._delete(p)
                deleted.append(p)
            except OSError:
                pass  # a racing reader holding the file open is fine
        return deleted

    _delete = staticmethod(os.remove)

    def latest_path(self) -> str | None:
        """The max-step checkpoint in the dir, from the file names."""
        ckpts = self.list_checkpoints()
        return max(ckpts, key=lambda t: t[0])[2] if ckpts else None

    def load(self, path: str | None = None, *, cfg: RoomNetConfig = DEFAULT_CONFIG,
             restore_head: bool = True, with_opt_state: bool = False):
        """(var_flat, step[, opt_flat]) as numpy dicts, or None when `path`
        is None and the dir holds no checkpoint (resume-latest).

        restore_head=False drops the ``dense/*`` tensors and the optimizer
        state (the reference's `restore_excluded_vars`, network.py:78); the
        caller merges over fresh variables with `merge_partial_restore`.
        `cfg` is the JAX package's signature; the flat dict needs none.
        """
        del cfg
        if path is None:
            path = self.latest_path()
            if path is None:
                return None
        with np.load(path) as data:
            raw = dict(data)
        step = int(raw.pop("meta/step", np.asarray(0)))
        opt_flat = {k[len("opt/"):]: v for k, v in raw.items() if k.startswith("opt/")}
        var_flat = {k: v for k, v in raw.items() if not k.startswith(("opt/", "meta/"))}
        if not restore_head:
            var_flat = {k: v for k, v in var_flat.items() if not k.startswith("dense/")}
            opt_flat = {}
        if with_opt_state:
            return var_flat, step, opt_flat
        return var_flat, step

    def export_inference(self, variables: Variables, out_path: str) -> str:
        """Params only, no optimizer state, with the flat-npz manifest."""
        save_flat(schema.flatten_variables(variables), out_path)
        return out_path


def merge_partial_restore(fresh_variables: Variables, restored_flat: dict[str, Any],
                          cfg: RoomNetConfig = DEFAULT_CONFIG) -> Variables:
    """Overlay restored tensors onto freshly initialised variables, on the
    fresh tree's devices.

    Keys the config does not define, and tensors whose shape differs, are
    skipped with a warning and keep the fresh initialisation (a changed
    `flat_len` re-initialises the head, network.py:78, :242)."""
    from ..utils.logging import get_logger

    log = get_logger("checkpoint")
    flat = schema.flatten_tensors(fresh_variables)
    for k, v in restored_flat.items():
        if k not in flat:
            log.warning("partial restore: skipping %s (not in the current model)", k)
            continue
        arr = _numpy(v)
        if tuple(flat[k].shape) != arr.shape:
            log.warning("partial restore: skipping %s (checkpoint %s vs model %s) — keeping fresh init",
                        k, arr.shape, tuple(flat[k].shape))
            continue
        flat[k] = torch.from_numpy(np.array(arr, copy=True)).to(flat[k].device)
    return schema.unflatten_variables(flat, cfg)
