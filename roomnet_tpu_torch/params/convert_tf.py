"""Offline converter: the reference TF1 checkpoint -> the flat `.npz`
variables (port of roomnet_tpu/params/convert_tf.py).

TensorFlow is imported only inside `convert_tf_checkpoint`: it is an
offline tool for a host with TensorFlow (the card's host has none), and
every other module imports without it. The names follow
`schema.tf_name_map`.

    python -m roomnet_tpu_torch convert --tf-ckpt /path/to/final_model/roomnet \\
        --out artifacts/roomnet_params.npz
    python -m roomnet_tpu_torch.params.convert_tf --tf_ckpt /path/to/final_model/roomnet \\
        --out artifacts/roomnet_params.npz
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.roomnet import DEFAULT_CONFIG, RoomNetConfig, init_variables, param_count
from . import schema
from .checkpoint import save_flat

__all__ = ["convert_tf_checkpoint", "convert_file", "save_flat", "main"]

# Training-state variables of a TF1 checkpoint that are not model tensors.
_NOT_MODEL = ("train_step", "Adam", "power", "learn_rate")


def convert_tf_checkpoint(tf_ckpt_prefix: str, cfg: RoomNetConfig = DEFAULT_CONFIG) -> dict[str, np.ndarray]:
    """Read a TF1 TensorBundle checkpoint; our flat {path: f32 array}.
    Raises KeyError when a mapped variable is missing or a model variable
    is unmapped, and ValueError when the parameter count is not `cfg`'s
    (178,062 for roomnet-224)."""
    import tensorflow as tf  # offline tool only

    reader = tf.train.load_checkpoint(tf_ckpt_prefix)
    shape_map = reader.get_variable_to_shape_map()
    name_map = schema.tf_name_map(cfg)
    missing = [tf_name for tf_name in name_map.values() if tf_name not in shape_map]
    if missing:
        raise KeyError(f"TF checkpoint missing variables: {missing}")
    flat = {ours: np.asarray(reader.get_tensor(tf_name), dtype=np.float32) for ours, tf_name in name_map.items()}
    mapped = set(name_map.values())
    extra = [n for n in shape_map if n not in mapped and not any(s in n for s in _NOT_MODEL)]
    if extra:
        raise KeyError(f"Unmapped TF variables present: {extra}")
    n_params = sum(int(np.prod(v.shape)) for v in flat.values())
    expected = param_count(init_variables(torch.Generator().manual_seed(0), cfg))
    if n_params != expected:
        raise ValueError(f"expected {expected} params for this config, got {n_params}")
    return flat


def convert_file(tf_ckpt: str, out: str) -> int:
    """Convert `tf_ckpt` and write it with `save_flat` (the npz and its json
    manifest, the checkpoint's path under ``source_tf_ckpt``); returns the
    number of tensors. The body of the CLI's `convert` and of `main`."""
    flat = convert_tf_checkpoint(tf_ckpt)
    save_flat(flat, out, meta={"source_tf_ckpt": tf_ckpt})
    return len(flat)


def main(argv=None):
    """`python -m roomnet_tpu_torch.params.convert_tf`: the JAX module's
    flags, with the defaults of the CLI's `convert`."""
    from ..cli import build_parser

    defaults = build_parser().parse_args(["convert"])
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tf_ckpt", default=defaults.tf_ckpt)
    p.add_argument("--out", default=defaults.out)
    args = p.parse_args(argv)
    n = convert_file(args.tf_ckpt, args.out)
    print(f"converted {n} tensors -> {args.out}")


if __name__ == "__main__":
    main()
