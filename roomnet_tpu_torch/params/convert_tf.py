"""Offline converter: the reference TF1 checkpoint -> the flat `.npz`
variables (port of roomnet_tpu/params/convert_tf.py).

TensorFlow is imported only inside `convert_tf_checkpoint`: it is an
offline tool for a host with TensorFlow (the card's host has none), and
every other module imports without it. The names follow
`schema.tf_name_map`.

    python -m roomnet_tpu_torch convert --tf-ckpt /path/to/final_model/roomnet \\
        --out artifacts/roomnet_params.npz
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.roomnet import DEFAULT_CONFIG, RoomNetConfig, init_variables, param_count
from . import schema

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
