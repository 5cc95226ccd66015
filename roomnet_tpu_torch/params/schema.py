"""Variables <-> the flat ``{path: array}`` form (port of roomnet_tpu/params/schema.py).

The on-disk format is the JAX package's flat `.npz`, unchanged:

    blocks/<bi>/conv/<d>            conv kernel, HWIO
    blocks/<bi>/bn/<d>/{scale,bias,mean,var}
    blocks/<bi>/res_bn/{scale,bias,mean,var}
    dense/<di>/kernel               (in, out)
    dense/<di>/bias
    dense/<di>/bn/{scale,bias,mean,var}

The port keeps the same layouts in memory (HWIO kernels, NHWC activations),
so loading is a copy of each array and saving is bit-identical.

`tf_name_map` is the bijection to the reference TF1 checkpoint's variable
names (graph-construction order), which `params/convert_tf.py` and
`params/export_tf.py` use.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..models.roomnet import DEFAULT_CONFIG, RoomNetConfig, Variables

_BN_FIELDS = ("scale", "bias", "mean", "var")
_TF_BN_FIELDS = {"scale": "gamma", "bias": "beta", "mean": "moving_mean", "var": "moving_variance"}


def flatten_tensors(variables: Variables) -> dict[str, Any]:
    """Variables -> ``{path: leaf}`` with the leaves as they are (tensors
    stay tensors, autograd included): roomnet_tpu's `flatten_jax`."""
    out: dict[str, Any] = {}
    for bi, blk in enumerate(variables["blocks"]):
        for d, k in enumerate(blk["conv"]):
            out[f"blocks/{bi}/conv/{d}"] = k
        for d, bn in enumerate(blk["bn"]):
            for f in _BN_FIELDS:
                out[f"blocks/{bi}/bn/{d}/{f}"] = bn[f]
        if blk["res_bn"] is not None:
            for f in _BN_FIELDS:
                out[f"blocks/{bi}/res_bn/{f}"] = blk["res_bn"][f]
    for di, layer in enumerate(variables["dense"]):
        out[f"dense/{di}/kernel"] = layer["kernel"]
        if layer["bias"] is not None:
            out[f"dense/{di}/bias"] = layer["bias"]
        if layer["bn"] is not None:
            for f in _BN_FIELDS:
                out[f"dense/{di}/bn/{f}"] = layer["bn"][f]
    return out


def flatten_variables(variables: Variables) -> dict[str, np.ndarray]:
    """Variables -> ``{path: numpy array}`` on the host (the on-disk form)."""
    return {k: t.detach().cpu().numpy() for k, t in flatten_tensors(variables).items()}


def unflatten_variables(flat: dict[str, Any], cfg: RoomNetConfig = DEFAULT_CONFIG) -> Variables:
    """The inverse of `flatten_tensors` and `flatten_variables`: rebuilds the
    tree, leaves as given (roomnet_tpu's `unflatten_jax`)."""

    def bn_at(prefix):
        return {f: flat[f"{prefix}/{f}"] for f in _BN_FIELDS}

    blocks = [
        {
            "conv": [flat[f"blocks/{bi}/conv/{d}"] for d in range(depth)],
            "bn": [bn_at(f"blocks/{bi}/bn/{d}") for d in range(depth)],
            "res_bn": bn_at(f"blocks/{bi}/res_bn") if depth > 1 else None,
        }
        for bi, depth in enumerate(cfg.block_depths)
    ]
    dense = [
        {
            "kernel": flat[f"dense/{di}/kernel"],
            "bias": flat.get(f"dense/{di}/bias"),
            "bn": bn_at(f"dense/{di}/bn") if f"dense/{di}/bn/scale" in flat else None,
        }
        for di in range(len(cfg.dense_units) + 1)
    ]
    return {"blocks": blocks, "dense": dense}


def is_trainable_path(path: str) -> bool:
    """Trainable: kernels, biases, BN gamma and beta; frozen: the BN moving
    mean and variance (`tf.trainable_variables()` in the reference, which
    the L2 term of network.py:58 sums over)."""
    return not (path.endswith("/mean") or path.endswith("/var"))


def partition_flat(flat: dict[str, Any]) -> tuple[dict[str, Any], dict[str, Any]]:
    """Split a flat {path: leaf} dict into (trainable, frozen) dicts."""
    train = {k: v for k, v in flat.items() if is_trainable_path(k)}
    frozen = {k: v for k, v in flat.items() if not is_trainable_path(k)}
    return train, frozen


def variables_from_numpy(flat: dict[str, np.ndarray], cfg: RoomNetConfig = DEFAULT_CONFIG,
                         device=None) -> Variables:
    """The port's variables from the JAX package's parameters as numpy: the
    `.npz` dict, or `roomnet_tpu.params.schema.flatten_variables` of a JAX
    pytree. Both packages then compute the same function from the same
    weights. `device` defaults to `default_device()` (cuda, or raise)."""
    from .. import default_device

    dev = default_device(device)
    return unflatten_variables(
        {k: torch.from_numpy(np.array(v, copy=True)).to(dev) for k, v in flat.items()}, cfg
    )


def load_npz(path, cfg: RoomNetConfig = DEFAULT_CONFIG, device=None) -> Variables:
    with np.load(path) as data:
        return variables_from_numpy(dict(data), cfg, device)


def tf_name_map(cfg: RoomNetConfig = DEFAULT_CONFIG) -> dict[str, str]:
    """Our flat path -> the reference TF1 variable name: convs, BNs and
    denses numbered in the order the reference graph builds them
    (``conv2d``, ``conv2d_1``, ...; a block's residual BN after its convs'
    BNs; the dense head's BNs after every block's)."""
    mapping: dict[str, str] = {}
    conv_i = bn_i = 0

    def tf_suffix(i):
        return "" if i == 0 else f"_{i}"

    def bn_names(prefix: str, i: int):
        for ours, tf in _TF_BN_FIELDS.items():
            mapping[f"{prefix}/{ours}"] = f"batch_normalization{tf_suffix(i)}/{tf}"

    for bi, depth in enumerate(cfg.block_depths):
        for d in range(depth):
            mapping[f"blocks/{bi}/conv/{d}"] = f"conv2d{tf_suffix(conv_i)}/kernel"
            conv_i += 1
            bn_names(f"blocks/{bi}/bn/{d}", bn_i)
            bn_i += 1
        if depth > 1:
            bn_names(f"blocks/{bi}/res_bn", bn_i)
            bn_i += 1
    n_dense = len(cfg.dense_units) + 1
    for di in range(n_dense):
        mapping[f"dense/{di}/kernel"] = f"dense{tf_suffix(di)}/kernel"
        if di < n_dense - 1:
            bn_names(f"dense/{di}/bn", bn_i)
            bn_i += 1
    mapping[f"dense/{n_dense - 1}/bias"] = f"dense{tf_suffix(n_dense - 1)}/bias"
    return mapping
