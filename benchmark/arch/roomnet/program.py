"""RoomNet's only import of the program under test, `roomnet_tpu_torch`
(the PyTorch and CUDA port): its model configuration and its classifier.
Drivers reach the model through these names only (as `ctx.arch.program`);
the reference and the work counts never do.
"""

from __future__ import annotations

import torch


def model_config(cfg: dict):
    """The program's RoomNetConfig for a configuration file."""
    from roomnet_tpu_torch.models.roomnet import RoomNetConfig

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[cfg["precision"]]
    return RoomNetConfig(
        num_classes=cfg["num_classes"], im_side=cfg["im_side"],
        block_filters=tuple(cfg["block_filters"]), block_depths=tuple(cfg["block_depths"]),
        block_pools=tuple(tuple(p) if p else None for p in cfg["block_pools"]),
        kernel_size=cfg["kernel_size"], dense_units=tuple(cfg["dense_units"]),
        bn_eps=cfg["bn_eps"], compute_dtype=dtype)


def classifier(variables: dict, cfg: dict, batch_size: int, device):
    from roomnet_tpu_torch.infer.classify import RoomNetClassifier

    return RoomNetClassifier(variables, model_config(cfg), batch_size=batch_size, device=device)
