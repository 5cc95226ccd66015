"""ResNet-50's only import of the program under test, `roomnet_tpu_torch`
(the PyTorch and CUDA port): its model configuration and its classifier.
Drivers reach the model through these names only (as `ctx.arch.program`);
the reference and the work counts never do.
"""

from __future__ import annotations

import torch


def model_config(cfg: dict):
    """The program's ResNetConfig for a configuration file."""
    from roomnet_tpu_torch.models.resnet import ResNetConfig

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[cfg["precision"]]
    return ResNetConfig(
        num_classes=cfg["num_classes"], im_side=cfg["im_side"], stem_width=cfg["stem_width"],
        mid_widths=tuple(cfg["mid_widths"]), depths=tuple(cfg["depths"]), expansion=cfg["expansion"],
        stride_on_3x3=cfg["stride_on"] == "3x3", bn_eps=cfg["bn_eps"], mean=tuple(cfg["mean"]),
        std=tuple(cfg["std"]), compute_dtype=dtype)


def classifier(variables: dict, cfg: dict, batch_size: int, device):
    from roomnet_tpu_torch.infer.classify import Classifier

    return Classifier(variables, model_config(cfg), batch_size=batch_size, device=device)
