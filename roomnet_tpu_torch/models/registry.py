"""Model registry: named model configurations (port of
roomnet_tpu/models/registry.py, which holds RoomNet's alone).

RoomNet: the reference tried 300x300 and 600x600 inputs before settling on
224 (README.md:32); variants differ only in `im_side` (and so `flat_len`).
`roomnet-tiny` is the small test variant. ResNet-50 v1.5
(models/resnet.py): `resnet50-v1.5-224-bf16` at its published widths, and
`resnet50-tiny`, the CPU tests' (a stride-2 stage and projection shortcuts
at 32 pixels).
"""

from __future__ import annotations

import dataclasses

import torch

from .resnet import RESNET50, ResNetConfig
from .roomnet import DEFAULT_CONFIG, FAST_CONFIG, RoomNetConfig

Config = RoomNetConfig | ResNetConfig
_REGISTRY: dict[str, Config] = {}


def register(name: str, cfg: Config) -> Config:
    if name in _REGISTRY:
        raise KeyError(f"model '{name}' already registered")
    validate(cfg)
    _REGISTRY[name] = cfg
    return cfg


def get(name: str) -> Config:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model '{name}'; have {sorted(_REGISTRY)}") from None


def names() -> list[str]:
    return sorted(_REGISTRY)


def validate(cfg: Config) -> None:
    """Reject geometries the model cannot run: one check per family."""
    if isinstance(cfg, ResNetConfig):
        _validate_resnet(cfg)
    else:
        _validate_roomnet(cfg)


def _validate_resnet(cfg: ResNetConfig) -> None:
    """Every stage has a width and a depth, and the input survives the
    stem's two halvings and the stages' (one each past the first)."""
    if not (len(cfg.mid_widths) == len(cfg.depths) >= 1 and min(cfg.depths) >= 1 and min(cfg.mid_widths) >= 1):
        raise ValueError(f"mid_widths {cfg.mid_widths} and depths {cfg.depths} do not make stages")
    s = (cfg.im_side - 1) // 2 + 1  # the stem's conv
    s = (s - 1) // 2 + 1  # its max pool
    for _ in cfg.depths[1:]:
        s = (s - 1) // 2 + 1
    if cfg.im_side < 1 or s < 1:
        raise ValueError(f"im_side {cfg.im_side}: the network collapses below 1x1")


def _validate_roomnet(cfg: RoomNetConfig) -> None:
    """Reject geometries where a conv/pool window exceeds its input."""
    s = cfg.im_side
    for bi in range(len(cfg.block_filters)):
        for _ in range(cfg.block_depths[bi]):
            if s < cfg.kernel_size:
                raise ValueError(f"im_side {cfg.im_side}: conv input {s} < kernel")
            s -= cfg.kernel_size - 1
            if cfg.block_pools[bi] is not None:
                k, st = cfg.block_pools[bi]
                if s < k:
                    raise ValueError(f"im_side {cfg.im_side}: pool input {s} < {k}")
                s = (s - k) // st + 1
    if s < 1:
        raise ValueError("network collapses below 1x1")


def resolve(img_side: int, *, bf16: bool) -> RoomNetConfig:
    """The config for (geometry, precision): the registered entry when there
    is one, else one derived from the right base and validated."""
    name = f"roomnet-{img_side}" + ("-bf16" if bf16 else "")
    if name in _REGISTRY:
        return _REGISTRY[name]
    cfg = dataclasses.replace(FAST_CONFIG if bf16 else DEFAULT_CONFIG, im_side=img_side)
    validate(cfg)
    return cfg


register("roomnet-224", DEFAULT_CONFIG)
register("roomnet-224-bf16", FAST_CONFIG)
for _side in (300, 600):
    register(f"roomnet-{_side}", dataclasses.replace(DEFAULT_CONFIG, im_side=_side))
    register(f"roomnet-{_side}-bf16", dataclasses.replace(FAST_CONFIG, im_side=_side))
register("resnet50-v1.5-224-bf16", RESNET50)
register("resnet50-tiny", ResNetConfig(num_classes=10, im_side=32, stem_width=8, mid_widths=(4, 8),
                                       depths=(2, 1), compute_dtype=torch.float32))
register(
    "roomnet-tiny",
    RoomNetConfig(
        num_classes=6,
        im_side=32,
        block_filters=(8, 16),
        block_depths=(1, 2),
        block_pools=((3, 1), (4, 2)),
        dense_units=(16, 8),
    ),
)
