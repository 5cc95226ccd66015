"""The model families the port serves, chosen by the configuration's type:
the one point where a configuration picks its weights' fold, its folded
forward, its input normalisation and its class labels (the classifier,
infer/classify.py, reaches a model through nothing else).

RoomNet (`RoomNetConfig`, models/roomnet.py) and ResNet-50 v1.5
(`ResNetConfig`, models/resnet.py). Serving (infer/server.py) and training
(train/) run RoomNet alone: `require_roomnet` is their check.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from .. import CLASS_LABELS
from . import resnet, roomnet


@dataclasses.dataclass(frozen=True)
class Family:
    name: str
    fold_variables: Callable  # (variables, cfg) -> folded operands, for normalised input
    forward_folded: Callable  # (folded, x, cfg) -> (logits, probs), f32
    normalize: Callable  # (x uint8 BGR NHWC on the device, cfg) -> the forward's input
    class_labels: Callable  # cfg -> list of names, one per class


ROOMNET = Family("roomnet", lambda v, cfg: roomnet.fold_variables(v, cfg, uint8_input=False),
                 roomnet.forward_folded, lambda x, cfg: roomnet.normalize_bgr_uint8(x), lambda cfg: list(CLASS_LABELS))
RESNET = Family("resnet", resnet.fold_variables, resnet.forward_folded, resnet.normalize_bgr_uint8,
                lambda cfg: cfg.class_labels)


def of(cfg) -> Family:
    """The family of a configuration."""
    if isinstance(cfg, roomnet.RoomNetConfig):
        return ROOMNET
    if isinstance(cfg, resnet.ResNetConfig):
        return RESNET
    raise TypeError(f"no model family for a {type(cfg).__name__}")


def require_roomnet(cfg, what: str) -> None:
    """Raise a clear error where `what` (a path that runs RoomNet alone) is
    given another model's configuration."""
    if not isinstance(cfg, roomnet.RoomNetConfig):
        raise TypeError(f"{what} runs RoomNet only; got a {type(cfg).__name__} "
                        f"(other models are served by the classifier's predict and predict_paths)")
