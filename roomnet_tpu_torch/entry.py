"""Entry point: the port's counterpart of `__graft_entry__.entry`.

``fn, (variables, x) = entry()`` gives the flagship serving call — the
converted reference checkpoint (artifacts/roomnet_params.npz) under the
bf16 FAST_CONFIG — and an example uint8 BGR batch of 8 images at 224², both
on the device. ``fn(variables, x) -> (class ids, probs)``.

    python -m roomnet_tpu_torch.entry   # runs it once on the card
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from . import default_device
from .models.roomnet import FAST_CONFIG, normalize_bgr_uint8, predict
from .params.schema import load_npz

CHECKPOINT = pathlib.Path(__file__).resolve().parents[1] / "artifacts" / "roomnet_params.npz"


def entry(device=None):
    dev = default_device(device)
    variables = load_npz(CHECKPOINT, FAST_CONFIG, dev)

    def fn(variables, x_bgr_uint8):
        return predict(variables, normalize_bgr_uint8(x_bgr_uint8), FAST_CONFIG)

    x = np.random.RandomState(0).randint(0, 256, size=(8, 224, 224, 3), dtype=np.uint8)
    return fn, (variables, torch.from_numpy(x).to(dev))


if __name__ == "__main__":
    fn, args = entry()
    ids, _ = fn(*args)
    print("entry OK:", ids.cpu().numpy())
