"""Batched classification on the card (the device call of
roomnet_tpu/infer/classify.py:115-141).

A uint8 BGR batch goes to the device, through the reference preprocess
(BGR->RGB, [-1,1]) and the forward, and comes back as (class ids, probs).
The kernel operands (cast convs, folded BNs, the packed head) are prepared
once at construction. Host-side image decode (`_load`, `predict_paths`,
`classify_im_dir`) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..models.roomnet import DEFAULT_CONFIG, fold_variables, forward_folded, normalize_bgr_uint8


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return None if tree is None else tree.to(device)


class RoomNetClassifier:
    """Batched classifier over converted params (optimized-inference mode)."""

    def __init__(self, variables, cfg=DEFAULT_CONFIG, *, batch_size: int = 64, device=None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.device = default_device(device)
        self.cfg = cfg
        self.batch_size = batch_size
        self.variables = _to_device(variables, self.device)
        self._folded = fold_variables(self.variables, cfg, uint8_input=False)

    def _predict(self, x_uint8_bgr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One device batch: (ids, probs) tensors on the device."""
        _, probs = forward_folded(self._folded, normalize_bgr_uint8(x_uint8_bgr), self.cfg)
        return probs.argmax(dim=-1), probs

    def predict(self, x_uint8_bgr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(N,S,S,3) uint8 BGR on the host -> (ids (N,), probs (N, classes)),
        in device batches of at most `batch_size`."""
        x = np.asarray(x_uint8_bgr)
        side = self.cfg.im_side
        if x.dtype != np.uint8 or x.ndim != 4 or x.shape[1:] != (side, side, 3):
            raise ValueError(f"expected (N,{side},{side},3) uint8, got {x.shape} {x.dtype}")
        ids, probs = [], []
        for i in range(0, len(x), self.batch_size):
            xb = torch.from_numpy(x[i: i + self.batch_size]).to(self.device, non_blocking=True)
            bid, bprobs = self._predict(xb)
            ids.append(bid.cpu().numpy())
            probs.append(bprobs.cpu().numpy())
        return np.concatenate(ids), np.concatenate(probs)
