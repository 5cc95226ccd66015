"""Functional building blocks with reference-exact op semantics (NHWC, HWIO).

Port of roomnet_tpu/ops/blocks.py (inference pieces; training-mode BN and
dropout come with the training port):
  * Conv2D: 3x3, stride 1, VALID padding, no bias; ReLU6 is the conv's
    activation, so it precedes pooling — reference network.py:184-186.
  * AvgPool: VALID, sum then divide (TF AvgPool's rounding) — network.py:189.
  * BatchNorm after activation and pool, eps 1e-3 — network.py:193.
  * Dense: bias on the last layer only; ReLU6 on every layer, the logits
    included — network.py:212-214.

f32 parity on a GPU needs TF32 off (`torch.backends.cudnn.allow_tf32` and
`torch.backends.cuda.matmul.allow_tf32` False): TF32 moves logits by ~5e-2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["BN_EPS", "BN_MOMENTUM", "relu6", "conv2d_valid", "avg_pool_valid",
           "bn_fold", "batch_norm", "dense"]

BN_EPS = 1e-3  # tf.layers.batch_normalization default (reference network.py:193)
BN_MOMENTUM = 0.99  # moving-average momentum, tf.layers default


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def conv2d_valid(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """NHWC x HWIO -> NHWC conv, VALID padding, no bias, output in x.dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.to(x.dtype).permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1).contiguous()


def avg_pool_valid(x: torch.Tensor, ksize: int, stride: int) -> torch.Tensor:
    """Average pool, VALID: the window sum divided by k*k (not multiplied by
    1/k², which differs by an ulp at k=3)."""
    summed = F.avg_pool2d(x.permute(0, 3, 1, 2), ksize, stride, divisor_override=1)
    return (summed / (ksize * ksize)).permute(0, 2, 3, 1).contiguous()


def bn_fold(bn: dict, eps: float = BN_EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold moving-stats BN into one f32 affine ``y = x*w + b`` — the one fold
    that every kernel wrapper and the plain path use."""
    scale = bn["scale"].float()
    inv = torch.rsqrt(bn["var"].float() + eps)
    w = scale * inv
    b = bn["bias"].float() - bn["mean"].float() * scale * inv
    return w, b


def batch_norm(x: torch.Tensor, bn: dict, eps: float = BN_EPS) -> torch.Tensor:
    """Inference-mode BN from the stored moving statistics, in x.dtype."""
    w, b = bn_fold(bn, eps)
    return x * w.to(x.dtype) + b.to(x.dtype)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ kernel.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y
