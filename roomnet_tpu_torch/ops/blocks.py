"""Functional building blocks with reference-exact op semantics (NHWC, HWIO).

Port of roomnet_tpu/ops/blocks.py:
  * Conv2D: 3x3, stride 1, VALID padding, no bias; ReLU6 is the conv's
    activation, so it precedes pooling — reference network.py:184-186.
  * AvgPool: VALID, sum then divide (TF AvgPool's rounding) — network.py:189.
  * BatchNorm after activation and pool, eps 1e-3 — network.py:193.
  * Dense: bias on the last layer only; ReLU6 on every layer, the logits
    included — network.py:212-214.
  * Training-mode BN normalizes with the batch's own moments (two-pass f32
    variance, optionally weighted by row), and dropout is inverted dropout
    after every block — network.py:193, 204-206, 219-221.

Gradients are JAX's: `relu6` is max then min, whose derivative at a tie
(x == 0 or x == 6) is 0.5 in both frameworks, where `torch.clamp`'s is 1.

f32 parity on a GPU needs TF32 off (`torch.backends.cudnn.allow_tf32` and
`torch.backends.cuda.matmul.allow_tf32` False): TF32 moves logits by ~5e-2.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..parallel import collectives as C

__all__ = ["BN_EPS", "BN_MOMENTUM", "BNStats", "relu6", "conv2d_valid", "avg_pool_valid",
           "bn_fold", "batch_norm", "batch_norm_train", "dense", "dropout", "full_f32"]

BN_EPS = 1e-3  # tf.layers.batch_normalization default (reference network.py:193)
BN_MOMENTUM = 0.99  # moving-average momentum, tf.layers default


class BNStats(NamedTuple):
    """Batch statistics of one training-mode BN application."""

    mean: torch.Tensor
    var: torch.Tensor  # biased (used for normalizing)
    var_unbiased: torch.Tensor  # Bessel-corrected (used for the moving update)


@contextlib.contextmanager
def full_f32():
    """Turn TF32 off for cuDNN convolutions and cuBLAS products inside the
    block, and restore both flags after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(max(x, 0), 6): under autograd, 0.5 at x == 0 and x == 6, as
    `jax.grad` of `jnp.clip` gives."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), 6.0))


def conv2d_valid(x: torch.Tensor, kernel: torch.Tensor, *, stride: int = 1, accum_dtype=None) -> torch.Tensor:
    """NHWC x HWIO -> NHWC conv, VALID padding, no bias, output in x.dtype.
    The kernel is rounded to x.dtype; the products are summed in
    `accum_dtype`, default float32 for bf16 and f32 inputs (the promotion of
    x.dtype with float32)."""
    acc = accum_dtype or torch.promote_types(x.dtype, torch.float32)
    k = kernel.to(x.dtype).to(acc).permute(3, 2, 0, 1)
    y = F.conv2d(x.to(acc).permute(0, 3, 1, 2), k, stride=stride)
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


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


def batch_norm_train(x: torch.Tensor, bn: dict, eps: float = BN_EPS, row_weights: torch.Tensor | None = None,
                     group=None) -> tuple[torch.Tensor, BNStats]:
    """Training-mode BN over every axis but the last, in f32 and rounded
    once to x.dtype (`tf.layers.batch_normalization(training=True)`). The
    JAX package applies the affine in x.dtype; in bf16 the backward's
    rounded sums then lose much of the gradient through the batch moments,
    which nearly cancels the direct term, and the CE gradients leave JAX
    bf16's own distance from f32
    (tests/test_torch_train.py::test_bf16_ce_grads_within_the_jax_bf16_distance).

    The variance is two-pass (the mean of squared deviations), biased for
    normalizing and Bessel-corrected in the returned stats. `row_weights`,
    a float (B,) of 1.0 (real row) and 0.0 (padding), weights the moments so
    that the statistics are those of the real rows alone; with no real row
    the denominator is clamped to one row and mean = var = 0.

    `group`, a mesh's data group: the moments are those of the global batch,
    every rank's rows (the single-device function, as XLA computes it under
    a `P("data")` sharding). The sums and the row count are all-reduced, then
    the centered sum of squares; the all-reduce is differentiable, so the
    gradient through the moments reaches every rank's rows. Every rank holds
    the same number of rows.
    """
    axes = tuple(range(x.ndim - 1))
    x32 = x.float()
    per_row = math.prod(x.shape[1:-1])
    # One formula with and without row weights (and the same bits for
    # weights of all ones): the count is a device tensor either way, so
    # every division is a true division, also on the card.
    if row_weights is None:
        w, xw, rows = None, x32, x32.new_full((1,), float(x.shape[0]))
    else:
        w = row_weights.float().reshape((-1,) + (1,) * (x.ndim - 1))
        xw, rows = x32 * w, row_weights.float().sum().reshape(1)
    packed = C.all_reduce_sum(torch.cat([xw.sum(axes), rows]), group, differentiable=True)
    n = torch.clamp(packed[-1].detach(), min=1.0) * per_row
    mean = packed[:-1] / n
    sq = (x32 - mean).square()
    var = C.all_reduce_sum((sq if w is None else sq * w).sum(axes), group, differentiable=True) / n
    bessel = n / torch.clamp(n - 1.0, min=1.0)
    inv = torch.rsqrt(var + eps)
    scale = bn["scale"].float()
    y = x32 * (scale * inv) + (bn["bias"].float() - mean * scale * inv)
    return y.to(x.dtype), BNStats(mean=mean, var=var, var_unbiased=var * bessel)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ kernel.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator, group=None) -> torch.Tensor:
    """Inverted dropout (`tf.nn.dropout(rate=...)`, network.py:205): each
    value is kept with probability 1 - rate and scaled by 1 / (1 - rate).
    The mask is drawn from `generator`, on x's device; rate 0 keeps every
    value (a uniform draw in [0, 1) is always below 1) and scales by 1.

    `group`, a mesh's data group: the mask of the global batch is drawn
    (every rank's generator seeded alike, so every rank draws the same) and
    this rank keeps its rows, so a world of N computes what a world of one
    computes on the global batch."""
    keep = 1.0 - rate
    n, i = x.shape[0], C.index(group)
    draw = torch.rand((n * C.size(group),) + tuple(x.shape[1:]), generator=generator, device=x.device)
    mask = draw[i * n:(i + 1) * n] < keep
    scale = 1.0 / max(keep, 1e-8) if keep > 0 else 0.0
    return torch.where(mask, x * scale, x.new_zeros(()))
