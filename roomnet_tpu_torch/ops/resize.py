"""Bilinear resize with exact TF1-legacy and cv2 (half-pixel) conventions.

Port of roomnet_tpu/ops/resize.py. The interpolation matrices are built in
numpy with float32 coefficient arithmetic, like TF's CPU kernel (float64
coefficients shift the 215->205 residual resize by ~1e-4). The separable
resize is two einsums over an NHWC tensor: rows, then columns.

1. **TF1 legacy** (``align_corners=False, half_pixel_centers=False``):
   ``src = dst * in/out``. The residual shortcuts use it (reference
   network.py:199): 215->205, 100->48, 21->2 at a 224 input.
2. **Half-pixel centers** (cv2 INTER_LINEAR): ``src = (dst + 0.5) * in/out
   - 0.5`` clamped to [0, in-1]. The host preprocess uses it (reference
   generator.py:85, network.py:152).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "device_matrix",
    "resize_bilinear_tf1",
    "resize_bilinear_half_pixel",
    "interp_matrix_tf1",
    "interp_matrix_half_pixel",
]


def _interp_from_src(src: np.ndarray, in_size: int) -> np.ndarray:
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo.astype(np.float32)).astype(np.float32)
    w = np.zeros((in_size, src.shape[0]), dtype=np.float32)
    cols = np.arange(src.shape[0])
    # add.at sums the two weights where lo == hi (the clamped last source).
    np.add.at(w, (lo, cols), np.float32(1.0) - frac)
    np.add.at(w, (hi, cols), frac)
    return w


@functools.lru_cache(maxsize=None)
def interp_matrix_tf1(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) interpolation matrix, TF1 legacy convention."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = np.float32(in_size) / np.float32(out_size)
    return _interp_from_src(np.arange(out_size, dtype=np.float32) * scale, in_size)


@functools.lru_cache(maxsize=None)
def interp_matrix_half_pixel(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) interpolation matrix, half-pixel-centers convention."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = np.float32(in_size) / np.float32(out_size)
    src = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * scale - np.float32(0.5)
    return _interp_from_src(np.clip(src, np.float32(0.0), np.float32(in_size - 1)), in_size)


@functools.lru_cache(maxsize=None)
def device_matrix(kind: str, in_size: int, out_size: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """The f32 interpolation matrix ("tf1" or "half_pixel") on `device`,
    its weights rounded to bf16 first when `dtype` is bf16; copied to the
    device once per (sizes, dtype, device)."""
    m = {"tf1": interp_matrix_tf1, "half_pixel": interp_matrix_half_pixel}[kind](in_size, out_size)
    return torch.from_numpy(m).to(dtype).float().to(device)


def _apply_separable(x: torch.Tensor, kind: str, out_hw: tuple[int, int], f32_out: bool) -> torch.Tensor:
    """Rows then columns of NHWC ``x``, each pass in float32. bf16 rounds the
    weights and the row-pass intermediate to bf16, like the JAX bf16 einsum
    pair. The result is cast to x.dtype, or left in float32 with `f32_out`."""
    _, h, w, _ = x.shape
    wh_t = device_matrix(kind, h, out_hw[0], x.dtype, x.device)
    ww_t = device_matrix(kind, w, out_hw[1], x.dtype, x.device)
    y = torch.einsum("bhwc,hi->biwc", x.float(), wh_t).to(x.dtype).float()
    y = torch.einsum("biwc,wj->bijc", y, ww_t)
    return y if f32_out else y.to(x.dtype).contiguous()


def resize_bilinear_tf1(x: torch.Tensor, out_hw: tuple[int, int], *,
                        f32_out: bool = False) -> torch.Tensor:
    """TF1-legacy bilinear resize of NHWC (`tf.image.resize_bilinear`).
    `f32_out` skips the final rounding to x.dtype (the residual group adds
    x and the BN affine before it rounds)."""
    return _apply_separable(x, "tf1", out_hw, f32_out)


def resize_bilinear_half_pixel(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Half-pixel-centers bilinear resize of NHWC (`cv2.resize` INTER_LINEAR)."""
    return _apply_separable(x, "half_pixel", out_hw, False)
