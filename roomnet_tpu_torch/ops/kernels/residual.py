"""Residual group s * (x + resize_tf1(res)) + t over NHWC: csrc/residual_bn.cu.

Replaces roomnet_tpu/ops/pallas/residual.py:residual_bn_pallas. On an H100
it is bound by bytes (read res and x, write the output). The TPU kernel's
NHWC<->NCHW transposes existed for a TPU layout reason and are gone: the
kernel takes NHWC. The resize uses the port's own float32 TF1-legacy
interpolation matrices (ops/resize.py), rounded to bf16 in bf16 mode as the
JAX einsum path rounds them; the H-interpolated intermediate is rounded to
the io dtype before the W pass, as in residual.py:55-57.

On a CPU tensor `residual_bn` runs `residual_bn_plain`; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..resize import interp_matrix_tf1, resize_bilinear_tf1
from . import _build

P = ctypes.c_void_p
I = ctypes.c_int
_ARGS = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P]


@functools.lru_cache(maxsize=None)
def source_pairs(in_size: int, out_size: int, dtype: torch.dtype) -> tuple[np.ndarray, np.ndarray]:
    """Per output index, the two (source index, weight) pairs of its column
    of the interpolation matrix: int32 (out, 2) and float32 (out, 2). A
    column with one nonzero (the clamped edge, or identity) gets weight 0
    on its second pair."""
    m = torch.from_numpy(interp_matrix_tf1(in_size, out_size)).to(dtype).float().numpy()
    idx = np.zeros((out_size, 2), np.int32)
    wts = np.zeros((out_size, 2), np.float32)
    for j in range(out_size):
        nz = np.flatnonzero(m[:, j])
        if not 1 <= nz.size <= 2:
            raise ValueError(f"TF1 interpolation column {j} has {nz.size} sources")
        idx[j] = (nz[0], nz[-1])
        wts[j, : nz.size] = m[nz, j]
    return idx, wts


@functools.lru_cache(maxsize=None)
def _device_pairs(in_size: int, out_size: int, dtype: torch.dtype, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in source_pairs(in_size, out_size, dtype))


def residual_bn_plain(x: torch.Tensor, res: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: the H pass in f32 rounded to the
    io dtype, the W pass in f32, then ``s * (x + .) + t``, rounded once."""
    y = resize_bilinear_tf1(res, tuple(x.shape[1:3]), f32_out=True)
    return (s.float() * (x.float() + y) + t.float()).to(x.dtype).contiguous()


def residual_bn(x: torch.Tensor, res: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x (B,Ho,Wo,C), res (B,Hi,Wi,C) in the io dtype; s, t (C,) f32 (the
    folded BN). Returns (B,Ho,Wo,C) in x.dtype."""
    if x.device.type == "cpu":
        return residual_bn_plain(x, res, s, t)
    B, Ho, Wo, C = x.shape
    Bi, Hi, Wi, Ci = res.shape
    if (Bi, Ci) != (B, C) or res.dtype != x.dtype:
        raise ValueError(f"residual_bn: res {tuple(res.shape)} {res.dtype} does not fit "
                         f"x {tuple(x.shape)} {x.dtype}")
    s = s.float().contiguous()
    t = t.float().contiguous()
    if s.shape != (C,) or t.shape != (C,):
        raise ValueError(f"residual_bn: s, t must be ({C},)")
    hidx, hwt = _device_pairs(Hi, Ho, x.dtype, x.device)
    widx, wwt = _device_pairs(Wi, Wo, x.dtype, x.device)
    dtype, device, stream = _build.launch_args("residual_bn", x, res, s, t)
    y = torch.empty_like(x)
    fn = _build.entry("residual_bn", "rn_residual_bn", _ARGS)
    rc = fn(x.data_ptr(), res.data_ptr(), hidx.data_ptr(), hwt.data_ptr(), widx.data_ptr(),
            wwt.data_ptr(), s.data_ptr(), t.data_ptr(), y.data_ptr(), B, Hi, Wi, Ho, Wo, C,
            dtype, device, stream)
    residual_bn.launches += 1
    _build.check("residual_bn", "rn_residual_bn", rc)
    return y


residual_bn.launches = 0
