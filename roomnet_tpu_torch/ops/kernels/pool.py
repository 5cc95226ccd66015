"""Conv-block epilogue avgpool_{k,s}(relu6(x)) * w + b: csrc/relu6_pool_bn.cu.

Replaces roomnet_tpu/ops/pallas/pool.py:fused_relu6_pool_bn, which took
stride 1 only. This one takes any (k, s): k3/s1 (B1), k4/s1 (B2), k4/s2 (B3,
B5) and k=1, s=1 for B4, which has no pool. On an H100 it is bound by bytes:
one read of x and one write of y. The kernel is a strip stencil that reads
each input once and sums the window along W, then along H (see the
source's header). (w, b) is the BN folded by `ops.blocks.bn_fold` with the
config's eps.

On a CPU tensor `relu6_pool_bn` runs `relu6_pool_bn_plain`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import blocks
from . import _build

P = ctypes.c_void_p
I = ctypes.c_int
_ARGS = [P, P, P, P, I, I, I, I, I, I, I, I, P]
KMAX = 4  # the widest window csrc/relu6_pool_bn.cu takes


def relu6_pool_bn_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, ksize: int,
                        stride: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: in f32, sum the window, divide by
    k*k, then ``* w + b``; rounded once to x.dtype."""
    h = blocks.avg_pool_valid(blocks.relu6(x.float()), ksize, stride)
    return (h * w.float() + b.float()).to(x.dtype)


def relu6_pool_bn(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, ksize: int,
                  stride: int) -> torch.Tensor:
    """x (B,H,W,C) -> (B,(H-k)//s+1,(W-k)//s+1,C) in x.dtype; w, b (C,) f32."""
    if x.device.type == "cpu":
        return relu6_pool_bn_plain(x, w, b, ksize=ksize, stride=stride)
    B, H, W, C = x.shape
    if ksize < 1 or stride < 1 or H < ksize or W < ksize:
        raise ValueError(f"relu6_pool_bn: window {ksize}/{stride} does not fit {tuple(x.shape)}")
    if ksize > KMAX:
        raise ValueError(f"relu6_pool_bn: the kernel takes windows up to {KMAX}, not {ksize}")
    w = w.float().contiguous()
    b = b.float().contiguous()
    if w.shape != (C,) or b.shape != (C,):
        raise ValueError(f"relu6_pool_bn: w, b must be ({C},)")
    dtype, device, stream = _build.launch_args("relu6_pool_bn", x, w, b)
    Ho, Wo = (H - ksize) // stride + 1, (W - ksize) // stride + 1
    y = torch.empty((B, Ho, Wo, C), dtype=x.dtype, device=x.device)
    fn = _build.entry("relu6_pool_bn", "rn_relu6_pool_bn", _ARGS)
    rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, H, W, C, ksize, stride,
            dtype, device, stream)
    relu6_pool_bn.launches += 1
    _build.check("relu6_pool_bn", "rn_relu6_pool_bn", rc)
    return y


relu6_pool_bn.launches = 0
