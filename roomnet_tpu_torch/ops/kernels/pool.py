"""Conv-block epilogue avgpool_{k,s}(relu6(x)) * w + b: csrc/relu6_pool_bn.cu.

Replaces roomnet_tpu/ops/pallas/pool.py:fused_relu6_pool_bn, which took
stride 1 only. This one takes any (k, s): k3/s1 (B1), k4/s1 (B2), k4/s2 (B3,
B5) and k=1, s=1 for B4, which has no pool. On an H100 it is bound by bytes:
one read of x and one write of y. The kernel is a strip stencil that reads
each input once and sums the window along W, then along H (see the
source's header). (w, b) is the BN folded by `ops.blocks.bn_fold` with the
config's eps.

On a CPU tensor `relu6_pool_bn` runs `relu6_pool_bn_plain`; on a CUDA
tensor it launches the kernel or raises. `relu6_pool_bn_autograd` is the same
call under autograd. Its backward, in f32 and rounded once to x.dtype: the
pool's transpose (`aten.avg_pool2d_backward`, each window's gradient spread
over it divided by k*k) of ``g``, times w and relu6's derivative on the
saved conv output, which is 1 inside (0, 6), 0 outside [0, 6] and 0.5 at
x == 0 and x == 6, as in JAX; dw is the sum of that transpose times
relu6(x) (the adjoint of summing ``g * pool(relu6(x))``, with no second
pass of the pool) and db the sum of ``g``.
"""

from __future__ import annotations

import torch

from .. import blocks
from . import _build
from ._build import I, P

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
        _build.count_plain("relu6_pool_bn")
        return relu6_pool_bn_plain(x, w, b, ksize=ksize, stride=stride)
    B, H, W, C = x.shape
    if ksize < 1 or stride < 1 or H < ksize or W < ksize:
        raise ValueError(f"relu6_pool_bn: window {ksize}/{stride} does not fit {tuple(x.shape)}")
    if ksize > KMAX:
        raise ValueError(f"relu6_pool_bn: the kernel takes windows up to {KMAX}, not {ksize}")
    w, b = w.float().contiguous(), b.float().contiguous()
    if w.shape != (C,) or b.shape != (C,):
        raise ValueError(f"relu6_pool_bn: w, b must be ({C},)")
    dtype, device, stream = _build.launch_args("relu6_pool_bn", x, w, b)
    Ho, Wo = (H - ksize) // stride + 1, (W - ksize) // stride + 1
    y = torch.empty((B, Ho, Wo, C), dtype=x.dtype, device=x.device)
    _build.launch("relu6_pool_bn", "rn_relu6_pool_bn", _ARGS, x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                  B, H, W, C, ksize, stride, dtype, device, stream)
    return y


def relu6_grad(x: torch.Tensor) -> torch.Tensor:
    """d relu6 / dx in f32: 1 inside (0, 6), 0.5 at the ties 0 and 6, else 0."""
    inside = ((x > 0) & (x < 6)).float()
    return torch.where((x == 0) | (x == 6), 0.5, inside)


class _Relu6PoolBn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, ksize, stride):
        ctx.save_for_backward(x, w)
        ctx.window = ksize, stride
        return relu6_pool_bn(x, w, b, ksize=ksize, stride=stride)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        k, s = ctx.window
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        g = gy.float()
        gx = gw = gb = None
        if need_x or need_w:
            gp = g  # the pool's transpose; a 1x1 window's is the identity
            if (k, s) != (1, 1):
                B, H, W, C = x.shape
                shape = torch.empty((B, C, H, W), device=x.device, memory_format=torch.channels_last)
                gp = torch.ops.aten.avg_pool2d_backward(
                    g.permute(0, 3, 1, 2), shape, [k, k], [s, s], [0, 0], False, True, None).permute(0, 2, 3, 1)
            if need_x:
                gx = (gp * w.float() * relu6_grad(x)).to(x.dtype).contiguous()
            if need_w:  # sum(g * pool(relu6(x))) = sum(pool^T(g) * relu6(x))
                gw = (gp * blocks.relu6(x)).sum((0, 1, 2))
        if need_b:
            gb = g.sum((0, 1, 2))
        return gx, gw, gb, None, None


def relu6_pool_bn_autograd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, ksize: int,
                           stride: int) -> torch.Tensor:
    """`relu6_pool_bn` with gradients for x, w and b."""
    return _Relu6PoolBn.apply(x, w, b, ksize, stride)
