"""3x3 VALID conv, NHWC x HWIO -> NHWC, f32 accumulation: csrc/conv3x3.cu.

Replaces roomnet_tpu/ops/pallas/conv_b2.py:conv3x3_pallas. On an H100 it is
bound by operations (~4.5 GFLOP per image over the forward's ten convs); the
kernel is a direct convolution on CUDA cores with shared-memory tiles (see
the source's header). The optional f32 bias carries the uint8 preprocess
folded into conv 0 (models/roomnet.py:_fold_preprocess_into_first_conv).

On a CPU tensor `conv3x3` runs `conv3x3_plain`; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import blocks
from . import _build

P = ctypes.c_void_p
I = ctypes.c_int
_ARGS = [P, P, P, P, I, I, I, I, I, I, I, P]


def conv3x3_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: f32 conv of the io-dtype operands,
    plus the f32 bias, rounded once to x.dtype."""
    y = blocks.conv2d_valid(x.float(), kernel.to(x.dtype).float())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """VALID 3x3 conv, stride 1: x (B,H,W,Cin), kernel (3,3,Cin,Cout) ->
    (B,H-2,W-2,Cout) in x.dtype; bias (Cout,) f32 or None."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, kernel, bias)
    B, H, W, Cin = x.shape
    if tuple(kernel.shape[:3]) != (3, 3, Cin) or H < 3 or W < 3:
        raise ValueError(f"conv3x3: x {tuple(x.shape)} and kernel {tuple(kernel.shape)} do not fit")
    Cout = kernel.shape[3]
    kernel = kernel.to(x.dtype).contiguous()
    if bias is not None:
        bias = bias.float().contiguous()
        if bias.shape != (Cout,):
            raise ValueError(f"conv3x3: bias {tuple(bias.shape)} is not ({Cout},)")
    operands = (kernel,) if bias is None else (kernel, bias)
    dtype, device, stream = _build.launch_args("conv3x3", x, *operands)
    y = torch.empty((B, H - 2, W - 2, Cout), dtype=x.dtype, device=x.device)
    fn = _build.entry("conv3x3", "rn_conv3x3", _ARGS)
    rc = fn(x.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), B, H, W, Cin, Cout, dtype, device, stream)
    conv3x3.launches += 1
    _build.check("conv3x3", "rn_conv3x3", rc)
    return y


conv3x3.launches = 0
