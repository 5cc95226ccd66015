"""1x1 conv as a GEMM with a fused epilogue, NHWC x HWIO -> NHWC, bf16:
csrc/conv1x1.cu.

y = relu?(x[:, ::stride, ::stride] @ kernel + bias + residual?), the sums in
f32, rounded once to bf16: ResNet-50's bottleneck 1x1 convs with their
folded BN, the block's residual and its ReLU, and its projection shortcuts
(stride 2). It replaces no kernel of the JAX package. The kernel is
a persistent GEMM on csrc/igemm.cuh's tiles (Hopper's wgmma, TMA loads of the
operands and the residual, TMA stores), named conv1x1_bn_kernel: one block
on each SM walks many output tiles, and loads the next tiles while it
finishes one. Cin and Cout multiples of 64, the weights packed by
conv3x3.pack_stream (`packed_kernel(..., layout="stream")`).

On a CPU tensor `conv1x1` runs `conv1x1_plain`; on a CUDA tensor it launches
the kernel or raises. Every call counts one launch into utils/profiling.SPANS
as `kernel/launches.conv1x1` (the plain version's too); a launch of the
kernel also counts its output tiles (`kernel/conv1x1.tiles`) and its
persistent blocks (`kernel/conv1x1.blocks`), from its plan: their ratio over
a window is the tiles a block walks.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...utils.profiling import SPANS
from . import _build
from .conv3x3 import epilogue_plain, packed_kernel, stream_bn

P = ctypes.c_void_p
I = ctypes.c_int
_ARGS = [P, P, P, P, P] + [I] * 10 + [P]
# rn_conv1x1_variant's report, in order (csrc/conv1x1.cu:run): the tile, the
# stages of its operand ring, then the persistent plan: the staging slots,
# the launch's tiles, its blocks (one an SM) and the most tiles a block walks.
VARIANT_FIELDS = ("bn", "cols", "rows", "images", "smem", "stages", "pixel_tiles", "cout_tiles", "slots", "tiles",
                  "blocks", "tiles_per_block")


def conv1x1_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None, *, stride: int = 1,
                  relu: bool = False, residual: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: the f32 product of the io-dtype
    operands at the stride, + bias, + residual, ReLU, rounded once."""
    xs = x[:, ::stride, ::stride]
    cin, cout = kernel.shape[-2:]
    y = xs.float().reshape(-1, cin) @ kernel.reshape(cin, cout).to(x.dtype).float()
    return epilogue_plain(y.reshape(*xs.shape[:3], cout), x.dtype, bias, relu, residual)


def conv1x1(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None, *, stride: int = 1,
            relu: bool = False, residual: torch.Tensor | None = None) -> torch.Tensor:
    """x (B,H,W,Cin), kernel (1,1,Cin,Cout) -> (B,Ho,Wo,Cout) in x.dtype, Ho
    = (H - 1) // stride + 1; bias (Cout,) f32 or None; residual like the
    output or None. stride 1 or 2."""
    SPANS.count("kernel/launches.conv1x1", 1)
    if x.device.type == "cpu":
        return conv1x1_plain(x, kernel, bias, stride=stride, relu=relu, residual=residual)
    B, H, W, Cin = x.shape
    if tuple(kernel.shape[:3]) != (1, 1, Cin) or stride not in (1, 2):
        raise ValueError(f"conv1x1: x {tuple(x.shape)}, kernel {tuple(kernel.shape)} and stride {stride} do not fit")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv1x1: the kernel computes bfloat16, got {x.dtype}")
    Cout = kernel.shape[3]
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    if bias is not None:
        bias = bias.float().contiguous()
        if bias.shape != (Cout,):
            raise ValueError(f"conv1x1: bias {tuple(bias.shape)} is not ({Cout},)")
    if residual is not None and (residual.shape != (B, Ho, Wo, Cout) or residual.dtype != x.dtype):
        raise ValueError(f"conv1x1: residual {tuple(residual.shape)} {residual.dtype} is not the output's")
    if any(t.data_ptr() % 16 for t in (x, residual) if t is not None):
        raise ValueError("conv1x1: x and the residual must start on a 16-byte boundary")
    packed = packed_kernel(kernel, x.dtype, layout="stream")
    dtype, device, stream = _build.launch_args("conv1x1", x, packed, *[t for t in (bias, residual) if t is not None])
    sms, plan = _plan(B, H, W, Cin, Cout, stride, residual is not None, device)
    y = torch.empty((B, Ho, Wo, Cout), dtype=x.dtype, device=x.device)
    fn = _build.entry("conv1x1", "rn_conv1x1", _ARGS)
    rc = fn(x.data_ptr(), packed.data_ptr(), None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(), y.data_ptr(), B, H, W, Cin, Cout, stride, int(relu),
            packed.shape[2], sms, device, stream)
    conv1x1.launches += 1
    _build.check("conv1x1", "rn_conv1x1", rc)
    SPANS.count("kernel/conv1x1.tiles", plan["tiles"])
    SPANS.count("kernel/conv1x1.blocks", plan["blocks"])
    return y


conv1x1.launches = 0


def variant(shape: tuple, cout: int, *, stride: int = 1, residual: bool) -> dict:
    """What the kernel launches on the current CUDA device for x of `shape`
    (B,H,W,Cin), `cout` output channels and a residual or none, as conv1x1
    is given one: csrc/conv1x1.cu:rn_conv1x1_variant, which builds the
    library but launches nothing; VARIANT_FIELDS by name. Raises on a shape
    the kernel refuses."""
    B, H, W, cin = shape
    return dict(_plan(B, H, W, cin, cout, stride, bool(residual), torch.cuda.current_device())[1])


@functools.lru_cache(maxsize=None)
def _plan(B: int, H: int, W: int, cin: int, cout: int, stride: int, residual: bool, device: int) -> tuple[int, dict]:
    """(the device's SMs, `variant`'s report), made once per shape and
    device: conv1x1 counts from the report at every launch."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = (ctypes.c_int * len(VARIANT_FIELDS))()
    fn = _build.entry("conv1x1", "rn_conv1x1_variant", [I] * 9 + [P])
    _build.check("conv1x1", "rn_conv1x1_variant",
                 fn(B, H, W, cin, cout, stride, int(residual), stream_bn(cout), sms, out))
    return sms, dict(zip(VARIANT_FIELDS, out))
