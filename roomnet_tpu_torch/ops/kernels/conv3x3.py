"""3x3 conv, NHWC x HWIO -> NHWC, f32 accumulation: csrc/conv3x3.cu.

Replaces roomnet_tpu/ops/pallas/conv_b2.py:conv3x3_pallas. The kernel is an
implicit GEMM over a shared-memory halo tile (see the source's header). A
VALID conv at stride 1 (RoomNet's) takes its path by shape alone: bf16 with
Cin / 8 a power of two runs Hopper's wgmma, both operands read from shared
memory (the resident weights and the shifted halo that TMA loads), with TMA
stores of the output; other bf16 (conv 0's 3 channels, Cin 48) runs
mma.sync on a halo of element loads; f32 with Cin a multiple of 8 up to 256 (`tf32_takes`) runs TF32
products on wgmma over hi and lo parts of each operand (lo*lo, lo*hi,
hi*lo, hi*hi), f32-accurate as the reference's Precision.HIGHEST is; other
f32 (conv 0) runs in full f32 on CUDA cores. `variant` reports which path
and tile a shape takes. The optional f32 bias carries the uint8 preprocess
folded into conv 0 (models/roomnet.py:_fold_preprocess_into_first_conv).

Zero padding, stride 2, a ReLU or a residual in the epilogue (ResNet-50's
convs, models/resnet.py), or Cout past 128, take the streamed path
(csrc/igemm.cuh, the kernel conv_wg_stream): bf16 only, Cin a multiple of
64, y = relu?(conv + bias + residual?) rounded once, the weights streamed a
K step (one tap x 64 input channels) at a time.

The kernel reads its weights in a packed layout, made here from the HWIO
kernel by `pack_bf16` / `pack_tf32x3` / `pack_f32` once per kernel tensor
and cached beside it:

  * bf16: [slice][Cout_p][8], slice j = tap * c8 + c the channels 8c..8c+7
    of tap (dy, dx) = divmod(tap, 3), c8 = ceil(Cin / 8), the slice count
    padded to even, Cout padded to Cout_p in COUT_STEPS. It is the
    shared-memory image the kernel copies as it is, and wgmma's K-major
    layout without swizzle for its B operand: core matrices of 8 output
    channels x 16 bytes, the two slices of a k16 step Cout_p * 16 bytes
    apart, groups of 8 channels 128.
  * f32, TF32 split: [Cout tile][slice][hi, lo][NT][4], slice j = (chunk *
    9 + tap) * 2 + b the channels 4c..4c+3 with c = 2 * chunk + b (K chunks
    of 8 channels, the kernel's halo stages), hi = tf32(k) and lo = tf32(k -
    hi) (`tf32_split`), NT = `tf32_nt(Cin, Cout)` output channels per block:
    the widest whose hi + lo fit TF32_W_MAX bytes. A tile's image is
    wgmma's K-major B as in bf16, 4 f32 where bf16 has 8, of N = 2 * NT: the
    hi weights in rows 0..NT-1 and the lo in NT..2NT-1 ([hi | lo]; the two
    slices of a k8 step 2 * NT * 16 bytes apart), so that one wgmma
    multiplies an A tile by both.
  * f32, CUDA cores: [Cout tile][chunk][tap][4][NT], chunk c the channels
    4c..4c+3, NT = min(64, Cout_p) output channels per block.
  * streamed (`pack_stream`, also conv1x1's): [Cout tile][K step][BN][64],
    K step k = tap * Cin / 64 + chunk, its 64 channels 64 * chunk.. in
    16-byte chunks, chunk c of output channel n at c ^ (n % 8), BN =
    `stream_bn(Cout)` output channels a tile: each step's image in shared
    memory, wgmma's K-major B swizzled by 128 bytes as the TMA swizzles A.

Every padded entry is zero. This module alone decides the layout: the
wrapper passes its Cout_p (bf16) or NT (f32), read off the packed tensor, to
the C entry, which only picks the tile that goes with it.

On a CPU tensor `conv3x3` runs `conv3x3_plain`; on a CUDA tensor it
launches the kernel or raises. Every call counts one launch into
utils/profiling.SPANS as `kernel/launches.conv3x3` (the plain version's too:
it stands in the launch's place). `conv3x3_autograd` is the same call under
autograd: its forward is `conv3x3`, its backward one
`aten.convolution_backward` in the io dtype (cuDNN on the card) on
channels-last views of the NHWC tensors. The kernel's gradient is
computed for the io-dtype kernel and cast to the kernel's own dtype, as
`kernel.astype(x.dtype)` differentiates in JAX.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ...utils.profiling import SPANS
from .. import blocks
from . import _build

P = ctypes.c_void_p
I = ctypes.c_int
_ARGS = [P, P, P, P, I, I, I, I, I, I, I, I, P]
_STREAM_ARGS = [P, P, P, P, P] + [I] * 10 + [P]
COUT_STEPS = (8, 16, 32, 64, 128)
F32_NT = 64  # output channels of one f32 CUDA-core block
TF32_NTS = (64, 32, 16, 8)  # output channels of one TF32 split block, widest first
# Hi + lo weights of one TF32 split Cout tile, bytes (csrc/conv3x3.cu:tf::W_MAX),
# side by side in one wgmma operand of N = 2 * NT.
TF32_W_MAX = 147456
# rn_conv3x3_variant's report, in order (csrc/conv3x3.cu:fill).
VARIANT_FIELDS = ("path", "cp", "sub", "rows", "cols", "smem", "warpgroups", "stages", "tma_store",
                  "out_swizzle", "cout_tiles", "chunk", "tap_wgmmas")
PATHS = ("f32 CUDA cores", "mma.sync", "wgmma+TMA", "tf32x3 wgmma+TMA", "wgmma streamed")
STREAM_BK = 64  # input channels of a streamed K step (csrc/igemm.cuh:BK)
STREAM_BNS = (128, 64)  # output channels of a streamed tile, widest first

_packed = WeakIdKeyDictionary()  # kernel tensor -> {(dtype, layout or tf32x3): (version, packed)}


def conv3x3_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None, *,
                  padding: int = 0, stride: int = 1, relu: bool = False,
                  residual: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: f32 conv of the io-dtype operands
    (zero padding `padding`, stride `stride`), plus the f32 bias, plus the
    residual, then the ReLU, rounded once to x.dtype."""
    return epilogue_plain(conv_plain(x, kernel, padding, stride), x.dtype, bias, relu, residual)


def conv_plain(x: torch.Tensor, kernel: torch.Tensor, padding: int = 0, stride: int = 1) -> torch.Tensor:
    """The f32 sums of the conv of x and `kernel` in x.dtype: NHWC x HWIO,
    zero padding `padding`, then VALID at `stride`."""
    xf = x.float()
    if padding:
        xf = torch.nn.functional.pad(xf, (0, 0, padding, padding, padding, padding))
    return blocks.conv2d_valid(xf, kernel.to(x.dtype).float(), stride=stride)


def epilogue_plain(y: torch.Tensor, dtype: torch.dtype, bias=None, relu: bool = False, residual=None) -> torch.Tensor:
    """The streamed epilogue on f32 sums `y`: + bias, + residual, ReLU, one
    rounding to `dtype` (csrc/igemm.cuh)."""
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(dtype)


def cout_padded(cout: int) -> int:
    """The kernel's Cout_p: the smallest of COUT_STEPS that holds `cout`."""
    for step in COUT_STEPS:
        if cout <= step:
            return step
    raise ValueError(f"conv3x3: Cout {cout} > {COUT_STEPS[-1]} is not supported by the kernel")


def _zero_padded(kernel: torch.Tensor, cin_p: int, cout_p: int) -> torch.Tensor:
    """(9, cin_p, cout_p): the HWIO kernel with taps flattened and zeros past
    Cin and Cout."""
    _, _, cin, cout = kernel.shape
    k = kernel.new_zeros((9, cin_p, cout_p))
    k[:, :cin, :cout] = kernel.reshape(9, cin, cout)
    return k


def pack_bf16(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO (3,3,Cin,Cout) -> [slice][Cout_p][8] in kernel.dtype."""
    _, _, cin, cout = kernel.shape
    c8, cout_p = -(-cin // 8), cout_padded(cout)
    k = _zero_padded(kernel, 8 * c8, cout_p)
    k = k.reshape(9, c8, 8, cout_p).permute(0, 1, 3, 2).reshape(9 * c8, cout_p, 8)
    if k.shape[0] % 2:
        k = torch.cat([k, k.new_zeros((1, cout_p, 8))])
    return k.contiguous()


def pack_f32(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO (3,3,Cin,Cout) -> [Cout tile][chunk][tap][4][NT] in kernel.dtype."""
    _, _, cin, cout = kernel.shape
    chunks, nt = -(-cin // 4), min(F32_NT, cout_padded(cout))
    tiles = -(-cout // nt)
    k = _zero_padded(kernel, 4 * chunks, tiles * nt)
    return k.reshape(9, chunks, 4, tiles, nt).permute(3, 1, 0, 2, 4).contiguous()


def tf32_takes(cin: int) -> bool:
    """Whether f32 at `cin` input channels runs on the TF32 split
    (csrc/conv3x3.cu:tf::takes): K chunks of 8 channels, and one Cout tile
    of 8 channels within TF32_W_MAX."""
    return cin % 8 == 0 and cin <= 256


def tf32_nt(cin: int, cout: int) -> int:
    """Output channels of one TF32 split block: the widest of TF32_NTS up to
    Cout_p whose hi + lo weights (72 * Cin * NT bytes) fit TF32_W_MAX."""
    for nt in TF32_NTS:
        if nt <= cout_padded(cout) and 72 * cin * nt <= TF32_W_MAX:
            return nt
    raise ValueError(f"conv3x3: Cin {cin} has no TF32 split tile")


def tf32(v: torch.Tensor) -> torch.Tensor:
    """f32 `v` rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties
    away from zero), the 13 low mantissa bits zero; NaN and infinities stay."""
    bits = v.float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(v), rounded, v.float())


def tf32_split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of f32 `v`: hi = tf32(v), lo = tf32(v - hi), lo 0 where v -
    hi is not finite (csrc/conv3x3.cu:tf::split)."""
    hi = tf32(v)
    r = v.float() - hi
    return hi, tf32(torch.where(torch.isfinite(r), r, torch.zeros_like(r)))


def pack_tf32x3(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO (3,3,Cin,Cout) f32 -> [Cout tile][slice][hi, lo][NT][4], Cin a
    multiple of 8 (`tf32_takes`)."""
    _, _, cin, cout = kernel.shape
    nt = tf32_nt(cin, cout)
    tiles = -(-cout // nt)
    k = _zero_padded(kernel.float(), cin, tiles * nt)
    k = k.reshape(9, cin // 8, 2, 4, tiles, nt).permute(4, 1, 0, 2, 5, 3).reshape(tiles, 9 * cin // 4, nt, 4)
    return torch.stack(tf32_split(k), 2).contiguous()


def stream_bn(cout: int) -> int:
    """Output channels of a streamed tile: the widest of STREAM_BNS that
    divides `cout`."""
    for bn in STREAM_BNS:
        if cout % bn == 0:
            return bn
    raise ValueError(f"streamed conv: Cout {cout} is not a multiple of {STREAM_BNS[-1]}")


def pack_stream(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO (kh,kw,Cin,Cout) -> [Cout tile][K step][BN][8 chunks][8] in
    kernel.dtype, chunk c of output channel n at c ^ (n % 8), Cin a
    multiple of STREAM_BK."""
    kh, kw, cin, cout = kernel.shape
    if cin % STREAM_BK:
        raise ValueError(f"streamed conv: Cin {cin} is not a multiple of {STREAM_BK}")
    bn = stream_bn(cout)
    k = kernel.reshape(kh * kw, cin // STREAM_BK, STREAM_BK // 8, 8, cout // bn, bn)
    k = k.permute(4, 0, 1, 5, 2, 3)  # [tile][tap][chunk][n][c][8]
    swz = torch.arange(8, device=kernel.device) ^ (torch.arange(bn, device=kernel.device) % 8)[:, None]
    k = k[:, :, :, torch.arange(bn, device=kernel.device)[:, None], swz]  # position c holds chunk c ^ (n % 8)
    return k.reshape(cout // bn, kh * kw * cin // STREAM_BK, bn, STREAM_BK // 8, 8).contiguous()


def packed_kernel(kernel: torch.Tensor, dtype: torch.dtype, tf32x3: bool = False,
                  layout: str | None = None) -> torch.Tensor:
    """The packed weights of `kernel` in `dtype` (layout "stream":
    pack_stream's; else f32 with `tf32x3`: pack_tf32x3's, other f32
    pack_f32's, bf16 pack_bf16's), made once per kernel tensor and layout
    (and again after an in-place change to it)."""
    layouts = _packed.get(kernel)
    if layouts is None or any(v != kernel._version for v, _ in layouts.values()):
        layouts = _packed[kernel] = {}
    key = (dtype, layout or tf32x3)
    hit = layouts.get(key)
    if hit is not None:
        return hit[1]
    k = kernel.to(dtype)
    if layout == "stream":
        packed = pack_stream(k)
    elif dtype == torch.bfloat16:
        packed = pack_bf16(k)
    else:
        packed = pack_tf32x3(k) if tf32x3 else pack_f32(k)
    layouts[key] = (kernel._version, packed)
    return packed


def conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None, *,
            padding: int = 0, stride: int = 1, relu: bool = False,
            residual: torch.Tensor | None = None) -> torch.Tensor:
    """3x3 conv: x (B,H,W,Cin), kernel (3,3,Cin,Cout) -> (B,Ho,Wo,Cout) in
    x.dtype, Ho = (H + 2 padding - 3) // stride + 1; bias (Cout,) f32 or
    None; then + residual (like the output) and the ReLU where given.
    padding 0 or 1, stride 1 or 2."""
    SPANS.count("kernel/launches.conv3x3", 1)
    if x.device.type == "cpu":
        return conv3x3_plain(x, kernel, bias, padding=padding, stride=stride, relu=relu, residual=residual)
    B, H, W, Cin = x.shape
    if tuple(kernel.shape[:3]) != (3, 3, Cin) or H + 2 * padding < 3 or W + 2 * padding < 3 \
            or padding not in (0, 1) or stride not in (1, 2):
        raise ValueError(f"conv3x3: x {tuple(x.shape)}, kernel {tuple(kernel.shape)}, padding {padding} "
                         f"and stride {stride} do not fit")
    Cout = kernel.shape[3]
    if bias is not None:
        bias = bias.float().contiguous()
        if bias.shape != (Cout,):
            raise ValueError(f"conv3x3: bias {tuple(bias.shape)} is not ({Cout},)")
    if padding or stride != 1 or relu or residual is not None or Cout > COUT_STEPS[-1]:
        return _conv3x3_stream(x, kernel, bias, padding, stride, relu, residual)
    tf32x3 = x.dtype == torch.float32 and tf32_takes(Cin)
    packed = packed_kernel(kernel, x.dtype, tf32x3)
    operands = (packed,) if bias is None else (packed, bias)
    dtype, device, stream = _build.launch_args("conv3x3", x, *operands)
    if x.data_ptr() % 16:
        raise ValueError("conv3x3: x must start on a 16-byte boundary")
    y = torch.empty((B, H - 2, W - 2, Cout), dtype=x.dtype, device=x.device)
    cp = packed.shape[1] if x.dtype == torch.bfloat16 else packed.shape[3 if tf32x3 else -1]
    fn = _build.entry("conv3x3", "rn_conv3x3", _ARGS)
    rc = fn(x.data_ptr(), packed.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), B, H, W, Cin, Cout, cp, dtype, device, stream)
    conv3x3.launches += 1
    _build.check("conv3x3", "rn_conv3x3", rc)
    return y


conv3x3.launches = 0


def _conv3x3_stream(x, kernel, bias, padding, stride, relu, residual):
    """The streamed path's launch (csrc/conv3x3.cu:rn_conv3x3_stream)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3: padding, stride 2, an epilogue or Cout > {COUT_STEPS[-1]} need bfloat16, "
                        f"got {x.dtype}")
    B, H, W, Cin = x.shape
    Cout = kernel.shape[3]
    Ho, Wo = (H + 2 * padding - 3) // stride + 1, (W + 2 * padding - 3) // stride + 1
    packed = packed_kernel(kernel, x.dtype, layout="stream")
    operands = [packed] + [t for t in (bias, residual) if t is not None]
    dtype, device, stream = _build.launch_args("conv3x3", x, *operands)
    if residual is not None and (residual.shape != (B, Ho, Wo, Cout) or residual.dtype != x.dtype):
        raise ValueError(f"conv3x3: residual {tuple(residual.shape)} {residual.dtype} is not the output's")
    if any(t.data_ptr() % 16 for t in (x, residual) if t is not None):
        raise ValueError("conv3x3: x and the residual must start on a 16-byte boundary")
    y = torch.empty((B, Ho, Wo, Cout), dtype=x.dtype, device=x.device)
    fn = _build.entry("conv3x3", "rn_conv3x3_stream", _STREAM_ARGS)
    rc = fn(x.data_ptr(), packed.data_ptr(), None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(), y.data_ptr(), B, H, W, Cin, Cout, padding, stride,
            int(relu), packed.shape[2], device, stream)
    conv3x3.launches += 1
    _build.check("conv3x3", "rn_conv3x3_stream", rc)
    return y


def variant(shape: tuple, cout: int, dtype: torch.dtype, *, padding: int = 0, stride: int = 1) -> dict:
    """What the kernel launches for x of `shape` (B,H,W,Cin) and `cout`
    output channels in `dtype` (csrc/conv3x3.cu:rn_conv3x3_variant, which
    builds the library but launches nothing): VARIANT_FIELDS by name, `path`
    one of PATHS. Raises on a shape the kernel refuses. A padded or strided
    conv, or Cout past 128, reports the streamed path
    (rn_conv3x3_stream_variant: `sub` the images of a tile, `chunk` a K
    step's input channels)."""
    B, H, W, cin = shape
    if padding or stride != 1 or cout > COUT_STEPS[-1]:
        out = (ctypes.c_int * len(VARIANT_FIELDS))()
        fn = _build.entry("conv3x3", "rn_conv3x3_stream_variant", [I] * 8 + [P])
        _build.check("conv3x3", "rn_conv3x3_stream_variant",
                     fn(B, H, W, cin, cout, padding, stride, stream_bn(cout), out))
        got = dict(zip(VARIANT_FIELDS, out))
        got["path"] = PATHS[got["path"]]
        return got
    if dtype == torch.bfloat16:
        cp = cout_padded(cout)
    else:
        cp = tf32_nt(cin, cout) if tf32_takes(cin) else min(F32_NT, cout_padded(cout))
    out = (ctypes.c_int * len(VARIANT_FIELDS))()
    fn = _build.entry("conv3x3", "rn_conv3x3_variant", [I] * 6 + [P])
    _build.check("conv3x3", "rn_conv3x3_variant", fn(H, W, cin, cout, cp, int(dtype == torch.bfloat16), out))
    got = dict(zip(VARIANT_FIELDS, out))
    got["path"] = PATHS[got["path"]]
    return got


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel)
        ctx.with_bias = bias is not None
        return conv3x3(x, kernel, bias)

    @staticmethod
    def backward(ctx, gy):
        x, kernel = ctx.saved_tensors
        need_x, need_k, need_b = ctx.needs_input_grad
        gx = gk = gb = None
        if need_x or need_k:
            nchw = (0, 3, 1, 2)
            w = kernel.to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
            gx, gk, _ = torch.ops.aten.convolution_backward(
                gy.contiguous().permute(nchw), x.permute(nchw), w, None, [1, 1], [0, 0], [1, 1],
                False, [0, 0], 1, [need_x, need_k, False])
            if need_x:
                gx = gx.permute(0, 2, 3, 1).contiguous()
            if need_k:
                gk = gk.permute(2, 3, 1, 0).to(kernel.dtype).contiguous()
        if need_b and ctx.with_bias:
            gb = gy.float().sum((0, 1, 2))
        return gx, gk, gb


def conv3x3_autograd(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """`conv3x3` with gradients for x, kernel and bias."""
    return _Conv3x3.apply(x, kernel, bias)
