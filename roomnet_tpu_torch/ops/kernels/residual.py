"""Residual group s * (x + resize_tf1(res)) + t over NHWC: csrc/residual_bn.cu.

Replaces roomnet_tpu/ops/pallas/residual.py:residual_bn_pallas. On an H100
it is bound by bytes (read res and x, write the output). The TPU kernel's
NHWC<->NCHW transposes existed for a TPU layout reason and are gone: the
kernel takes NHWC. The resize uses the port's own float32 TF1-legacy
interpolation matrices (ops/resize.py), rounded to bf16 in bf16 mode as the
JAX einsum path rounds them; the H-interpolated intermediate is rounded to
the io dtype before the W pass, as in residual.py:55-57.

The kernel is a strip stencil: a block stages the res rows and columns its
strip of output rows and span of output columns reach, once, and each
thread walks one output column down the strip. `plan` sizes the strip and
the span from the (source, weight) pairs and the shared-memory budget.

On a CPU tensor `residual_bn` runs `residual_bn_plain`; on a CUDA tensor it
launches the kernel or raises. `residual_bn_autograd` is the same call under
autograd. Its backward, in f32: ``g * s`` for x; for res the transpose of the
resize, the same TF1 matrices (bf16-rounded in bf16) applied the other way
round; ds and dt are the sums of ``g * (x + resize(res))`` and of ``g``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..resize import device_matrix, interp_matrix_tf1, resize_bilinear_tf1
from . import _build

P = ctypes.c_void_p
I = ctypes.c_int
_ARGS = [P] * 11 + [I] * 13 + [P]
# The kernel's limits (csrc/residual_bn.cu): threads per block, output rows
# per block (held in registers) and a block's shared memory, which four
# blocks of an SM share.
MAX_THREADS = 256
MAX_STRIP = 8
SMEM_LIMIT = 48 << 10


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


def _reach(idx: np.ndarray, step: int) -> np.ndarray:
    """(first source, count) of the sources that each group of `step`
    consecutive outputs reaches, from `source_pairs`' indices: int32
    (ceil(out / step), 2)."""
    groups = [idx[i: i + step] for i in range(0, idx.shape[0], step)]
    return np.array([(g.min(), g.max() - g.min() + 1) for g in groups], np.int32)


@dataclasses.dataclass(frozen=True, eq=False)  # hashed by identity: `plan` caches each
class Plan:
    """One launch's blocks: `strip` output rows by `span` output columns of
    one image, `vec` channels per thread, and the res rows (`strips`) and
    columns (`spans`) each block stages; `rows_in` and `cols_in` are the most
    of either that one block holds."""

    vec: int
    strip: int
    span: int
    strips: np.ndarray  # int32 (ceil(Ho / strip), 2): first res row, count
    spans: np.ndarray   # int32 (ceil(Wo / span), 2): first res column, count
    channels: int
    itemsize: int

    @property
    def rows_in(self) -> int:
        return int(self.strips[:, 1].max())

    @property
    def cols_in(self) -> int:
        return int(self.spans[:, 1].max())

    @property
    def threads(self) -> int:
        return self.channels // self.vec * self.span

    @property
    def smem(self) -> int:
        return self.rows_in * self.cols_in * self.channels * self.itemsize

    def grid(self, batch: int) -> tuple[int, int, int]:
        return len(self.spans), len(self.strips), batch


@functools.lru_cache(maxsize=None)
def plan(hi: int, wi: int, ho: int, wo: int, c: int, dtype: torch.dtype, wide: bool = True) -> Plan:
    """The launch plan for res (Hi, Wi) -> x (Ho, Wo) at C channels. A
    thread takes 16 bytes of channels where C is a multiple of them and
    `wide` (every tensor 16-byte aligned), else one. The span is as many
    output columns as MAX_THREADS threads cover, evened out over the width;
    the strip MAX_STRIP rows, halved until the block's res tile fits
    SMEM_LIMIT, then the span halved."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    full = 16 // itemsize
    vec = full if wide and c % full == 0 else 1
    if c // vec > MAX_THREADS:
        raise ValueError(f"residual_bn: {c} channels need more than {MAX_THREADS} threads per column")
    hidx = source_pairs(hi, ho, dtype)[0]
    widx = source_pairs(wi, wo, dtype)[0]

    def even(n: int, most: int) -> int:
        return -(-n // -(-n // most))

    strip, span = even(ho, MAX_STRIP), even(wo, MAX_THREADS // (c // vec))
    while True:
        p = Plan(vec, strip, span, _reach(hidx, strip), _reach(widx, span), c, itemsize)
        # One output's 2x2 sources of MAX_THREADS vectors take 16 KB: always fits.
        if p.smem <= SMEM_LIMIT or strip == span == 1:
            return p
        if strip > 1:
            strip = even(ho, strip // 2)
        else:
            span = even(wo, span // 2)


@functools.lru_cache(maxsize=None)
def _device_plan(p: Plan, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in (p.strips, p.spans))


def plan_for(x: torch.Tensor, res: torch.Tensor) -> Plan:
    """The plan `residual_bn` launches for these operands."""
    _, ho, wo, c = x.shape
    _, hi, wi, _ = res.shape
    wide = all(t.data_ptr() % 16 == 0 for t in (x, res))  # y is a fresh, aligned allocation
    return plan(hi, wi, ho, wo, c, x.dtype, wide)


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
    dtype, device, stream = _build.launch_args("residual_bn", x, res, s, t)
    hidx, hwt = _device_pairs(Hi, Ho, x.dtype, x.device)
    widx, wwt = _device_pairs(Wi, Wo, x.dtype, x.device)
    p = plan_for(x, res)
    strips, spans = _device_plan(p, x.device)
    y = torch.empty_like(x)
    fn = _build.entry("residual_bn", "rn_residual_bn", _ARGS)
    rc = fn(x.data_ptr(), res.data_ptr(), hidx.data_ptr(), hwt.data_ptr(), widx.data_ptr(),
            wwt.data_ptr(), strips.data_ptr(), spans.data_ptr(), s.data_ptr(), t.data_ptr(),
            y.data_ptr(), B, Hi, Wi, Ho, Wo, C, p.vec, p.strip, p.span, p.rows_in, p.cols_in,
            dtype, device, stream)
    residual_bn.launches += 1
    _build.check("residual_bn", "rn_residual_bn", rc)
    return y


residual_bn.launches = 0


def resize_tf1_transpose(g: torch.Tensor, in_hw: tuple[int, int], dtype: torch.dtype) -> torch.Tensor:
    """The transpose of `resize_bilinear_tf1` from `in_hw` to g's (H, W) at
    io dtype `dtype`, in f32: (B, Ho, Wo, C) -> (B, Hi, Wi, C), the columns'
    matrix first, then the rows'."""
    mh, mw = (device_matrix("tf1", i, o, dtype, g.device) for i, o in zip(in_hw, g.shape[1:3]))
    t = torch.einsum("bhwc,jw->bhjc", g, mw)
    return torch.einsum("bhjc,ih->bijc", t, mh)


class _ResidualBn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res, s, t):
        ctx.save_for_backward(x, res, s)
        return residual_bn(x, res, s, t)

    @staticmethod
    def backward(ctx, gy):
        x, res, s = ctx.saved_tensors
        need_x, need_res, need_s, need_t = ctx.needs_input_grad
        g = gy.float()
        gx = gres = gs = gt = None
        if need_x or need_res:
            gz = g * s.float()
            gx = gz.to(x.dtype) if need_x else None
            if need_res:
                gres = resize_tf1_transpose(gz, tuple(res.shape[1:3]), res.dtype).to(res.dtype).contiguous()
        if need_s:
            y = resize_bilinear_tf1(res, tuple(x.shape[1:3]), f32_out=True)
            gs = (g * (x.float() + y)).sum((0, 1, 2))
        if need_t:
            gt = g.sum((0, 1, 2))
        return gx, gres, gs, gt


def residual_bn_autograd(x: torch.Tensor, res: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """`residual_bn` with gradients for x, res, s and t."""
    return _ResidualBn.apply(x, res, s, t)
