"""The whole dense head in one launch, logits and softmax: csrc/dense_head.cu.

Replaces roomnet_tpu/ops/pallas/dense_head.py:dense_head_pallas. Each hidden
layer is dense -> relu6 -> BN (folded with the caller's eps), the last is
dense + bias -> relu6; probs = softmax(logits). Everything is f32 whatever
the compute dtype, as the TPU kernel computes it. Unlike that kernel, this
one takes any flat_len, widths and number of layers (roomnet-tiny's head is
256 -> 16 -> 8 -> 6), and writes the logits as well as the probs.

The weights travel as one packed f32 buffer (`pack_head`). On an H100 the
head is launch-bound: ~6 kFLOP per image at 224. `plan` picks the kernel's
variant from the packed size: "resident" (all weights in shared memory, a
warp per batch row, no block barrier between layers) where they fit, else
"streamed" (weights staged through shared memory in chunks).

On a CPU tensor `dense_head` runs `dense_head_plain`; on a CUDA tensor it
launches the kernel or raises. `dense_head_autograd` is the same call under
autograd: its backward recomputes the four layers with `dense_head_plain`
(in f32; relu6's derivative 0.5 at its ties, as in JAX) and takes their
gradient of the logits for x and the packed params, through which it
reaches the kernels, the folded BN and the bias. The probs get none.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import blocks
from . import _build
from ._build import I, P

_ARGS = [P, P, P, P, I, P, I, I, I, I, I, I, I, P]
MAX_LAYERS = 8
_KCHUNK = 4096  # streamed: f32 weights staged in shared memory at a time
_ACT_FLOATS = 2048  # streamed: f32 activations per block, for both ping-pong buffers
WARPS = 4  # resident: warps per block, one batch row each
RESIDENT_SMEM = 48 << 10  # resident: the most shared memory a block takes


def pack_head(dense_layers: list[dict],
              bn_eps: float = blocks.BN_EPS) -> tuple[torch.Tensor, tuple[int, ...]]:
    """(packed f32 params, widths) for the kernel: per layer its (in, out)
    kernel row-major, then the folded BN (w, b) of a hidden layer or the bias
    of the last. widths = (flat_len, units..., classes)."""
    parts, widths = [], [dense_layers[0]["kernel"].shape[0]]
    for i, layer in enumerate(dense_layers):
        parts.append(layer["kernel"].float().reshape(-1))
        widths.append(layer["kernel"].shape[1])
        if i < len(dense_layers) - 1:
            parts.extend(blocks.bn_fold(layer["bn"], bn_eps))
        else:
            parts.append(layer["bias"].float())
    return torch.cat(parts).contiguous(), tuple(int(w) for w in widths)


def _unpack(packed: torch.Tensor, widths: tuple[int, ...]):
    off, layers = 0, []
    n = len(widths) - 1
    for i in range(n):
        fin, fout = widths[i], widths[i + 1]
        k = packed[off: off + fin * fout].view(fin, fout)
        off += fin * fout
        extra = 2 if i < n - 1 else 1
        layers.append((k, [packed[off + j * fout: off + (j + 1) * fout] for j in range(extra)]))
        off += extra * fout
    return layers


def dense_head_plain(x: torch.Tensor, packed: torch.Tensor, widths: tuple[int, ...]):
    """The kernel's arithmetic in PyTorch, in f32: (logits, probs)."""
    layers = _unpack(packed, widths)
    h = x.float()
    for i, (k, extra) in enumerate(layers):
        if i < len(layers) - 1:
            h = blocks.relu6(blocks.dense(h, k)) * extra[0] + extra[1]
        else:
            h = blocks.relu6(blocks.dense(h, k, extra[0]))
    return h, torch.softmax(h, dim=-1)


@dataclasses.dataclass(frozen=True)
class Plan:
    variant: str  # "resident" or "streamed"
    rows: int     # batch rows per block
    smem: int     # bytes of shared memory per block


def plan(widths: tuple[int, ...], n_params: int) -> Plan:
    """The kernel's variant for a head of these widths and packed size:
    resident when the weights (rounded up to a 16-byte multiple) and each
    warp's two activation buffers fit RESIDENT_SMEM, else streamed."""
    maxw = max(widths)
    resident = (-(-n_params // 4) * 4 + WARPS * 2 * maxw) * 4
    if resident <= RESIDENT_SMEM:
        return Plan("resident", WARPS, resident)
    rows = max(1, min(16, _ACT_FLOATS // (2 * maxw)))
    return Plan("streamed", rows, (2 * rows * maxw + _KCHUNK) * 4)


def dense_head(x: torch.Tensor, packed: torch.Tensor, widths: tuple[int, ...]):
    """x (B, flat_len) in the io dtype -> (logits, probs), both (B, classes) f32."""
    if x.device.type == "cpu":
        _build.count_plain("dense_head")
        return dense_head_plain(x, packed, widths)
    n = len(widths) - 1
    B, F = x.shape
    expect = sum(widths[i] * widths[i + 1] + (2 if i < n - 1 else 1) * widths[i + 1] for i in range(n))
    if not 1 <= n <= MAX_LAYERS or F != widths[0] or packed.numel() != expect:
        raise ValueError(f"dense_head: x {tuple(x.shape)} and {packed.numel()} params "
                         f"do not fit widths {widths}")
    if packed.dtype != torch.float32:
        raise TypeError("dense_head: packed params must be float32")
    dtype, device, stream = _build.launch_args("dense_head", x, packed)
    p = plan(widths, packed.numel())
    logits = torch.empty((B, widths[-1]), dtype=torch.float32, device=x.device)
    probs = torch.empty_like(logits)
    dims = (ctypes.c_int * (n + 1))(*widths)
    _build.launch("dense_head", "rn_dense_head", _ARGS, x.data_ptr(), packed.data_ptr(), logits.data_ptr(),
                  probs.data_ptr(), B, ctypes.cast(dims, P), n, packed.numel(), int(p.variant == "resident"), p.rows,
                  _KCHUNK, dtype, device, stream)
    return logits, probs


class _DenseHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, packed, widths):
        ctx.save_for_backward(x, packed)
        ctx.widths = widths
        logits, probs = dense_head(x, packed, widths)
        ctx.mark_non_differentiable(probs)
        return logits, probs

    @staticmethod
    def backward(ctx, g_logits, _g_probs):
        x, packed = ctx.saved_tensors
        xr = x.detach().float().requires_grad_()
        pr = packed.detach().requires_grad_()
        with torch.enable_grad():
            logits, _ = dense_head_plain(xr, pr, ctx.widths)
        gx, gp = torch.autograd.grad(logits, (xr, pr), g_logits)
        return gx.to(x.dtype), gp, None


def dense_head_autograd(x: torch.Tensor, packed: torch.Tensor, widths: tuple[int, ...]):
    """`dense_head` with the logits' gradient for x and packed; the probs
    are not differentiable."""
    return _DenseHead.apply(x, packed, widths)
