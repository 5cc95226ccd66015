"""The work one forward needs, counted from the configuration's shapes: the
yardstick of the roofline and MFU metrics, frozen here with the benchmark.

Per launch of the serving forward (24 at 224: 10 conv3x3, 10 relu6_pool_bn,
3 residual_bn, 1 dense_head) `launches` gives the bytes and operations the
function needs and the peak they run at, with the arithmetic of the kernel
table's bound (chip_smoke.py phase 3):

  * bytes: each operand read once and each result written once, at the
    configuration's dtype (the folded conv kernel too; BN affines, the
    head's packed weights and its logits and probs in f32); a pool reads
    only the rows and columns some window covers, a residual only the
    shortcut's rows and columns with a nonzero interpolation weight;
  * operations: a conv 2 per multiply-add; a pool k*k + 3 per output and
    one per input read (ReLU6); a residual three per tap pair on each axis
    (two taps per axis: the TF1 bilinear resize) and six per output (add,
    BN); the head 2 per multiply-add and 4 per unit;
  * peak: bf16 convs at the tensor cores' bf16 rate; f32 convs with
    Cin % 8 == 0 run on the TF32 split, three TF32 products per f32 product
    (what f32 accuracy needs), so they count three times their operations
    at the TF32 rate; everything else at the CUDA cores' f32 rate.

The bound of a launch is max(bytes / HBM bandwidth, operations / peak).

`forward_flops` is the model's work for MFU: the same operations, the
resize at two taps per axis. This departs from the program's
utils/roofline.summarize, which counts each residual's resize as two dense
contractions over a whole spatial axis (303.3 + 23.3 of its 1,502.1 GFLOP
per batch-256 forward) where a bilinear resize reads two taps per axis
(about 3 GFLOP), and so overstates the forward's work by about 28%; its
per-group bytes leave out weights and count whole pool inputs.

Peaks: benchmark/lib/peaks.py (989 TFLOP/s bf16, 495 TFLOP/s TF32, 67
TFLOP/s f32 outside the tensor cores, 3.35 TB/s HBM).
"""

from __future__ import annotations

import numpy as np

from benchmark.lib.peaks import HBM_BYTES_PER_S, PEAK_BF16, PEAK_F32, PEAK_TF32

from . import reference as ref

TF32X3_PASSES = 3
F32_BYTES, BF16_BYTES = 4, 2


def io_bytes(cfg: dict) -> int:
    return {"bf16": BF16_BYTES, "f32": F32_BYTES}[cfg["precision"]]


def conv_peak(cfg: dict, cin: int) -> tuple[int, float]:
    """(operations per multiply-add, peak) of a conv with `cin` inputs."""
    if cfg["precision"] == "bf16":
        return 2, PEAK_BF16
    if cin % 8 == 0:
        return 2 * TF32X3_PASSES, PEAK_TF32
    return 2, PEAK_F32


def _nonzero_sources(in_size: int, out_size: int) -> int:
    m = ref.interp_tf1(in_size, out_size)
    return int(np.count_nonzero(m.any(axis=1)))


def launches(cfg: dict, batch: int) -> list[dict]:
    """One dict per launch of the forward, in order: {"kernel", "site",
    "bytes", "ops", "peak", "flops"} ("flops": the model's operations,
    without the TF32 split's factor)."""
    e = io_bytes(cfg)
    k = cfg["kernel_size"]
    s = cfg["im_side"]
    out = []
    for bi, b in enumerate(ref.geometry(cfg)):
        c = b["filters"]
        res_side = None
        for d in range(b["depth"]):
            cin = b["cin"] if d == 0 else c
            so = s - (k - 1)
            macs = batch * so * so * c * k * k * cin
            per_mac, peak = conv_peak(cfg, cin)
            out.append({"kernel": "conv3x3", "site": f"b{bi}.conv{d}",
                        "bytes": e * (batch * s * s * cin + k * k * cin * c + batch * so * so * c),
                        "ops": per_mac * macs, "peak": peak, "flops": 2 * macs})
            s = so
            pk, ps = b["pool"] or (1, 1)
            po = (s - pk) // ps + 1
            span = (po - 1) * ps + pk
            read = batch * span * span * c
            ops = batch * po * po * c * (pk * pk + 3) + read
            out.append({"kernel": "relu6_pool_bn", "site": f"b{bi}.pool{d}",
                        "bytes": e * (read + batch * po * po * c) + 2 * F32_BYTES * c,
                        "ops": ops, "peak": PEAK_F32, "flops": ops})
            s = po
            if d == 0:
                res_side = s
        if b["depth"] > 1:
            rows = _nonzero_sources(res_side, s)
            cols = _nonzero_sources(res_side, s)
            ops = 3 * batch * s * cols * c + 6 * batch * s * s * c
            out.append({"kernel": "residual_bn", "site": f"b{bi}.residual",
                        "bytes": e * batch * (rows * cols * c + 2 * s * s * c) + 2 * F32_BYTES * c,
                        "ops": ops, "peak": PEAK_F32, "flops": ops})
    widths = [ref.flat_len(cfg), *cfg["dense_units"], cfg["num_classes"]]
    params = sum(widths[i] * widths[i + 1] for i in range(len(widths) - 1)) \
        + 2 * sum(cfg["dense_units"]) + cfg["num_classes"]
    ops = batch * (2 * sum(widths[i] * widths[i + 1] for i in range(len(widths) - 1)) + 4 * sum(widths[1:]))
    out.append({"kernel": "dense_head", "site": "head",
                "bytes": e * batch * widths[0] + F32_BYTES * (params + 2 * batch * cfg["num_classes"]),
                "ops": ops, "peak": PEAK_F32, "flops": ops})
    for launch in out:
        launch["bound_s"] = max(launch["bytes"] / HBM_BYTES_PER_S, launch["ops"] / launch["peak"])
    return out


def bound_s(cfg: dict, batch: int, kernel: str) -> float:
    """The least time of one forward's launches of `kernel`, in seconds."""
    return sum(launch["bound_s"] for launch in launches(cfg, batch) if launch["kernel"] == kernel)


def forward_flops(cfg: dict, batch: int) -> float:
    """The model's operations in one forward of `batch` images."""
    return float(sum(launch["flops"] for launch in launches(cfg, batch)))


def forward_ideal_s(cfg: dict, batch: int) -> float:
    """One forward's operations at the configuration's peaks: bf16 all at
    the bf16 rate; f32 the convs with Cin % 8 == 0 at the TF32 rate over
    three, the rest at the f32 rate."""
    total = 0.0
    for launch in launches(cfg, batch):
        if cfg["precision"] == "bf16":
            total += launch["flops"] / PEAK_BF16
        elif launch["kernel"] == "conv3x3" and launch["peak"] == PEAK_TF32:
            total += launch["flops"] / (PEAK_TF32 / TF32X3_PASSES)
        else:
            total += launch["flops"] / PEAK_F32
    return total
