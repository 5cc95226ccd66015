"""The work one forward needs, counted from the configuration's shapes: the
yardstick of the roofline and MFU metrics, frozen here with the benchmark.

Per launch of the serving forward (models/resnet.py; at 224 the stem, the
max pool, 16 conv3x3, 36 conv1x1, the average pool and the FC) `launches`
gives the bytes and operations the function needs and the peak they run
at:

  * bytes: each operand read once and each result written once, in bf16
    (the activations, the folded kernels) and f32 (the folded BN biases,
    the pooled features, the FC and its logits); a 1x1 conv at stride 2
    reads only the pixels it uses; a conv with a residual reads it once;
  * operations: a conv or the FC 2 per multiply-add; a max pool 9 per
    output and one per output for its ReLU; the average pool one per input;
  * peak: the convs at the tensor cores' bf16 rate, the pools and the f32
    FC at the CUDA cores' f32 rate.

The bound of a launch is max(bytes / HBM bandwidth, operations / peak).
`launches(cfg, b)` lists, for each kernel of the program that a roofline
reads ("conv3x3", "conv1x1"), as many launches of it as one forward makes.

`forward_flops` is the model's work for MFU, the same operations (8.18
GFLOP an image at 224, the convs' and the FC's 4.09 G multiply-adds twice);
`forward_ideal_s` puts all of it at the bf16 rate, as RoomNet's bf16 cell
does.

Peaks: benchmark/lib/peaks.py (989 TFLOP/s bf16, 67 TFLOP/s f32 outside
the tensor cores, 3.35 TB/s HBM).
"""

from __future__ import annotations

from benchmark.lib.peaks import HBM_BYTES_PER_S, PEAK_BF16, PEAK_F32

from . import reference as ref

BF16_BYTES, F32_BYTES = 2, 4


def _conv(kernel, site, batch, side, cin, cout, k, stride, pad, residual=False):
    so = (side + 2 * pad - k) // stride + 1
    read = batch * (side * side if k > 1 else so * so) * cin
    out = batch * so * so * cout
    macs = out * k * k * cin
    return {"kernel": kernel, "site": site, "ops": 2 * macs, "flops": 2 * macs, "peak": PEAK_BF16,
            "bytes": BF16_BYTES * (read + k * k * cin * cout + out * (2 if residual else 1)) + F32_BYTES * cout}


def launches(cfg: dict, batch: int) -> list[dict]:
    """One dict per launch of the forward, in order: {"kernel", "site",
    "bytes", "ops", "peak", "flops", "bound_s"}."""
    if cfg["precision"] != "bf16":
        raise ValueError("the port runs ResNet-50 in bf16 alone")
    s, w = cfg["im_side"], cfg["stem_width"]
    out = [_conv("stem", "stem", batch, s, 3, w, 7, 2, 3)]
    s = (s + 6 - 7) // 2 + 1
    so = (s + 2 - 3) // 2 + 1
    pool = batch * so * so * w
    out.append({"kernel": "max_pool", "site": "stem.pool", "ops": 10 * pool, "flops": 10 * pool, "peak": PEAK_F32,
                "bytes": BF16_BYTES * (batch * s * s * w + pool)})
    s = so
    for si, bi, cin, mid, stride in ref.blocks(cfg):
        p, c = f"layer{si + 1}/{bi}", mid * cfg["expansion"]
        so = (s - 1) // stride + 1
        s1, s3 = (1, stride) if cfg["stride_on"] == "3x3" else (stride, 1)
        out.append(_conv("conv1x1", f"{p}/conv1", batch, s, cin, mid, 1, s1, 0))
        out.append(_conv("conv3x3", f"{p}/conv2", batch, (s - 1) // s1 + 1, mid, mid, 3, s3, 1))
        if bi == 0:
            out.append(_conv("conv1x1", f"{p}/proj", batch, s, cin, c, 1, stride, 0))
        out.append(_conv("conv1x1", f"{p}/conv3", batch, so, mid, c, 1, 1, 0, residual=True))
        s = so
    c = cfg["mid_widths"][-1] * cfg["expansion"]
    out.append({"kernel": "avg_pool", "site": "head.pool", "ops": batch * s * s * c, "flops": batch * s * s * c,
                "peak": PEAK_F32, "bytes": BF16_BYTES * batch * s * s * c + F32_BYTES * batch * c})
    n = cfg["num_classes"]
    out.append({"kernel": "fc", "site": "head.fc", "ops": 2 * batch * c * n, "flops": 2 * batch * c * n,
                "peak": PEAK_F32, "bytes": F32_BYTES * (batch * c + c * n + n + batch * n)})
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
    """One forward's operations at the bf16 rate."""
    return forward_flops(cfg, batch) / PEAK_BF16
