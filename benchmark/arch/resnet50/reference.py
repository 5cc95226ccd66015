"""ResNet-50 v1.5 in plain PyTorch: the yardstick that decides `correct`.

A frozen, independent statement of the model, written from the published
description (He et al., arXiv:1512.03385, Table 1 and section 3; the "v1.5"
stride placement of torchvision's models/resnet.py `Bottleneck` and of
NVIDIA DeepLearningExamples' ResNet50 v1.5: a downsampling bottleneck
strides on its 3x3 conv) and not from the program under test. It imports
torch and numpy only.

    input (B,S,S,3) uint8 BGR -> RGB, x / 255, (x - mean) / std  (NCHW)
    stem: conv 7x7/2 pad 3 -> BN -> ReLU -> max pool 3x3/2 pad 1
    per bottleneck (stride s: 2 in the first block of stages 2-4):
        o = ReLU(BN(conv1x1(x)))
        o = ReLU(BN(conv3x3(o, pad 1, stride s)))
        x = ReLU(BN(conv1x1(o)) + shortcut), shortcut = BN(conv1x1(x, stride s))
            in a stage's first block, else x
    global average pool -> FC -> logits; probs = softmax(logits)

BN is the inference form, from running statistics: y = (x - mean) /
sqrt(var + eps) * scale + bias, eps 1e-5. Everything in float32 with TF32
off (`precision`).

Departures from torchvision's module, none of them in the arithmetic:
  * variables are a flat ``{path: tensor}`` dict (`param_paths`,
    `stat_paths`) with HWIO conv kernels and an (in, out) FC kernel,
    permuted here to torch's layouts;
  * the input is uint8 BGR NHWC images (the classifier's), normalised here;
  * a lower precision is emulated by rounding (`rounder`) where a
    reduced-precision network stores its tensors: the normalised input,
    each conv kernel, and each conv's output after its BN, ReLU and residual;
    every sum stays float32, and so do the pools and the FC;
  * `calibrate` sets the BN running statistics and scales the FC from a
    seeded batch (the benchmark's weights, weights.py).

`TINY` is the configuration the benchmark's tests run this architecture's
cells at on the CPU: a stride-2 stage and projection shortcuts at 32
pixels.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]
TOP1_MEDIAN = 0.5  # calibrate: the median over the calibration images of the top-1 probability

TINY = {"name": "resnet50-tiny", "arch": "resnet50", "num_classes": 10, "im_side": 32, "stem_width": 8,
        "mid_widths": [4, 8], "depths": [2, 1], "expansion": 4, "stride_on": "3x3", "bn_eps": 1e-5,
        "mean": MEAN, "std": STD}


def blocks(cfg: dict):
    """(stage, block, cin, mid, stride) of every bottleneck, in order."""
    cin = cfg["stem_width"]
    for si, (mid, depth) in enumerate(zip(cfg["mid_widths"], cfg["depths"])):
        for bi in range(depth):
            yield si, bi, cin, mid, 2 if bi == 0 and si > 0 else 1
            cin = mid * cfg["expansion"]


def _paths(cfg: dict, bn_fields: tuple, with_kernels: bool) -> dict[str, tuple[int, ...]]:
    out = {}

    def conv(path, shape):
        if with_kernels:
            out[path] = shape

    def bn(prefix, c):
        for f in bn_fields:
            out[f"{prefix}/{f}"] = (c,)

    w = cfg["stem_width"]
    conv("stem/conv", (7, 7, 3, w))
    bn("stem/bn", w)
    for si, bi, cin, mid, _ in blocks(cfg):
        p, out_c = f"layer{si + 1}/{bi}", mid * cfg["expansion"]
        conv(f"{p}/conv1", (1, 1, cin, mid))
        bn(f"{p}/bn1", mid)
        conv(f"{p}/conv2", (3, 3, mid, mid))
        bn(f"{p}/bn2", mid)
        conv(f"{p}/conv3", (1, 1, mid, out_c))
        bn(f"{p}/bn3", out_c)
        if bi == 0:
            conv(f"{p}/proj/conv", (1, 1, cin, out_c))
            bn(f"{p}/proj/bn", out_c)
    if with_kernels:
        d = cfg["mid_widths"][-1] * cfg["expansion"]
        out["fc/kernel"] = (d, cfg["num_classes"])
        out["fc/bias"] = (cfg["num_classes"],)
    return out


def param_paths(cfg: dict) -> dict[str, tuple[int, ...]]:
    """{path: shape} of every learned parameter (conv kernels, BN scale and
    bias, the FC), in graph order: torchvision's `parameters()`."""
    return _paths(cfg, ("scale", "bias"), True)


def stat_paths(cfg: dict) -> dict[str, tuple[int, ...]]:
    """{path: shape} of every BN's running mean and variance (torchvision's
    buffers)."""
    return _paths(cfg, ("mean", "var"), False)


@contextlib.contextmanager
def precision(name: str):
    """TF32 off, whatever the precision (its rounding is emulated); the flags
    are restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


FP8_TOP = 448.0  # float8 e4m3's largest finite value


def rounder(name: str):
    """x -> x rounded to the precision's storage type: bfloat16, or float8
    e4m3 scaled per tensor so that its largest magnitude maps to the
    format's largest; the identity for "f32"."""
    if name == "f32":
        return lambda x: x
    if name == "bf16":
        return lambda x: x.to(torch.bfloat16).float()
    if name != "fp8":
        raise ValueError(f"unknown precision {name!r}")

    def fp8(x):
        amax = x.abs().amax()
        scale = torch.where(amax > 0, FP8_TOP / amax, torch.ones_like(amax))
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    return fp8


def normalize(x_bgr_uint8: torch.Tensor, cfg: dict) -> torch.Tensor:
    """uint8 BGR NHWC -> float32 RGB NCHW, (x / 255 - mean) / std."""
    x = x_bgr_uint8.flip(-1).float() / 255.0
    x = (x - torch.tensor(cfg["mean"], device=x.device)) / torch.tensor(cfg["std"], device=x.device)
    return x.permute(0, 3, 1, 2)


def forward(v: dict, x_bgr_uint8: torch.Tensor, cfg: dict, prec: str = "f32", *, calib=None) -> torch.Tensor:
    """Logits (B, classes) float32 of uint8 BGR images, at `prec`.

    `calib`, a dict: each BN first takes the mean and (biased) variance of
    its own input over this batch as its running statistics, writes them
    into `calib` by path, and applies them (`calibrate`)."""
    q = rounder(prec)
    eps = cfg["bn_eps"]

    def conv(x, path, stride=1, padding=0):
        return F.conv2d(x, q(v[path]).permute(3, 2, 0, 1), stride=stride, padding=padding)

    def bn(x, path):
        if calib is not None:
            calib[f"{path}/mean"] = x.mean((0, 2, 3))
            calib[f"{path}/var"] = x.var((0, 2, 3), unbiased=False)
        stats = calib if calib is not None else v
        inv = torch.rsqrt(stats[f"{path}/var"] + eps)
        scale = (v[f"{path}/scale"] * inv).view(1, -1, 1, 1)
        return (x - stats[f"{path}/mean"].view(1, -1, 1, 1)) * scale + v[f"{path}/bias"].view(1, -1, 1, 1)

    with precision(prec):
        x = q(normalize(x_bgr_uint8, cfg))
        x = q(F.relu(bn(conv(x, "stem/conv", 2, 3), "stem/bn")))
        x = F.max_pool2d(x, 3, 2, 1)
        v15 = cfg["stride_on"] == "3x3"
        for si, bi, _, _, stride in blocks(cfg):
            p = f"layer{si + 1}/{bi}"
            o = q(F.relu(bn(conv(x, f"{p}/conv1", 1 if v15 else stride), f"{p}/bn1")))
            o = q(F.relu(bn(conv(o, f"{p}/conv2", stride if v15 else 1, 1), f"{p}/bn2")))
            shortcut = q(bn(conv(x, f"{p}/proj/conv", stride), f"{p}/proj/bn")) if bi == 0 else x
            x = q(F.relu(bn(conv(o, f"{p}/conv3"), f"{p}/bn3") + shortcut))
        return x.mean((2, 3)) @ v["fc/kernel"] + v["fc/bias"]


@torch.no_grad()
def probs(v: dict, x_bgr_uint8, cfg: dict, prec: str = "f32", rows: int = 256) -> np.ndarray:
    """Softmax probabilities (N, classes) as float64 numpy, in blocks of
    `rows` images (a uint8 host or device array; each block goes to the
    variables' device)."""
    dev = next(iter(v.values())).device
    out = []
    for at in range(0, len(x_bgr_uint8), rows):
        xb = torch.as_tensor(x_bgr_uint8[at: at + rows]).to(dev)
        out.append(torch.softmax(forward(v, xb, cfg, prec), -1).double().cpu().numpy())
    return np.concatenate(out)


@torch.no_grad()
def calibrate(v: dict, x_bgr_uint8: torch.Tensor, cfg: dict) -> dict:
    """A copy of `v` calibrated on `x_bgr_uint8` in float32: every BN takes
    the mean and variance of its input over the batch as its running
    statistics (each after the earlier ones are set), so that its output
    has zero mean and unit variance there and depth does not blow the
    activations up; then the FC kernel and bias are scaled by one factor so
    that the median over the batch of the top-1 probability is TOP1_MEDIAN
    (a 1000-way softmax of random weights is otherwise near uniform)."""
    calib: dict = {}
    logits = forward(v, x_bgr_uint8, cfg, "f32", calib=calib).double()

    def median_top1(a):
        return torch.softmax(a * logits, -1).amax(-1).median().item()

    lo, hi = 0.0, 1.0
    while median_top1(hi) < TOP1_MEDIAN:
        lo, hi = hi, 2.0 * hi
    for _ in range(60):  # bisection: the top-1 probability grows with the factor
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if median_top1(mid) < TOP1_MEDIAN else (lo, mid)
    a = 0.5 * (lo + hi)
    calib["fc/kernel"] = v["fc/kernel"] * a
    calib["fc/bias"] = v["fc/bias"] * a
    return {**v, **calib}
