"""RoomNet in plain PyTorch: the yardstick that decides `correct`.

A frozen, independent statement of the model (ironhide23586/RoomNet
network.py:125-244), written from the published graph and not from the
program under test: it imports torch and numpy only (and cv2 to read an
image file).

    a file: cv2.imread (BGR) -> centre square crop -> cv2.resize to S
                                                            network.py:137-152
    input (B,S,S,3) uint8 BGR -> RGB in [-1, 1]            network.py:148-159
    per block: conv3x3 VALID, no bias -> ReLU6 -> avg pool VALID -> BN
               (the first layer's output is the block's shortcut)
               a block of depth > 1: BN(x + resize_tf1(shortcut))  :181-203
    flatten NHWC -> dense -> ReLU6 -> BN (x3) -> dense + bias -> ReLU6
    probs = softmax(logits)                                 :207-244

Variables are a flat ``{path: tensor}`` dict in the parameter files' key
scheme (``blocks/<b>/conv/<d>`` HWIO, ``blocks/<b>/bn/<d>/{scale,bias,mean,
var}``, ``blocks/<b>/res_bn/...``, ``dense/<i>/kernel`` (in, out),
``dense/<i>/bias``, ``dense/<i>/bn/...``). Inference BN uses the moving
statistics, eps 1e-3.

Precision: everything in float32 with TF32 off (`precision("f32")`). A
lower precision is emulated by rounding to bfloat16 (`"bf16"`) or to
float8 e4m3 with a per-tensor scale (`"fp8"`) where a reduced-precision
network stores its tensors: the input, each conv kernel, each conv output,
each pool + BN output, the residual's row pass and its BN output. Every
sum stays in float32 and the dense head in float32. `"tf32"` runs the f32
forward with TF32 on.

`TINY` is the configuration the benchmark's tests run RoomNet's cells at
on the CPU, in each cell's own precision.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
LOGIT_MEAN = 3.0  # calibrate: the logits sit inside ReLU6's (0, 6)

TINY = {"name": "roomnet-tiny", "arch": "roomnet", "num_classes": 6, "im_side": 32, "block_filters": [8, 16],
        "block_depths": [1, 2], "block_pools": [[3, 1], [4, 2]], "kernel_size": 3, "dense_units": [16, 8],
        "bn_eps": 0.001}


def geometry(cfg: dict) -> list[dict]:
    """Per block: {"filters", "depth", "pool": (k, s) or None, "cin"}."""
    blocks, cin = [], 3
    for f, d, p in zip(cfg["block_filters"], cfg["block_depths"], cfg["block_pools"]):
        blocks.append({"filters": f, "depth": d, "pool": tuple(p) if p else None, "cin": cin})
        cin = f
    return blocks


def param_paths(cfg: dict) -> dict[str, tuple[int, ...]]:
    """{path: shape} of every variable of the configuration, in graph order."""
    out = {}
    k = cfg["kernel_size"]

    def bn(prefix, c):
        for f in ("scale", "bias", "mean", "var"):
            out[f"{prefix}/{f}"] = (c,)

    for bi, b in enumerate(geometry(cfg)):
        for d in range(b["depth"]):
            out[f"blocks/{bi}/conv/{d}"] = (k, k, b["cin"] if d == 0 else b["filters"], b["filters"])
            bn(f"blocks/{bi}/bn/{d}", b["filters"])
        if b["depth"] > 1:
            bn(f"blocks/{bi}/res_bn", b["filters"])
    d_in = flat_len(cfg)
    units = list(cfg["dense_units"]) + [cfg["num_classes"]]
    for di, u in enumerate(units):
        out[f"dense/{di}/kernel"] = (d_in, u)
        if di < len(units) - 1:
            bn(f"dense/{di}/bn", u)
        else:
            out[f"dense/{di}/bias"] = (u,)
        d_in = u
    return out


def sides(cfg: dict) -> list[list[int]]:
    """Per block, the activation side after each of its layers."""
    s, k, out = cfg["im_side"], cfg["kernel_size"], []
    for b in geometry(cfg):
        cur = []
        for _ in range(b["depth"]):
            s -= k - 1
            if b["pool"]:
                s = (s - b["pool"][0]) // b["pool"][1] + 1
            cur.append(s)
        out.append(cur)
    return out


def flat_len(cfg: dict) -> int:
    return sides(cfg)[-1][-1] ** 2 * cfg["block_filters"][-1]


@contextlib.contextmanager
def precision(name: str):
    """TF32 on for "tf32", off otherwise; the flags are restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = name == "tf32"
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


FP8_TOP = 448.0  # float8 e4m3's largest finite value


def rounder(name: str):
    """x -> x rounded to the precision's storage type: bfloat16, or float8
    e4m3 scaled per tensor so that its largest magnitude maps to the
    format's largest (unscaled, small values would flush to zero); the
    identity for "f32" and "tf32"."""
    if name in ("f32", "tf32"):
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


def interp_tf1(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 matrix of TF1's legacy bilinear resize
    (align_corners=False, half_pixel_centers=False): src = dst * in / out,
    the coefficients in float32 like TF's CPU kernel."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = np.float32(in_size) / np.float32(out_size)
    src = np.arange(out_size, dtype=np.float32) * scale
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo.astype(np.float32)).astype(np.float32)
    m = np.zeros((in_size, out_size), np.float32)
    cols = np.arange(out_size)
    np.add.at(m, (lo, cols), np.float32(1.0) - frac)
    np.add.at(m, (hi, cols), frac)
    return m


def relu6(x):
    return x.clamp(0.0, 6.0)


def bn_affine(v: dict, prefix: str):
    inv = torch.rsqrt(v[f"{prefix}/var"] + BN_EPS)
    w = v[f"{prefix}/scale"] * inv
    return w, v[f"{prefix}/bias"] - v[f"{prefix}/mean"] * w


def read_image(path: str, side: int) -> np.ndarray:
    """(side, side, 3) uint8 BGR of an image file, as the published
    inference reads one (network.py:137-152): cv2.imread, the centred square
    crop of the longer axis, cv2.resize (bilinear) of the uint8 crop."""
    import cv2

    im = cv2.imread(path)
    if im is None:
        raise ValueError(f"cv2 cannot read {path}")
    h, w = im.shape[:2]
    off = abs((w - h) // 2)
    im = im[:, off: off + h] if h < w else im[off: off + w] if w < h else im
    return np.ascontiguousarray(cv2.resize(im, (side, side)))


def normalize(x_bgr_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 BGR NHWC -> float32 RGB NCHW in [-1, 1] (network.py:148-159)."""
    x = x_bgr_uint8.flip(-1).float() / 255.0 * 2.0 - 1.0
    return x.permute(0, 3, 1, 2)


def forward(v: dict, x_bgr_uint8: torch.Tensor, cfg: dict, prec: str = "f32", *, calib=None) -> torch.Tensor:
    """Logits (B, classes) float32 of uint8 BGR images, at `prec`.

    `calib`, a dict: each BN of the dense head first takes the mean and
    variance of its own input over this batch as its moving statistics,
    writes them into `calib` by path, and applies them; the last layer
    is scaled likewise (`calibrate`)."""
    q = rounder(prec)

    def bn(x, path):
        if calib is not None and path.startswith("dense/"):
            axes = (0, 2, 3) if x.ndim == 4 else (0,)
            mean = x.mean(axes)
            shape = (1, -1) + (1,) * (x.ndim - 2)
            calib[f"{path}/mean"] = mean
            calib[f"{path}/var"] = (x - mean.view(shape)).square().mean(axes)
            s, t = bn_affine({**v, **calib}, path)
        else:
            s, t = bn_affine(v, path)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x * s.view(shape) + t.view(shape)

    with precision(prec):
        x = q(normalize(x_bgr_uint8))
        for bi, b in enumerate(geometry(cfg)):
            shortcut = None
            for d in range(b["depth"]):
                w = q(v[f"blocks/{bi}/conv/{d}"]).permute(3, 2, 0, 1)
                x = q(F.conv2d(x, w))
                x = relu6(x)
                if b["pool"]:
                    x = F.avg_pool2d(x, b["pool"][0], b["pool"][1])
                x = q(bn(x, f"blocks/{bi}/bn/{d}"))
                if d == 0:
                    shortcut = x
            if b["depth"] > 1:
                hs, ws = x.shape[2], x.shape[3]
                mh = torch.from_numpy(interp_tf1(shortcut.shape[2], hs)).to(x.device)
                mw = torch.from_numpy(interp_tf1(shortcut.shape[3], ws)).to(x.device)
                r = q(torch.einsum("bchw,hi->bciw", shortcut, mh))
                r = torch.einsum("bciw,wj->bcij", r, mw)
                x = q(bn(x + r, f"blocks/{bi}/res_bn"))
        h = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC row-major flatten
        n_dense = len(cfg["dense_units"]) + 1
        for di in range(n_dense):
            kern = v[f"dense/{di}/kernel"]
            if di == n_dense - 1:
                bias = v[f"dense/{di}/bias"]
                if calib is not None:  # each logit: mean LOGIT_MEAN, std 1 over the batch
                    z = h @ kern
                    mean, std = z.mean(0), z.std(0).clamp(min=1e-6)
                    kern = calib[f"dense/{di}/kernel"] = kern / std
                    bias = calib[f"dense/{di}/bias"] = LOGIT_MEAN - mean / std
                h = h @ kern + bias
            else:
                h = h @ kern
            h = relu6(h)
            if di < n_dense - 1:
                h = bn(h, f"dense/{di}/bn")
    return h


@torch.no_grad()
def probs(v: dict, x_bgr_uint8: torch.Tensor, cfg: dict, prec: str = "f32", rows: int = 256) -> np.ndarray:
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
    """A copy of `v` whose dense head is calibrated on `x_bgr_uint8`: each
    BN of the head takes the mean and variance of its input over the batch
    as its moving statistics (each after the earlier ones are set), and the
    last dense kernel and bias are scaled and shifted so that each logit
    has mean LOGIT_MEAN and standard deviation 1 over the batch. The conv
    blocks keep their BN as given."""
    calib: dict = {}
    forward(v, x_bgr_uint8, cfg, "f32", calib=calib)
    return {**v, **calib}
