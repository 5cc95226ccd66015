"""Seeded weights, made on the device by the benchmark (not by the program).

He-normal conv kernels (fan out, torchvision's kaiming_normal_ for ResNet),
drawn in one call for all kernels and scaled per kernel; BN scale 1 and
bias 0, except the scale of each residual branch's last BN (bn3),
BRANCH_SCALE; an FC kernel of standard deviation 1 / sqrt(fan in) and bias
0. Then the reference calibrates them on the cell's first `calib_images`
images in float32 (`reference.calibrate`): every BN takes its input's mean
and variance over them as its running statistics, as a trained model's
would, so each BN's output has zero mean and unit variance there (bn3's
BRANCH_SCALE); and the FC is scaled so that the median top-1 probability
over them is 0.5. Identity statistics would let the residual stream grow
block by block, and a 1000-way softmax of unscaled random weights is near
uniform, so that a gap in probabilities would judge nothing.

BRANCH_SCALE: with unit-variance branches the random network is chaotic
in bf16: its rounding flipped the argmax of 6-28% of 2,048 images and
moved a probability by 0.29-0.76, as far as float8 moves it, so that no
limit told bf16 from a fault (H100, 3 seeds). Each branch at 0.3 of the
stream's scale, as training recipes start the last BN of a branch small
(Goyal et al. 2017 start it at 0; not 0 here, so that every conv of a
branch still shows in the answers), brought bf16's flips to 1-3% and its
gap to 0.05-0.10, float8's staying at 0.60-0.84.

`nest` gives the same variables in the program's nested form
(roomnet_tpu_torch/models/resnet.py's tree).
"""

from __future__ import annotations

import math

import torch

from benchmark.lib import images

from . import reference as ref

BRANCH_SCALE = 0.3  # the scale of each residual branch's last BN


def he(cfg: dict, seed: int, device) -> dict:
    """{path: float32 tensor} on `device` of every parameter and statistic:
    He-normal conv kernels, identity BN (bn3's scale BRANCH_SCALE), the FC
    drawn at 1 / sqrt(fan in), zero bias."""
    shapes = {**ref.param_paths(cfg), **ref.stat_paths(cfg)}
    kernels = [p for p, s in shapes.items() if len(s) >= 2]
    sizes = [math.prod(shapes[p]) for p in kernels]
    g = images.torch_generator(seed, 3, device)
    draw = torch.randn(sum(sizes), generator=g, device=device)
    v = {}
    for p, part in zip(kernels, draw.split(sizes)):
        s = shapes[p]
        std = 1.0 / math.sqrt(s[0]) if len(s) == 2 else math.sqrt(2.0 / (s[0] * s[1] * s[3]))
        v[p] = (part * std).view(s)
    for p, s in shapes.items():
        if p not in v:
            fill = {"scale": 1.0, "var": 1.0}.get(p.rsplit("/", 1)[1], 0.0)
            v[p] = torch.full(s, BRANCH_SCALE if p.endswith("/bn3/scale") else fill, device=device)
    return v


def make(cfg: dict, seed: int, calib_x, device) -> dict:
    """The cell's weights: `he`, then calibrated on the uint8 BGR batch
    `calib_x` by the reference in float32, TF32 off."""
    return ref.calibrate(he(cfg, seed, device), torch.as_tensor(calib_x).to(device), cfg)


def nest(flat: dict, cfg: dict) -> dict:
    """The program's nested variables: {"stem": {"conv", "bn"}, "stages":
    [[{"conv1", "bn1", "conv2", "bn2", "conv3", "bn3", "proj"}]], "fc":
    {"kernel", "bias"}}, BN = {"scale", "bias", "mean", "var"}."""

    def bn(prefix):
        return {f: flat[f"{prefix}/{f}"] for f in ("scale", "bias", "mean", "var")}

    stages = [[] for _ in cfg["mid_widths"]]
    for si, bi, _, _, _ in ref.blocks(cfg):
        p = f"layer{si + 1}/{bi}"
        proj = {"conv": flat[f"{p}/proj/conv"], "bn": bn(f"{p}/proj/bn")} if bi == 0 else None
        stages[si].append({"conv1": flat[f"{p}/conv1"], "bn1": bn(f"{p}/bn1"),
                           "conv2": flat[f"{p}/conv2"], "bn2": bn(f"{p}/bn2"),
                           "conv3": flat[f"{p}/conv3"], "bn3": bn(f"{p}/bn3"), "proj": proj})
    return {"stem": {"conv": flat["stem/conv"], "bn": bn("stem/bn")}, "stages": stages,
            "fc": {"kernel": flat["fc/kernel"], "bias": flat["fc/bias"]}}
