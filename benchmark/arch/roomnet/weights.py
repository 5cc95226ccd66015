"""Seeded weights, made on the device by the benchmark (not by the program).

Glorot-uniform kernels (the tf.layers default of the reference,
network.py:184, 212; JAX's fans: receptive field times the second-to-last
and the last axis), drawn in one call for all kernels and scaled per
kernel; BN scale 1 and bias 0, the last dense bias 0. With identity moving
statistics the activations shrink block by block and the ReLU6-clipped
logits sit near 0 (about 0.01, four of six clipped), so the probabilities
are flat and a comparison of them sees little. So the reference calibrates
the dense head on a seeded batch (`reference.calibrate`): each of its
BNs takes its input's mean and variance, as a trained model's would, and
the last layer is scaled so that each logit sits inside ReLU6's (0, 6).
Calibrating the conv blocks' BNs too made the forward chaotic: rounding's
relative error grew from 0.17% at the input to 2.3% at the last conv.

`nest` gives the same variables in the program's nested form (the layout
its parameter files unflatten to).
"""

from __future__ import annotations

import math

import torch

from benchmark.lib import images

from . import reference as ref


def glorot(cfg: dict, seed: int, device) -> dict:
    """{path: float32 tensor} on `device`: Glorot-uniform kernels, identity
    BN, zero bias."""
    shapes = ref.param_paths(cfg)
    kernels = [p for p, s in shapes.items() if len(s) >= 2]
    sizes = [math.prod(shapes[p]) for p in kernels]
    g = images.torch_generator(seed, 3, device)
    draw = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    v = {}
    for p, part in zip(kernels, draw.split(sizes)):
        s = shapes[p]
        limit = math.sqrt(6.0 / (math.prod(s[:-2]) * (s[-2] + s[-1])))
        v[p] = (part * limit).view(s)
    for p, s in shapes.items():
        if p in v:
            continue
        fill = {"scale": 1.0, "var": 1.0}.get(p.rsplit("/", 1)[1], 0.0)
        v[p] = torch.full(s, fill, device=device)
    return {p: v[p] for p in shapes}


def make(cfg: dict, seed: int, calib_x, device) -> dict:
    """The cell's weights: `glorot`, then the dense head calibrated on the
    uint8 BGR batch `calib_x` (the reference in float32, TF32 off)."""
    v = glorot(cfg, seed, device)
    return ref.calibrate(v, torch.as_tensor(calib_x).to(device), cfg)


def nest(flat: dict, cfg: dict) -> dict:
    """The program's nested variables: {"blocks": [{"conv", "bn", "res_bn"}],
    "dense": [{"kernel", "bias", "bn"}]}, BN = {"scale", "bias", "mean", "var"}."""

    def bn(prefix):
        return {f: flat[f"{prefix}/{f}"] for f in ("scale", "bias", "mean", "var")}

    blocks = [{"conv": [flat[f"blocks/{bi}/conv/{d}"] for d in range(depth)],
               "bn": [bn(f"blocks/{bi}/bn/{d}") for d in range(depth)],
               "res_bn": bn(f"blocks/{bi}/res_bn") if depth > 1 else None}
              for bi, depth in enumerate(cfg["block_depths"])]
    n_dense = len(cfg["dense_units"]) + 1
    dense = [{"kernel": flat[f"dense/{di}/kernel"],
              "bias": flat.get(f"dense/{di}/bias"),
              "bn": bn(f"dense/{di}/bn") if di < n_dense - 1 else None}
             for di in range(n_dense)]
    return {"blocks": blocks, "dense": dense}
