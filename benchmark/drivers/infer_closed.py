"""Batched inference under a closed loop of one caller.

The caller holds a pool of decoded images on the host (uint8 BGR at the
model's side, `images.pool`) and calls the classifier's `predict` on the
whole pool again and again; the classifier stages it through its pinned
ring, copies it to the device, runs the forward in batches of
`batch_size` and brings the class ids and probabilities back to host
memory. Each call's answers are kept. The model is the cell's
architecture's (`ctx.arch`).

Traffic parameters: batch_size, images_per_call (the pool), bases, noise,
calib_images (the images the weights are calibrated on).

End to end: infer_img_per_s, the images whose answers reached host memory
over the whole window. `correct`: every answer of every call in the
window against the reference's probabilities of the same image
(`max_prob_gap`).
"""

from __future__ import annotations

import types

import numpy as np
import torch

from benchmark.lib import compare, images, window
from benchmark.lib.harness import Outcome

# The traffic the benchmark's own tests run this driver at, over the
# workload file's: roomnet-tiny on the CPU, and the cell's own
# configuration on the card at a size a test run holds. The CPU's
# configuration is the architecture's `reference.TINY`.
TEST_TRAFFIC = {"cpu": {"images_per_call": 48, "batch_size": 16, "calib_images": 32},
                "cuda": {"images_per_call": 256}}


def traffic(ctx):
    t = ctx.traffic
    return images.pool(ctx.seed, t["images_per_call"], ctx.cfg["im_side"], t["bases"], t["noise"], ctx.device)


def make_weights(ctx, pool):
    return ctx.arch.weights.make(ctx.cfg, ctx.seed, pool[: ctx.traffic["calib_images"]], ctx.device)


def run(ctx) -> Outcome:
    t, cfg, dev, arch = ctx.traffic, ctx.cfg, ctx.device, ctx.arch
    if t["images_per_call"] % t["batch_size"]:
        raise ValueError("images_per_call is not a whole number of batches: the work counts are per batch")
    with ctx.part("traffic"):
        pool, _ = traffic(ctx)
    with ctx.part("weights"):
        v = make_weights(ctx, pool)
    with ctx.part("program"):
        clf = arch.program.classifier(arch.weights.nest({k: x.clone() for k, x in v.items()}, cfg), cfg,
                                      t["batch_size"], dev)
    with ctx.part("first_call"):  # the kernels' build or load, and the first forward
        clf.predict(pool)
    with ctx.part("warmup"):
        clf.predict(pool)
    w = window.closed_loop(ctx, lambda: clf.predict(pool)[1])
    answers, window_s = w.answers, w.window_s
    calls, n = len(answers), len(pool)
    batches = calls * -(-n // t["batch_size"])
    ctx.log(f"window: {calls} calls of {n} images in {window_s:.3f} s")
    clf.close()
    del clf
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = arch.reference.probs(v, pool, cfg, "f32")
    gaps = [compare.prob_gap(a, want) for a in answers]
    numbers = {"max_prob_gap": max(gaps), "mean_prob_gap": float(np.mean([np.abs(a - want).mean() for a in answers]))}
    failed = sum(int((~np.isfinite(a).all(axis=1)).sum()) for a in answers)
    readings = types.SimpleNamespace(
        cfg=cfg, arch=arch, batch=t["batch_size"], window_s=window_s, images=calls * n, forwards=batches,
        spans=w.spans, trace=w.trace, numbers=numbers)
    return Outcome(e2e={"infer_img_per_s": calls * n / window_s}, readings=readings,
                   attempted=calls * n, failed=failed,
                   checks=[(name, numbers[name], limit) for name, limit in ctx.limits.items()],
                   memory_peak_bytes=w.peak)


def control(ctx, prec: str) -> dict:
    """The control's reading on this seed: the reference at `prec` in the
    program's place, against the reference in float32."""
    pool, _ = traffic(ctx)
    v = make_weights(ctx, pool)
    ref = ctx.arch.reference
    got, want = ref.probs(v, pool, ctx.cfg, prec), ref.probs(v, pool, ctx.cfg, "f32")
    return {"max_prob_gap": compare.prob_gap(got, want), "mean_prob_gap": float(np.abs(got - want).mean())}
