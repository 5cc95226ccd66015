"""Batched inference under a closed loop of one caller.

The caller holds a pool of decoded images on the host (uint8 BGR at the
model's side, `images.pool`) and calls `RoomNetClassifier.predict` on the
whole pool again and again; the classifier stages it through its pinned
ring, copies it to the device, runs the forward in batches of
`batch_size` and brings the class ids and probabilities back to host
memory. Each call's answers are kept.

Traffic parameters: batch_size, images_per_call (the pool), bases, noise,
calib_images (the images the weights are calibrated on).

End to end: infer_img_per_s, the images whose answers reached host memory
over the whole window. `correct`: every answer of every call in the
window against the reference's probabilities of the same image
(`max_prob_gap`).
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from benchmark.lib import images, program, weights
from benchmark.lib.harness import Outcome
from benchmark.lib.trace import Capture
from benchmark.reference import compare
from benchmark.reference import model as ref

# The traffic the benchmark's own tests run this driver at, over the
# workload file's: roomnet-tiny on the CPU, and the cell's own
# configuration on the card at a size a test run holds.
TEST_TRAFFIC = {"cpu": {"images_per_call": 48, "batch_size": 16, "calib_images": 32},
                "cuda": {"images_per_call": 256}}


def traffic(ctx):
    t = ctx.traffic
    return images.pool(ctx.seed, t["images_per_call"], ctx.cfg["im_side"], t["bases"], t["noise"], ctx.device)


def make_weights(ctx, pool):
    return weights.make(ctx.cfg, ctx.seed, pool[: ctx.traffic["calib_images"]], ctx.device)


def run(ctx) -> Outcome:
    t, cfg, dev = ctx.traffic, ctx.cfg, ctx.device
    if t["images_per_call"] % t["batch_size"]:
        raise ValueError("images_per_call is not a whole number of batches: the work counts are per batch")
    with ctx.part("traffic"):
        pool, _ = traffic(ctx)
    with ctx.part("weights"):
        v = make_weights(ctx, pool)
    with ctx.part("program"):
        clf = program.classifier(weights.nest({k: x.clone() for k, x in v.items()}, cfg), cfg,
                                 t["batch_size"], dev)
    with ctx.part("first_call"):  # the kernels' build or load, and the first forward
        clf.predict(pool)
    with ctx.part("warmup"):
        clf.predict(pool)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    spans0 = program.spans()
    answers = []
    with Capture(ctx.trace) as cap:
        start = ctx.window()
        while True:
            _, probs = clf.predict(pool)
            answers.append(probs)
            if time.monotonic() - start >= ctx.seconds:
                break
        end = time.monotonic()
    spans1 = program.spans()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    calls, n = len(answers), len(pool)
    window_s = end - start
    batches = calls * -(-n // t["batch_size"])
    ctx.log(f"window: {calls} calls of {n} images in {window_s:.3f} s")
    clf.close()
    del clf
    if cuda:
        torch.cuda.empty_cache()
    want = ref.probs(v, pool, cfg, "f32")
    gaps = [compare.prob_gap(a, want) for a in answers]
    numbers = {"max_prob_gap": max(gaps), "mean_prob_gap": float(np.mean([np.abs(a - want).mean() for a in answers]))}
    failed = sum(int((~np.isfinite(a).all(axis=1)).sum()) for a in answers)
    readings = types.SimpleNamespace(
        cfg=cfg, batch=t["batch_size"], window_s=window_s, images=calls * n, forwards=batches,
        spans=(spans0, spans1), trace=cap.trace, numbers=numbers)
    return Outcome(e2e={"infer_img_per_s": calls * n / window_s}, readings=readings,
                   attempted=calls * n, failed=failed,
                   checks=[(name, numbers[name], limit) for name, limit in ctx.limits.items()],
                   memory_peak_bytes=peak)


def control(ctx, prec: str) -> dict:
    """The control's reading on this seed: the reference at `prec` in the
    program's place, against the reference in float32."""
    pool, _ = traffic(ctx)
    v = make_weights(ctx, pool)
    got, want = ref.probs(v, pool, ctx.cfg, prec), ref.probs(v, pool, ctx.cfg, "f32")
    return {"max_prob_gap": compare.prob_gap(got, want), "mean_prob_gap": float(np.abs(got - want).mean())}
