"""Directory classification under a closed loop of one caller.

Set-up writes `files` JPEGs (`height` x `width`, baseline quality
`quality`) into a directory of the run's own under TMPDIR: each a
`make_image` base varied on the device and encoded by cv2 on a thread pool
(`images.jpeg_files`). The caller then calls the classifier's
`predict_paths` over all of them again and again; the classifier decodes
each batch's files on its decode workers into its pinned ring (the centred
crop and the resize to the model's side on the host), copies the batch to
the device, runs the forward in batches of `batch_size` and brings each
file's class id and probabilities back to host memory. The files were just
written, so the page cache holds them: the cell measures decoding, not the
disk. The model is the cell's architecture's (`ctx.arch`).

Traffic parameters: files, height, width, quality, bases, noise,
batch_size, calib_images (the first files, as the reference reads them, on
which the weights are calibrated).

End to end: infer_img_per_s, the files whose answers reached host memory
over the whole window. `correct`: every file of every call in the window
comes back read (`failed_files`), and its answer is held against the
reference's probabilities of the same file as the reference reads it
(`arch.reference.read_image`, then the float32 forward), the worst file
counted: `max_conf_gap`, |conf - p_ref[id]|, and `max_choice_gap`,
max(p_ref) - p_ref[id]. Logged beside them, with no limit:
`decode_max_diff`, the largest difference between the program's pixels of
the first batch and the reference's.
"""

from __future__ import annotations

import os
import tempfile
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark.lib import images, window
from benchmark.lib.harness import Outcome

# The traffic the benchmark's own tests run this driver at, over the
# workload file's: the architecture's `reference.TINY` on the CPU with small
# files and a ragged last batch, and the cell's own configuration on the
# card at a size a test run holds.
TEST_TRAFFIC = {"cpu": {"files": 21, "batch_size": 8, "height": 48, "width": 64, "bases": 4,
                        "calib_images": 16},
                "cuda": {"files": 256}}


def _threads() -> int:
    return min(8, os.cpu_count() or 1)


def traffic(ctx, directory: str) -> list[str]:
    t = ctx.traffic
    return images.jpeg_files(ctx.seed, t["files"], t["height"], t["width"], t["bases"], t["noise"],
                             t["quality"], directory, ctx.device)


def reference_images(ctx, paths: list[str]) -> np.ndarray:
    """The files as the reference reads them: (n, S, S, 3) uint8 BGR."""
    side, read = ctx.cfg["im_side"], ctx.arch.reference.read_image
    with ThreadPoolExecutor(max_workers=_threads()) as ex:
        return np.stack(list(ex.map(lambda p: read(p, side), paths)))


def make_weights(ctx, paths: list[str]) -> dict:
    calib = reference_images(ctx, paths[: ctx.traffic["calib_images"]])
    return ctx.arch.weights.make(ctx.cfg, ctx.seed, calib, ctx.device)


def gaps(ids: np.ndarray, confs: np.ndarray, ok: np.ndarray, want: np.ndarray) -> dict:
    """One call's numbers against the reference's probabilities `want`."""
    rows = np.flatnonzero(ok)
    chosen = want[rows, ids[rows]]
    return {"failed_files": int((~ok).sum()),
            "max_conf_gap": float(np.max(np.abs(confs[rows, ids[rows]] - chosen), initial=0.0)),
            "max_choice_gap": float(np.max(want[rows].max(axis=1) - chosen, initial=0.0))}


def worst(per_call: list[dict]) -> dict:
    return {"failed_files": sum(c["failed_files"] for c in per_call),
            **{k: max(c[k] for c in per_call) for k in ("max_conf_gap", "max_choice_gap")}}


def run(ctx) -> Outcome:
    t, cfg, dev, arch = ctx.traffic, ctx.cfg, ctx.device, ctx.arch
    bs = t["batch_size"]
    with tempfile.TemporaryDirectory(prefix="bench-jpeg-") as directory:
        with ctx.part("traffic"):
            paths = traffic(ctx, directory)
        with ctx.part("weights"):
            v = make_weights(ctx, paths)
        with ctx.part("program"):
            clf = arch.program.classifier(arch.weights.nest({k: x.clone() for k, x in v.items()}, cfg), cfg,
                                          bs, dev)
        with ctx.part("first_call"):  # the kernels' build or load, the decoder's, and the first forward
            clf.predict_paths(paths)
        with ctx.part("warmup"):
            clf.predict_paths(paths)
        w = window.closed_loop(ctx, lambda: clf.predict_paths(paths))
        answers, window_s = w.answers, w.window_s
        calls, n = len(answers), len(paths)
        ctx.log(f"window: {calls} calls of {n} files in {window_s:.3f} s")
        first = np.empty((min(bs, n), cfg["im_side"], cfg["im_side"], 3), np.uint8)
        with ThreadPoolExecutor(max_workers=_threads()) as ex:  # the program's pixels of the first batch
            kept = np.asarray(clf.path_fill(paths, ex)(0, len(first), first), np.int64)
        clf.close()
        del clf
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        x_ref = reference_images(ctx, paths)
    want = arch.reference.probs(v, x_ref, cfg, "f32")
    numbers = worst([gaps(*a, want) for a in answers])
    numbers["decode_max_diff"] = int(np.abs(first[: kept.size].astype(np.int16) - x_ref[kept]).max(initial=0))
    ctx.log(f"decode_max_diff (program's pixels of the first batch against the reference's): "
            f"{numbers['decode_max_diff']}")
    done = calls * n - numbers["failed_files"]
    readings = types.SimpleNamespace(
        cfg=cfg, arch=arch, batch=bs, window_s=window_s, images=done, forwards=calls * -(-n // bs),
        spans=w.spans, trace=w.trace, numbers=numbers)
    return Outcome(e2e={"infer_img_per_s": done / window_s}, readings=readings,
                   attempted=calls * n, failed=numbers["failed_files"],
                   checks=[(name, numbers[name], limit) for name, limit in ctx.limits.items()],
                   memory_peak_bytes=w.peak)


def control(ctx, prec: str) -> dict:
    """The control's reading on this seed: the reference at `prec` in the
    program's place, on the files as the reference reads them, against
    the reference in float32."""
    with tempfile.TemporaryDirectory(prefix="bench-jpeg-") as directory:
        paths = traffic(ctx, directory)
        v = make_weights(ctx, paths)
        x = reference_images(ctx, paths)
    ref = ctx.arch.reference
    got, want = ref.probs(v, x, ctx.cfg, prec), ref.probs(v, x, ctx.cfg, "f32")
    ok = np.isfinite(got).all(axis=1)
    return gaps(got.argmax(axis=1), got, ok, want)
