#!/usr/bin/env python3
"""Smoke run of the PyTorch port (roomnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's RoomNet serving forward at 224² on the converted
reference checkpoint (artifacts/roomnet_params.npz) through its four CUDA
kernels, in phases; any failure raises and the script exits non-zero:

  1. The card's name and power limit; build the kernels from csrc/ (one
     nvcc per source, in parallel) and print the build time and ptxas usage.
  2. Each kernel against its plain PyTorch version on the operands of every
     launch of one forward at batch 8 (real activations of the golden batch),
     f32 and bf16. f32: rtol = atol = 1e-5, conv 1e-4 (sum order). bf16:
     outputs within one bf16 ulp (rtol 2^-7) after identical f32 math in
     another order; the residual also within one ulp of its bf16-rounded
     intermediate (atol 2^-7 * max|s| * max|res|).
  3. Each kernel at batch 256, f32 and bf16, on the operands of every launch
     of one forward: held against its plain version at phase 2's
     tolerances (the largest grids: the bf16 conv's persistent blocks walk
     several tiles each only here), then its time summed over its launches,
     beside its plain version, a PyTorch library call where one computes
     the same function (F.conv2d; F.avg_pool2d + the BN affine), and its
     bound. Kernel, plain and library are timed in turns (kernel, plain,
     library, kernel, plain, library, kernel), each window at least
     WINDOW_MS of device time and 5 calls; each time is the median of its
     windows. Kernel and library windows replay a CUDA graph of their calls,
     so they time the card and not the host's launch rate; the plain
     version runs eagerly (the residual's copies host arrays, which a graph
     cannot hold). Each site prints its launch plan: the conv's variant
     (tile, shared memory), the residual's strip, span, shared memory and
     blocks, the head's variant (resident or streamed, rows per block)
     beside an empty kernel's graph-replayed time.
     The bound is max(bytes / 3.35 TB/s, FLOPs / peak), peak 67 TFLOP/s for
     f32 arithmetic and 989 TFLOP/s for bf16 convolutions (H100 SXM). Bytes
     count each input element the function reads once (for the pool and the
     residual, only the rows and columns its windows or weights reach) and
     each output once.
  4. The full forward against the TF-graph goldens (forward_golden.npz, 7
     images, and forward_golden_wide.npz, 64): f32 logits within 1e-4 and
     argmax exact (float and uint8-fold input); bf16 argmax exact and
     |dlogit| within BF16_DLOGIT; launch counts 10/10/3/1 per forward.
  5. The serving path: RoomNetClassifier.predict at batch 256 (throughput)
     and requests of batch 1, 3 and 8 (latency), bf16 and f32, with the
     launch counters zeroed before and read after each dtype's run.
  6. The directory path, the main path of a user: a directory of PNG files
     written here (standard library zlib only) from the 64 wide-golden
     images, each centred in a 224x300 or 300x224 canvas with random
     margins, 8 noisy 2x images in 448x600 canvases, a name with spaces, an
     extensionless copy and a corrupt file. classify_im_dir and
     groundtruth_validation at batch 16, f32 and bf16, counters zeroed just
     before and read just after: argmax equal to the TF graph's, f32 probs
     within 1e-5 of phase 4's softmax, the corrupt file skipped, the .xls
     and .csv one row per readable file, 10/10/3/1 launches per forward;
     decoded crops equal to the golden pixels and 2x images within one gray
     level of resize_bilinear_half_pixel on the same crop. Then stage times,
     nothing claimed: predict_paths on 1,024 files at batch 256 in bf16
     (decode on the host clock, H2D and forward by CUDA events), and
     predict from numpy at batch 256 through the pinned ring beside the
     pageable one-stream copy it replaced, and batch-1 requests both ways,
     timed in turns. A host without any image decoder prints "decode
     backend: none on this host" and feeds the same arrays through
     predict_stream's decode seam instead.

  7. The training step (train/step.py), through the four kernels under
     autograd: (a) at 224 in f32 on the 7-image grad_golden.npz batch, in
     both BN modes, the CE and the full loss within 3e-4 of the TF oracle
     and the CE gradient of every trainable tensor within the JAX package's
     gates (GRAD_GATES_224); (b) traj_golden.npz's 6 TF1-Adam steps at the
     tiny geometry, sequential and multi-step, both modes, losses within
     5e-4 and params within 1e-4; (c) each autograd Function against
     autograd through its plain version on the operands of every site of a
     batch-8 training step, f32 and bf16: the forward at phase 2's
     tolerances, every input's gradient within GRAD_RTOL; (d) the launches
     of one step, counters zeroed just before and read just after:
     10/10/3/1 with TrainHParams(), 10/10/3/0 with batch statistics; (e)
     times, nothing claimed: TrainHParams() steps in bf16 at batch 45 and
     128 and in f32 at batch 45, ms per step and img/s (median of 3 chains
     of 20, CUDA events), each split into forward, backward and optimizer,
     and peak memory after steps 5 and 20 of a fresh state (equal within
     1%).

  8. The serving daemon (infer/server.py), the main path of a request:
     (a) for f32 and bf16, `ClassifierServer(RoomNetClassifier(variables,
     cfg, batch_size=32), warmup=True, max_inflight=64)` over a model dir
     whose step-1 checkpoint is the converted weights saved by the port's
     CheckpointStore (/reload loads it): /healthz, /readyz, /labels; the
     64 wide-golden crops as PNG bodies through /classify (class_id equal
     to the TF argmax, f32 probs within 1e-5 of phase 4's softmax), all 64
     through /classify_batch (two device calls) and ?stream=1 (64 NDJSON
     lines), the same answers; launches, counters zeroed just before those
     requests and read just after, 10/10/3/1 per serve/device_call of
     /metrics; `_predict` at every bucket (1-32) against the rows of the
     batch-256 forward; /reload of the rolled head (step 2: every class_id
     moves to TF argmax + 1 mod 6) and of a NaN tree (step 3: 409 from the
     probe, step 2 kept, answers unchanged); evaluate_checkpoints over steps
     1 and 2 against a list of the 64 PNGs labelled with the TF argmax
     (accuracy 1.0 and 0.0, best step 1); once, `python -m roomnet_tpu_torch
     validate` on that list (accuracy 1.0). (b) Times, bf16, nothing
     claimed, bench.py's serving setup (batch_size=8, max_inflight=64,
     warmup, one 640x480 q88 JPEG of tools/make_synth_dataset.make_image):
     sequential /classify p50 and p99 on one keep-alive connection and with a
     connection per request, in turns; repeated 64-way bursts (req/s, device
     calls, rows per device call over bucket rows, shipped MB); serve/
     device_call and serve/fetch p50 from /metrics; decode ms per request;
     the device's busy share over a burst (torch.profiler device time over
     the window's wall time); batch-1 `predict` p50 with predict_stream's
     e2e spans and with them off, in turns.

  9. The training loop (train/loop.py), the main path of a user who trains
     on their own photos: (a) tools/make_synth_dataset.generate writes 600
     JPEGs of 250x330 (100 a class), extract_fpaths splits them 540 / 60;
     (b) f32, batch 45, inference BN, no dropout, save_freq 5, from the
     converted weights saved at step 0 by the port's CheckpointStore:
     `Trainer.train(total_steps=6)` against six hand-driven calls of
     make_train_step on the same restored state and the batches of a fresh
     TrainFeeder, both with cuDNN's deterministic algorithms (params, BN
     stats and Adam state within rtol = atol = LOOP_TOL, losses within
     LOOP_TOL), one stats entry at step 5 in the
     reference schema, its acc-named checkpoint, and launches 70/70/21/7
     over the run (6 step forwards, 1 validation forward); (c) bf16, batch
     45, frozen BN, no dropout, a fresh head on the converted tower
     (restore_head=False), LOOP_LR: 301 steps with save_freq 100 give three
     validations and acc-named checkpoints (steps 100, 200, 300), the
     step-300 accuracy at least LOOP_ACC_GATE (chance 1/6), then a new
     Trainer resumes step 300 and ends at 310; (d) `python -m
     roomnet_tpu_torch train --steps 21 --save-freq 10` as a subprocess from
     a directory of its own: exit 0, checkpoints and stats at steps 10 and
     20; (e) times from (c), nothing claimed: Trainer img/s between
     validations (host clock) beside phase 7's bare step, the train feeder's
     dequeue wait p50 and p99, H2D of a batch-45 (CUDA events), the
     device's busy share over steps 50-69 (torch.profiler), and the two
     orders of the loss read (`read_orders`: the step's own loss read once
     the next batch is staged, or the previous step's, timed in turns on one
     feeder with a full queue). The kernels line's trainer_launches are (b)'s
     counts for f32 and (c)'s for bf16.

Then the JSON line of serving, directory, training, server and trainer
numbers, the script's wall time, one JSON line of per-kernel results and,
last, the device line.
f32 parity needs TF32 off; the script turns it off for everything it runs.
"""

from __future__ import annotations

import contextlib
import csv
import ctypes
import json
import math
import os
import pathlib
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12
WINDOW_MS = 20.0  # device time of one timed window
PEAK_F32 = 67e12
PEAK_BF16_TENSOR = 989e12
GOLDEN = pathlib.Path(__file__).resolve().parent / "tests" / "golden"
# bf16 |dlogit| against the TF graph. The card has no JAX, so the JAX
# package's own bf16 distance on each golden batch is pinned here;
# tests/test_torch_forward.py checks on the CPU that the pin is what the JAX
# forward gives and that the port's plain forward stays within it plus
# BF16_MARGIN. The limit is that sum, and never below the 0.15 that
# tests/test_forward_golden.py holds the JAX package to.
JAX_BF16_DLOGIT = {"forward_golden": 0.111933, "forward_golden_wide": 0.225824}
BF16_MARGIN = 0.01
BF16_DLOGIT = {k: max(0.15, v + BF16_MARGIN) for k, v in JAX_BF16_DLOGIT.items()}


def log(msg: str) -> None:
    print(msg, flush=True)


def window_ms(run, calls: int) -> float:
    """Device ms per call over one window in which run() makes `calls` calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def repeat(fn, n: int):
    def run():
        for _ in range(n):
            fn()
    return run


def reps_for(fn) -> int:
    """Calls per timed window: enough for WINDOW_MS of device time, at least 5."""
    fn()
    torch.cuda.synchronize()
    once = window_ms(fn, 1)
    return max(5, math.ceil(WINDOW_MS / max(once, 1e-3)))


def eager_window(fn) -> tuple:
    """(run, calls) of one window of back-to-back eager calls."""
    reps = reps_for(fn)
    return repeat(fn, reps), reps


def graph_window(fn) -> tuple:
    """(run, calls) of one window that replays a CUDA graph of fn's calls:
    the device work of an eager window, replayed as often as WINDOW_MS of
    device time takes, with no host work between the launches."""
    reps = reps_for(fn)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    replays = max(1, math.ceil(WINDOW_MS / max(window_ms(g.replay, 1), 1e-3)))
    return repeat(g.replay, replays), reps * replays


def cuda_ms(fn) -> float:
    """Device ms per call, one calibrated eager window after a warm-up."""
    return window_ms(*eager_window(fn))


def in_turns(fns: dict, eager: tuple = ()) -> dict:
    """Device ms per call of each function, timed in turns on one card: the
    first (the kernel) in three windows around two of each other, as in
    kernel, plain, library, kernel, plain, library, kernel. Each time is the
    median of its windows. Windows replay a CUDA graph, except for the
    functions named in `eager`."""
    windows = {name: (eager_window if name in eager else graph_window)(fn) for name, fn in fns.items()}
    first, others = list(fns)[0], list(fns)[1:]
    got = {name: [] for name in fns}
    for turn in range(3):
        got[first].append(window_ms(*windows[first]))
        if turn < 2:
            for name in others:
                got[name].append(window_ms(*windows[name]))
    return {name: statistics.median(v) for name, v in got.items()}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def compare(name, dt, args, got, want, where: str) -> float:
    """Max |d| of one launch's output against its plain version's; raises
    where they disagree beyond the tolerances of the docstring's phase 2."""
    pairs = list(zip(got, want)) if name == "dense_head" else [(got, want)]
    err = 0.0
    for a, b in pairs:
        a, b = a.detach().float(), b.detach().float()
        if dt == "f32" or name == "dense_head":
            tol = 1e-4 if name == "conv3x3" else 1e-5
            rtol, atol = tol, tol
        else:
            rtol, atol = 2.0 ** -7, 1e-3
            if name == "residual_bn":
                atol = 2.0 ** -7 * args[2].abs().max().item() * args[1].float().abs().max().item()
        d = (a - b).abs()
        bad = d > atol + rtol * b.abs()
        if bad.any() or not torch.isfinite(a).all():
            raise AssertionError(
                f"{name}[{dt}] {where}: kernel disagrees with plain at {int(bad.sum())} "
                f"of {b.numel()} values, max |d| {d.max().item():.3g}")
        err = max(err, d.max().item())
        del a, b, d, bad
    return err


def png_bytes(bgr: np.ndarray) -> bytes:
    """A PNG file (8-bit RGB, filter 0 on every row) of an (H, W, 3) uint8
    BGR image, written with the standard library's zlib alone."""
    h, w, _ = bgr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), bgr[..., ::-1].reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def canvas(rng: np.random.RandomState, im: np.ndarray, tall: bool) -> np.ndarray:
    """`im` (S, S, 3) in the middle of a canvas of random pixels, S x 1.34 S
    (wide) or 1.34 S x S (tall), so that the centre crop gives `im` back."""
    s = im.shape[0]
    long = s * 75 // 56  # 224 -> 300, 448 -> 600
    out = rng.randint(0, 256, size=(long, s, 3) if tall else (s, long, 3), dtype=np.uint8)
    off = (long - s) // 2
    if tall:
        out[off: off + s] = im
    else:
        out[:, off: off + s] = im
    return out


def write_image_dir(d: str, images: np.ndarray, seed: int) -> dict:
    """Phase 6's directory, from (N, S, S, 3) uint8 BGR images:
    crop_<i>.png (image i in a canvas), double_<j>.png (a 2x noisy copy of
    image j in a 2x canvas, j < 8), "photo with spaces.png" (crop_00's
    bytes), noext_photo (crop_01's) and corrupt.png. Returns {"golden":
    {name: i}, "crops": {name: the centre crop each readable file holds},
    "bytes": {name: file bytes}, "corrupt": name}."""
    os.makedirs(d)
    rng = np.random.RandomState(seed)
    golden, crops, files = {}, {}, {}
    for i, im in enumerate(images):
        name = f"crop_{i:02d}.png"
        files[name], golden[name], crops[name] = png_bytes(canvas(rng, im, i % 2 == 1)), i, im
    for j in range(8):
        big = np.repeat(np.repeat(images[j].astype(np.int16), 2, 0), 2, 1)
        big = np.clip(big + rng.randint(-12, 13, size=big.shape), 0, 255).astype(np.uint8)
        name = f"double_{j}.png"
        files[name], crops[name] = png_bytes(canvas(rng, big, j % 2 == 0)), big
    for name, src in (("photo with spaces.png", "crop_00.png"), ("noext_photo", "crop_01.png")):
        files[name], golden[name], crops[name] = files[src], golden[src], crops[src]
    files["corrupt.png"] = b"not an image"
    for name, data in files.items():
        pathlib.Path(d, name).write_bytes(data)
    return {"golden": golden, "crops": crops, "bytes": files, "corrupt": "corrupt.png"}


def decode_backend() -> str | None:
    """The decoder predict_paths uses on this host: "native", "cv2" or None."""
    from roomnet_tpu_torch.data import native

    if native.available():
        return "native"
    try:
        import cv2  # noqa: F401
    except ImportError:
        return None
    return "cv2"


def timed_fill(fill, spent: list):
    """`fill` that appends the host seconds of each call to `spent`."""
    def run(start, stop, out):
        t0 = time.perf_counter()
        kept = fill(start, stop, out)
        spent.append(time.perf_counter() - t0)
        return kept
    return run


def main() -> None:
    wall0 = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; the port's smoke run needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from roomnet_tpu_torch.infer.classify import RoomNetClassifier
    from roomnet_tpu_torch.models import roomnet as M
    from roomnet_tpu_torch.ops.kernels import _build
    from roomnet_tpu_torch.ops.kernels import conv3x3 as KC
    from roomnet_tpu_torch.ops.kernels import dense_head as KD
    from roomnet_tpu_torch.ops.kernels import pool as KP
    from roomnet_tpu_torch.ops.kernels import residual as KR
    from roomnet_tpu_torch.params.schema import load_npz

    kernels = {
        "conv3x3": (KC.conv3x3, KC.conv3x3_plain, "roomnet_tpu/ops/pallas/conv_b2.py:70"),
        "relu6_pool_bn": (KP.relu6_pool_bn, KP.relu6_pool_bn_plain, "roomnet_tpu/ops/pallas/pool.py:83"),
        "residual_bn": (KR.residual_bn, KR.residual_bn_plain, "roomnet_tpu/ops/pallas/residual.py:104"),
        "dense_head": (KD.dense_head, KD.dense_head_plain, "roomnet_tpu/ops/pallas/dense_head.py:53"),
    }
    per_forward = {"conv3x3": 10, "relu6_pool_bn": 10, "residual_bn": 3, "dense_head": 1}
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- phase 1: card, build -------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    t0 = time.perf_counter()
    _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(_build.SOURCES)} kernels "
        f"into {_build.BUILD_DIR}")
    for name in _build.SOURCES:
        logf = _build.BUILD_DIR / f"{name}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    variant_fn = _build.entry("conv3x3", "rn_conv3x3_variant", [ctypes.c_int] * 6 + [ctypes.c_void_p])

    def conv_variant(dt: str, args) -> str:
        """The conv kernel's variant for one launch (csrc/conv3x3.cu:rn_conv3x3_variant)."""
        x, k = args[0], args[1]
        packed = KC.packed_kernel(k, x.dtype)
        cp = packed.shape[1] if dt == "bf16" else packed.shape[-1]
        out = (ctypes.c_int * 5)()
        rc = variant_fn(x.shape[1], x.shape[2], x.shape[3], k.shape[3], cp, int(dt == "bf16"), out)
        _build.check("conv3x3", "rn_conv3x3_variant", rc)
        names = ("Cout_p", "rows/warp") if dt == "bf16" else ("NT", "warp cols")
        return (f"{names[0]} {out[0]}, {names[1]} {out[1]}, tile {out[2]}x{out[3]}, "
                f"smem {out[4]} B")

    def residual_plan(dt: str, args) -> str:
        """The residual's plan for one launch (ops/kernels/residual.py:plan)."""
        x, res = args[0], args[1]
        p = KR.plan_for(x, res)
        return (f"plan: strip {p.strip} rows, span {p.span} columns, vec {p.vec}, "
                f"res tile {p.rows_in}x{p.cols_in}, smem {p.smem} B, {p.threads} threads, "
                f"blocks {p.grid(x.shape[0])}")

    empty_fn = _build.entry("dense_head", "rn_empty_launch", [ctypes.c_int, ctypes.c_void_p])

    def empty_launch():
        _build.check("dense_head", "rn_empty_launch",
                     empty_fn(torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream))

    def head_plan(dt: str, args) -> str:
        """The head's variant for one launch (ops/kernels/dense_head.py:plan),
        beside an empty kernel's time replayed from a CUDA graph."""
        x, packed, widths = args
        p = KD.plan(widths, packed.numel())
        empty = in_turns({"empty": empty_launch})["empty"]
        return (f"variant {p.variant}, {p.rows} rows per block, smem {p.smem} B; "
                f"empty kernel {empty:.4f} ms")

    cfgs = {"f32": M.DEFAULT_CONFIG, "bf16": M.FAST_CONFIG}
    variables = load_npz(pathlib.Path(__file__).resolve().parent / "artifacts" / "roomnet_params.npz",
                         device=dev)
    folded = {d: M.fold_variables(variables, c) for d, c in cfgs.items()}
    g = dict(np.load(GOLDEN / "forward_golden.npz"))
    gw = dict(np.load(GOLDEN / "forward_golden_wide.npz"))

    def record(dt: str, x: torch.Tensor) -> list:
        """The (kernel, args, kwargs) of every launch of one forward."""
        sites = []
        saved = {n: getattr(M, n) for n in kernels}

        def recorder(name):
            def call(*args, **kwargs):
                sites.append((name, args, kwargs))
                return saved[name](*args, **kwargs)
            return call

        try:
            for n in kernels:
                setattr(M, n, recorder(n))
            with torch.no_grad():
                M.forward_folded(folded[dt], x, cfgs[dt])
        finally:
            for n, fn in saved.items():
                setattr(M, n, fn)
        return sites

    def normalized(x_uint8: np.ndarray) -> torch.Tensor:
        return M.normalize_bgr_uint8(torch.from_numpy(x_uint8).to(dev))

    def out0(y):
        return y if isinstance(y, torch.Tensor) else y[0]

    # -- phase 2: each kernel against its plain version, batch 8 -------------
    x8 = normalized(np.concatenate([g["x_uint8_bgr"], gw["x_uint8_bgr"][:1]]))
    max_err = {}  # (name, dt, batch) -> max |d| over the launches
    for dt in cfgs:
        for i, (name, args, kwargs) in enumerate(record(dt, x8)):
            kern, plain, _ = kernels[name]
            got, want = kern(*args, **kwargs), plain(*args, **kwargs)
            err = compare(name, dt, args, got, want, f"site {i}")
            key = (name, dt, 8)
            max_err[key] = max(max_err.get(key, 0.0), err)
            log(f"check {name}[{dt}] site {i} {tuple(out0(want).shape)}: max |d| {err:.3g}")

    # -- phase 3: kernel / plain / library / bound at batch 256 --------------
    def library_call(name, args, kwargs):
        if name == "conv3x3":
            x, k, bias = args
            wk = k.permute(3, 2, 0, 1).contiguous()
            xn = x.permute(0, 3, 1, 2)
            return lambda: F.conv2d(xn, wk, None if bias is None else bias.to(x.dtype))
        if name == "relu6_pool_bn":
            x, w, b = args
            xn = x.permute(0, 3, 1, 2)
            w4, b4 = w.to(x.dtype).view(1, -1, 1, 1), b.to(x.dtype).view(1, -1, 1, 1)
            return lambda: F.avg_pool2d(F.relu6(xn), kwargs["ksize"], kwargs["stride"]) * w4 + b4
        return None

    def work(name, dt, args, kwargs, out):
        """(bytes, FLOPs, peak) the function needs on this launch's operands."""
        if name == "conv3x3":
            x, k, bias = args
            flops = 2 * out.numel() * 9 * x.shape[3]
            return nbytes(x, k, bias, out), flops, PEAK_BF16_TENSOR if dt == "bf16" else PEAK_F32
        if name == "relu6_pool_bn":
            # Only the rows and columns some window covers: k4/s2 skips the last.
            x, w, b = args
            k, st = kwargs["ksize"], kwargs["stride"]
            n, _, _, c = x.shape
            read = n * ((out.shape[1] - 1) * st + k) * ((out.shape[2] - 1) * st + k) * c
            nb = read * x.element_size() + nbytes(w, b, out)
            return nb, out.numel() * (k * k + 3) + read, PEAK_F32
        if name == "residual_bn":
            # Only the res rows and columns with a nonzero interpolation
            # weight: 21->2 reads 3 of 21 of each.
            x, res, s, t = args
            n, _, _, c = res.shape
            hidx, hwt = KR.source_pairs(res.shape[1], x.shape[1], x.dtype)
            widx, wwt = KR.source_pairs(res.shape[2], x.shape[2], x.dtype)
            rows, cols = np.unique(hidx[hwt != 0]).size, np.unique(widx[wwt != 0]).size
            nb = n * rows * cols * c * res.element_size() + nbytes(x, s, t, out)
            flops = 3 * n * x.shape[1] * cols * c + 6 * x.numel()
            return nb, flops, PEAK_F32
        x, packed, widths = args
        flops = x.shape[0] * (2 * sum(widths[i] * widths[i + 1] for i in range(len(widths) - 1))
                              + 4 * sum(widths[1:]))
        return nbytes(x, packed, *out), flops, PEAK_F32

    rng = np.random.RandomState(0)
    x256_u8 = rng.randint(0, 256, size=(256, 224, 224, 3), dtype=np.uint8)
    timing = {}
    for dt in cfgs:
        sites = record(dt, normalized(x256_u8))
        for i, (name, args, kwargs) in enumerate(sites):
            kern, plain, _ = kernels[name]
            out = kern(*args, **kwargs)
            err = compare(name, dt, args, out, plain(*args, **kwargs), f"site {i} at batch 256")
            key = (name, dt, 256)
            max_err[key] = max(max_err.get(key, 0.0), err)
            nb, flops, peak = work(name, dt, args, kwargs, out)
            bound = max(nb / HBM_BYTES_PER_S, flops / peak) * 1e3
            by = "bytes" if nb / HBM_BYTES_PER_S >= flops / peak else "operations"
            fns = {"kernel": lambda: kern(*args, **kwargs), "plain": lambda: plain(*args, **kwargs)}
            lib = library_call(name, args, kwargs)
            if lib is not None:
                fns["library"] = lib
            ms = in_turns(fns, eager=("plain",))
            k_ms, p_ms, l_ms = ms["kernel"], ms["plain"], ms.get("library")
            acc = timing.setdefault((name, dt), {"ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                                                 "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0})
            acc["ms"] += k_ms
            acc["plain_ms"] += p_ms
            if l_ms is not None:
                acc["library_ms"] = (acc["library_ms"] or 0.0) + l_ms
            acc["bound_ms"] += bound
            acc["bytes_ms"] += nb / HBM_BYTES_PER_S * 1e3
            acc["ops_ms"] += flops / peak * 1e3
            lib_s = f"{l_ms:.4f}" if l_ms is not None else "n/a"
            variant = {"conv3x3": conv_variant, "residual_bn": residual_plan,
                       "dense_head": head_plan}.get(name)
            variant = f", {variant(dt, args)}" if variant else ""
            log(f"time {name}[{dt}] site {i} in {tuple(args[0].shape)} -> {tuple(out0(out).shape)}: "
                f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library {lib_s} ms, "
                f"bound {bound:.4f} ms ({by}), max |d| {err:.3g}{variant}")
            del out
        del sites
        torch.cuda.empty_cache()

    # -- phase 4: full forward vs the TF-graph goldens, launches per forward --
    def counts():
        return {n: kernels[n][0].launches for n in kernels}

    def zero_counts():
        for n in kernels:
            kernels[n][0].launches = 0

    for label, gd in (("forward_golden", g), ("forward_golden_wide", gw)):
        xu8 = torch.from_numpy(gd["x_uint8_bgr"]).to(dev)
        for dt, cfg in cfgs.items():
            zero_counts()
            logits = M.forward(variables, M.normalize_bgr_uint8(xu8), cfg).cpu().numpy()
            if (label, dt) == ("forward_golden_wide", "f32"):
                wide_logits = logits
            if counts() != per_forward:
                raise AssertionError(f"{label}[{dt}]: launches {counts()} != {per_forward}")
            d = np.abs(logits - gd["logits"]).max()
            if not np.array_equal(logits.argmax(-1), gd["argmax"]):
                raise AssertionError(f"{label}[{dt}]: argmax differs from the TF graph")
            limit = 1e-4 if dt == "f32" else BF16_DLOGIT[label]
            if not d <= limit:
                raise AssertionError(f"{label}[{dt}]: max |dlogit| {d:.3g} > {limit}")
            log(f"golden {label}[{dt}]: max |dlogit| {d:.3g} (limit {limit}), argmax exact, "
                f"launches {counts()}")
        logits_u8 = M.forward(variables, xu8, M.DEFAULT_CONFIG).cpu().numpy()
        d = np.abs(logits_u8 - gd["logits"]).max()
        if not (d <= 1e-4 and np.array_equal(logits_u8.argmax(-1), gd["argmax"])):
            raise AssertionError(f"{label}[uint8 fold, f32]: max |dlogit| {d:.3g}")
        log(f"golden {label}[uint8 fold, f32]: max |dlogit| {d:.3g}, argmax exact")

    # -- phase 5: the main path, RoomNetClassifier ---------------------------
    serving = {}
    launches = {}
    for dt, cfg in cfgs.items():
        clf = RoomNetClassifier(variables, cfg, batch_size=256, device=dev)
        xb = torch.from_numpy(x256_u8).to(dev)
        fwd_ms = cuda_ms(lambda: clf._predict(clf.variables, xb))
        zero_counts()
        forwards = 0
        for _ in range(2):
            clf.predict(x256_u8)
        t0 = time.perf_counter()
        reps = 10
        for _ in range(reps):
            ids, probs = clf.predict(x256_u8)
        thr = reps * 256 / (time.perf_counter() - t0)
        forwards += 2 + reps
        if not (np.isfinite(probs).all() and np.allclose(probs.sum(-1), 1.0, atol=1e-5)
                and ids.shape == (256,)):
            raise AssertionError(f"serving[{dt}]: malformed output")
        lat = {}
        for n in (1, 3, 8):
            times = []
            for i in range(20):
                t1 = time.perf_counter()
                ids_n, _ = clf.predict(gw["x_uint8_bgr"][i: i + n])
                times.append((time.perf_counter() - t1) * 1e3)
            forwards += 20
            if not np.array_equal(ids_n, gw["argmax"][19: 19 + n]):
                raise AssertionError(f"serving[{dt}]: batch-{n} request argmax differs from the TF graph")
            lat[n] = statistics.median(times)
        got = counts()
        want = {n: c * forwards for n, c in per_forward.items()}
        if got != want:
            raise AssertionError(f"serving[{dt}]: launches {got} != {want} for {forwards} forwards")
        launches[dt] = got
        serving[dt] = {"img_per_s_batch256": thr, "device_forward_ms_batch256": fwd_ms,
                       "p50_ms": {f"batch{n}": v for n, v in lat.items()}, "forwards": forwards}
        log(f"serving[{dt}]: {thr:.1f} img/s at batch 256 (host clock, H2D included), device "
            f"forward {fwd_ms:.3f} ms; p50 latency " +
            ", ".join(f"batch {n} {v:.2f} ms" for n, v in lat.items()) +
            f"; launches {got} over {forwards} forwards")
        del clf, xb
        torch.cuda.empty_cache()

    # -- phase 6: the directory path ------------------------------------------
    directory = phase6(variables, cfgs, gw, wide_logits, x256_u8, serving, counts, zero_counts,
                       per_forward, dev)
    launches = directory.pop("launches")

    # -- phase 7: the training step -------------------------------------------
    training = {"oracles": train_oracles(variables, dev)}
    grad_checks = train_function_checks(variables, cfgs, kernels, dev)
    step_launches = train_launches(variables, cfgs, counts, zero_counts, dev)
    training["times"] = train_times(variables, cfgs, dev, smi)

    # -- phase 8: the serving daemon ------------------------------------------
    server = phase8(variables, cfgs, gw, wide_logits, x256_u8, counts, zero_counts, per_forward, dev, smi)
    serve_launches = server.pop("launches")

    # -- phase 9: the training loop -------------------------------------------
    trainer = phase9(variables, cfgs, counts, zero_counts, per_forward, training["times"], dev, smi)
    trainer_launches = trainer.pop("launches")

    for dt in cfgs:
        log(f"max |d| against plain [{dt}]: " + ", ".join(
            f"{n} {max_err[(n, dt, 8)]:.3g} (batch 8) {max_err[(n, dt, 256)]:.3g} (batch 256)"
            for n in kernels))
    log(json.dumps({"card": smi, "serving": serving, "directory": directory, "training": training,
                    "server": server, "trainer": trainer}))
    log(f"wall: {time.perf_counter() - wall0:.1f} s from start to the result lines")
    rows = []
    for dt in cfgs:
        for name, (_, _, replaces) in kernels.items():
            t = timing[(name, dt)]
            rows.append({
                "name": f"{name}[{dt}]", "route": "cuda",
                "source": f"roomnet_tpu_torch/csrc/{name}.cu", "replaces": replaces,
                "launches": launches[dt][name],
                "max_abs_err": max(max_err[(name, dt, 8)], max_err[(name, dt, 256)]),
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations",
                "library_ms": t["library_ms"],
                "train_step_launches": {m: step_launches[(dt, m)][name] for m in ("infbn", "trainbn")},
                "train_forward_max_abs_err": grad_checks[(name, dt)][0],
                "train_grad_tolerance_share": grad_checks[(name, dt)][1],
                "serve_launches": serve_launches[dt][name],
                "trainer_launches": trainer_launches[dt][name],
            })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


def phase6(variables, cfgs, gw, wide_logits, x256_u8, serving, counts, zero_counts, per_forward, dev) -> dict:
    """The directory path (docstring phase 6). Returns its numbers, and under
    "launches" each dtype's counts from its classify_im_dir run."""
    from roomnet_tpu_torch import CLASS_LABELS
    from roomnet_tpu_torch.infer.classify import (RoomNetClassifier, classify_im_dir,
                                                  groundtruth_validation, load_fill)
    from roomnet_tpu_torch.ops.resize import resize_bilinear_half_pixel
    from roomnet_tpu_torch.utils.xls import read_labels_biff2

    backend = decode_backend()
    log(f"decode backend: {backend or 'none on this host'}")
    want_probs = torch.softmax(torch.from_numpy(wide_logits), -1).numpy()
    result = {"decode_backend": backend or "none", "launches": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        d = os.path.join(root, "imgs")
        layout = write_image_dir(d, gw["x_uint8_bgr"], seed=6)
        golden, crops = layout["golden"], layout["crops"]
        names = sorted(layout["bytes"])
        paths = [os.path.join(d, n) for n in names]
        readable = [n != layout["corrupt"] for n in names]

        def forwards_of(bs: int) -> int:  # batches of `names` that hold a readable file
            return sum(any(readable[b: b + bs]) for b in range(0, len(names), bs))

        def check_counts(where: str, n_forwards: int) -> dict:
            got, want = counts(), {k: c * n_forwards for k, c in per_forward.items()}
            if got != want:
                raise AssertionError(f"{where}: launches {got} != {want} for {n_forwards} forwards")
            return got

        def check_preds(where: str, ids, confs, ok, exact_probs: bool) -> float:
            """ids/confs/ok over `names`: the corrupt file skipped, argmax of
            the golden files equal to the TF graph's; returns max |dprob|."""
            if list(ok) != readable or (ids[~ok] != -1).any():
                raise AssertionError(f"{where}: ok mask {list(ok)} != readable {readable}")
            err = 0.0
            for k, n in enumerate(names):
                if n in golden:
                    if ids[k] != gw["argmax"][golden[n]]:
                        raise AssertionError(f"{where}: {n} argmax {ids[k]} != TF {gw['argmax'][golden[n]]}")
                    err = max(err, float(np.abs(confs[k] - want_probs[golden[n]]).max()))
            if exact_probs and not err <= 1e-5:
                raise AssertionError(f"{where}: f32 probs {err:.3g} from phase 4's softmax (> 1e-5)")
            return err

        if backend is None:
            clf = RoomNetClassifier(variables, cfgs["f32"], device=dev)
            try:
                clf._load(paths[0])
            except RuntimeError as e:
                if "native" not in str(e) or "cv2" not in str(e):
                    raise
            else:
                raise AssertionError("a host with no decoder must raise on decode")
        else:
            # The decode: crops exact (PNG is lossless), 2x within one level.
            clf = RoomNetClassifier(variables, cfgs["f32"], device=dev)
            worst = 0
            for n in names:
                got = clf._load(os.path.join(d, n))
                if n == layout["corrupt"]:
                    if got is not None:
                        raise AssertionError("the corrupt file decoded")
                    continue
                want = crops[n]
                if want.shape[0] != 224:
                    want = resize_bilinear_half_pixel(torch.from_numpy(want[None]).float(), (224, 224))
                    want = want.round().clamp(0, 255).to(torch.uint8)[0].numpy()
                dev_ = int(np.abs(got.astype(np.int16) - want).max())
                if dev_ > (0 if n in golden else 1):
                    raise AssertionError(f"decode {n}: max |d| {dev_} gray levels")
                worst = max(worst, dev_) if n not in golden else worst
            log(f"decode [{backend}]: {len(golden)} crop-only files equal the golden pixels, "
                f"2x files within {worst} gray level of resize_bilinear_half_pixel")
            result["decode_2x_max_levels"] = worst

        for dt, cfg in cfgs.items():
            clf = RoomNetClassifier(variables, cfg, batch_size=16, device=dev)
            n_fwd = forwards_of(16)
            if backend is None:
                arrays = [None if n == layout["corrupt"] else crops[n] if n in golden else
                          resize_bilinear_half_pixel(torch.from_numpy(crops[n][None]).float(), (224, 224))
                          .round().clamp(0, 255).to(torch.uint8)[0].numpy() for n in names]
                zero_counts()
                with ThreadPoolExecutor(clf.decode_workers) as pool:
                    ids, confs, ok = clf.predict_stream(len(names), load_fill(arrays, lambda a: a, pool))
                result["launches"][dt] = check_counts(f"predict_stream[{dt}]", n_fwd)
                err = check_preds(f"predict_stream[{dt}]", ids, confs, ok, dt == "f32")
                log(f"directory[{dt}] through the decode seam: {int(ok.sum())} of {len(names)} items "
                    f"classified, argmax equal to the TF graph, max |dprob| {err:.3g}")
                continue
            out_dir = os.path.join(root, f"out_{dt}")
            zero_counts()
            xl = classify_im_dir(clf, d, overlay=False, out_dir=out_dir, progress=False)
            result["launches"][dt] = check_counts(f"classify_im_dir[{dt}]", n_fwd)
            cells = read_labels_biff2(xl)
            rows = {cells[(r, 0)]: (cells[(r, 1)], float(cells[(r, 2)])) for (r, c) in cells if r > 0 and c == 0}
            with open(out_dir + "_results.csv", newline="") as f:
                csv_rows = {r[0]: (r[1], float(r[2])) for r in list(csv.reader(f))[1:]}
            want_names = {n for n, r in zip(names, readable) if r}
            if set(rows) != want_names or rows != csv_rows:
                raise AssertionError(f"classify_im_dir[{dt}]: .xls/.csv rows differ from the readable files")
            for n in want_names:
                if not os.path.exists(os.path.join(out_dir, rows[n][0], n)):
                    raise AssertionError(f"classify_im_dir[{dt}]: {n} not in its class folder")
            zero_counts()
            ids, confs, ok = clf.predict_paths(paths)
            check_counts(f"predict_paths[{dt}]", n_fwd)
            err = check_preds(f"predict_paths[{dt}]", ids, confs, ok, dt == "f32")
            for k, n in enumerate(names):
                if ok[k] and (rows[n][0] != CLASS_LABELS[ids[k]] or abs(rows[n][1] - confs[k, ids[k]]) > 1e-6):
                    raise AssertionError(f"classify_im_dir[{dt}]: row {n} {rows[n]} != predict_paths")
            lst = os.path.join(root, f"list_{dt}.txt")
            with open(lst, "w") as f:
                for n in names:
                    if n in golden or n == layout["corrupt"]:
                        f.write(f"{os.path.join(d, n)} {int(gw['argmax'][golden.get(n, 0)])}\n")
            zero_counts()
            stats = groundtruth_validation(clf, lst)
            check_counts(f"groundtruth_validation[{dt}]", -(-(len(golden) + 1) // 16))
            if stats["accuracy"] != 1.0:
                raise AssertionError(f"groundtruth_validation[{dt}]: {stats}")
            log(f"directory[{dt}]: classify_im_dir {len(rows)} rows of {len(names)} files (.xls = "
                f".csv, class folders), argmax equal to the TF graph, max |dprob| {err:.3g}, "
                f"groundtruth_validation accuracy {stats['accuracy']}, launches "
                f"{result['launches'][dt]} over {n_fwd} forwards")

        # -- stage times, bf16 at batch 256, nothing claimed --
        bulk = os.path.join(root, "bulk")
        os.makedirs(bulk)
        # Without a decoder the seam gets the crop-only images' arrays.
        src = [n for n in names if n.startswith(("crop_", "double_") if backend else "crop_")]
        bulk_paths = []
        for k in range(1024):
            bulk_paths.append(os.path.join(bulk, f"im_{k:04d}.png"))
            pathlib.Path(bulk_paths[-1]).write_bytes(layout["bytes"][src[k % len(src)]])
        clf = RoomNetClassifier(variables, cfgs["bf16"], batch_size=256, device=dev)
        decode_s = []
        with ThreadPoolExecutor(clf.decode_workers) as pool:
            if backend is None:
                fill = load_fill([crops[src[k % len(src)]] for k in range(1024)], lambda a: a, pool)
            else:
                fill = clf.path_fill(bulk_paths, pool)
            clf.predict_stream(256, fill)  # warm-up
            zero_counts()
            t0 = time.perf_counter()
            ids, _, ok = clf.predict_stream(1024, timed_fill(fill, decode_s))
            wall = time.perf_counter() - t0
        check_counts("predict_paths[bf16] 1024 files", 4)
        if not ok.all():
            raise AssertionError("predict_paths on 1024 files: some file unread")
        for k in range(1024):
            n = src[k % len(src)]
            if n in golden and ids[k] != gw["argmax"][golden[n]]:
                raise AssertionError(f"predict_paths on 1024 files: {n} argmax differs from the TF graph")
        pinned = torch.from_numpy(x256_u8).pin_memory()
        xd = torch.empty(pinned.shape, dtype=torch.uint8, device=dev)
        side = torch.cuda.Stream(dev)
        with torch.cuda.stream(side):
            h2d_ms = cuda_ms(lambda: xd.copy_(pinned, non_blocking=True))
        h2d_pageable_ms = cuda_ms(lambda: xd.copy_(torch.from_numpy(x256_u8)))
        fwd_ms = cuda_ms(lambda: clf._predict(clf.variables, xd))
        staged = torch.empty(x256_u8.shape, dtype=torch.uint8, pin_memory=True).numpy()
        t0 = time.perf_counter()
        for _ in range(10):
            staged[:] = x256_u8  # the copy predict's decode stage makes
        fill_ms = (time.perf_counter() - t0) * 100
        dec_ms = 1e3 * sum(decode_s) / len(decode_s)
        log(f"predict_paths[bf16] 1024 files at batch 256 [{backend or 'decode seam'}]: "
            f"{1024 / wall:.1f} img/s (host clock); decode {dec_ms:.2f} ms per batch (host clock, "
            f"{clf.decode_workers} workers), H2D {h2d_ms:.3f} ms pinned on a copy stream / "
            f"{h2d_pageable_ms:.3f} ms pageable (CUDA events), forward {fwd_ms:.3f} ms (CUDA events)")
        result["predict_paths_bf16_1024"] = {
            "img_per_s": 1024 / wall, "decode_ms_per_batch": dec_ms, "h2d_pinned_ms": h2d_ms,
            "h2d_pageable_ms": h2d_pageable_ms, "forward_ms": fwd_ms}

        # predict from numpy, 10 batches of 256 per call, against the
        # pageable one-stream loop it replaced, in turns.
        x2560 = np.concatenate([x256_u8] * 10)

        def ring():
            return clf.predict(x2560)

        def pageable(x=x2560):
            out = []
            for i in range(0, len(x), 256):
                bid, bprobs = clf._predict(clf.variables, torch.from_numpy(x[i: i + 256]).to(dev, non_blocking=True))
                out.append((bid.cpu().numpy(), bprobs.cpu().numpy()))
            return np.concatenate([o[0] for o in out]), np.concatenate([o[1] for o in out])

        a, b = ring(), pageable()
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            raise AssertionError("predict through the pinned ring differs from the pageable loop")
        thr = {"pinned_ring": [], "pageable": []}
        for name in ("pageable", "pinned_ring", "pinned_ring", "pageable"):
            fn = ring if name == "pinned_ring" else pageable
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                thr[name].append(len(x2560) / (time.perf_counter() - t0))
        thr = {k: statistics.median(v) for k, v in thr.items()}
        # Batch-1 requests, the same two ways, in turns: the host clock
        # spreads by tenths of a millisecond between turns, so each turn's
        # median is printed beside the overall one.
        x1 = gw["x_uint8_bgr"][:1]
        lat = {"pinned_ring": [], "pageable": []}
        turns = {"pinned_ring": [], "pageable": []}
        for name in ("pageable", "pinned_ring") * 4:
            got = []
            for _ in range(40):
                t0 = time.perf_counter()
                clf.predict(x1) if name == "pinned_ring" else pageable(x1)
                got.append((time.perf_counter() - t0) * 1e3)
            lat[name] += got
            turns[name].append(statistics.median(got))
        lat = {k: statistics.median(v) for k, v in lat.items()}
        log(f"predict[bf16] from numpy, 2560 images at batch 256: pinned ring {thr['pinned_ring']:.1f} "
            f"img/s, pageable one-stream loop {thr['pageable']:.1f} img/s (host clock, medians of 6 "
            f"calls in turns); host copy into the ring {fill_ms:.3f} ms per batch, H2D {h2d_ms:.3f} "
            f"ms, forward {fwd_ms:.3f} ms; phase 5 (one batch per call): "
            f"{serving['bf16']['img_per_s_batch256']:.1f} img/s; batch-1 p50 {lat['pinned_ring']:.3f} "
            f"ms through the ring, {lat['pageable']:.3f} ms pageable (160 requests each, 4 turns "
            f"each; per turn " + " / ".join(f"{a:.3f} vs {b:.3f}" for a, b in
                                            zip(turns["pinned_ring"], turns["pageable"])) + ")")
        result["predict_bf16_2560"] = {"pinned_ring_img_per_s": thr["pinned_ring"],
                                       "pageable_img_per_s": thr["pageable"], "host_copy_ms": fill_ms,
                                       "p50_ms_batch1": lat["pinned_ring"],
                                       "pageable_p50_ms_batch1": lat["pageable"],
                                       "p50_ms_batch1_per_turn": turns}
    return result


# -- phase 7: the training step ----------------------------------------------
# The JAX package's own gates against the TF oracles (tests/test_grad_golden.py
# and tests/test_traj_golden.py), pinned here since the card has no JAX:
# (atol, rtol) on each CE gradient per BN mode at 224, 3e-4 on the losses.
GRAD_GATES_224 = {"infbn": (3e-4, 1e-3), "trainbn": (5e-2, 2e-2)}
LOSS_ATOL_224 = 3e-4
TRAJ_LOSS_ATOL = 5e-4
TRAJ_PARAM_ATOL = 1e-4
# Each autograd Function against autograd through its plain version: every
# gradient within GRAD_RTOL[dt] * (|ref| + max|ref|). Both sides compute in
# f32 and round once to the io dtype, in another order (cuDNN's algorithms,
# the reduction order of dw); bf16 allows two bf16 ulps of the largest
# value, f32 1e-4 of it.
GRAD_RTOL = {"f32": 1e-4, "bf16": 2.0 ** -6}
TRAIN_TIMED = (("bf16", 45), ("bf16", 128), ("f32", 45))  # bench.py's train segments, and f32
CHAINS, CHAIN_STEPS = 3, 20
PROFILE_STEPS = 3


def tiny_config():
    """tests/tiny.py's geometry in the port's config: 32², filters (8, 16),
    depths (1, 2), pools ((3, 1), (4, 2)), dense (16, 8), 4 classes."""
    from roomnet_tpu_torch.models.roomnet import RoomNetConfig

    return RoomNetConfig(num_classes=4, im_side=32, block_filters=(8, 16), block_depths=(1, 2),
                         block_pools=((3, 1), (4, 2)), dense_units=(16, 8))


def train_oracles(variables, dev) -> dict:
    """(a) CE, full loss and CE gradients at 224 f32 against grad_golden.npz
    in both BN modes; (b) traj_golden.npz's 6 steps at the tiny geometry,
    sequential and multi-step, in both modes. Returns the worst distances."""
    from roomnet_tpu_torch.models.roomnet import DEFAULT_CONFIG
    from roomnet_tpu_torch.params import schema
    from roomnet_tpu_torch.train.step import (TrainHParams, init_train_state, loss_fn,
                                              make_multi_train_step, make_train_step)

    out = {}
    gg = dict(np.load(GOLDEN / "grad_golden.npz"))
    x, y = torch.from_numpy(gg["x_norm"]).to(dev), torch.from_numpy(gg["labels"]).to(dev)
    train_vars, frozen_vars = schema.partition_flat(schema.flatten_tensors(variables))
    for mode in ("infbn", "trainbn"):
        hp = TrainHParams(l2_coeff=0.0, compute_bn_mean_var=mode == "trainbn")
        params = {k: v.detach().requires_grad_() for k, v in train_vars.items()}
        ce, _ = loss_fn(params, frozen_vars, x, y, hp, DEFAULT_CONFIG)
        grads = torch.autograd.grad(ce, list(params.values()))
        loss, _ = loss_fn(train_vars, frozen_vars, x, y, TrainHParams(compute_bn_mean_var=mode == "trainbn"),
                          DEFAULT_CONFIG)
        d_ce, d_loss = abs(ce.item() - float(gg[f"ce_{mode}"])), abs(loss.item() - float(gg[f"loss_{mode}"]))
        if not (d_ce <= LOSS_ATOL_224 and d_loss <= LOSS_ATOL_224):
            raise AssertionError(f"train oracle 224[{mode}]: |dce| {d_ce:.3g}, |dloss| {d_loss:.3g} > {LOSS_ATOL_224}")
        atol, rtol = GRAD_GATES_224[mode]
        worst, share = 0.0, 0.0
        for path, g in zip(params, grads):
            ref = torch.from_numpy(gg[f"grad_{mode}/{path}"]).to(dev)
            d = (g - ref).abs()
            worst, share = max(worst, d.max().item()), max(share, (d / (atol + rtol * ref.abs())).max().item())
        if share > 1.0:
            raise AssertionError(f"train oracle 224[{mode}]: a CE gradient is {share:.3g}x its gate")
        log(f"train oracle 224[{mode}] f32, 7 images: |dce| {d_ce:.3g}, |dloss| {d_loss:.3g} (gate "
            f"{LOSS_ATOL_224}), CE gradients of {len(grads)} tensors max |d| {worst:.3g}, {share:.3f} of "
            f"the gate (atol {atol}, rtol {rtol})")
        out[f"grad_224_{mode}"] = {"d_ce": d_ce, "d_loss": d_loss, "max_abs_d_grad": worst, "gate_share": share}

    tg = dict(np.load(GOLDEN / "traj_golden.npz"))
    tiny = tiny_config()
    flat = {k[len("traj_param/"):]: v for k, v in tg.items() if k.startswith("traj_param/")}
    steps = int(tg["steps"])
    xt, yt = torch.from_numpy(tg["x_uint8_bgr"]).to(dev), torch.from_numpy(tg["labels"]).to(dev)
    for mode in ("infbn", "trainbn"):
        hp = TrainHParams(learn_rate=float(tg["lr0"]), num_steps=int(tg["sched_steps"]),
                          l2_coeff=float(tg["l2_coeff"]), compute_bn_mean_var=mode == "trainbn")
        variables = schema.variables_from_numpy(flat, tiny, dev)
        step_fn = make_train_step(hp, tiny)
        state, losses = init_train_state(variables, hp), []
        for _ in range(steps):
            state, metrics = step_fn(state, xt, yt)
            losses.append(metrics["loss"])
        multi, m_metrics = make_multi_train_step(hp, tiny)(
            init_train_state(variables, hp), xt.expand(steps, *xt.shape), yt.expand(steps, *yt.shape))
        d_loss = max(float(np.abs(torch.stack(losses).cpu().numpy() - tg[f"losses_{mode}"]).max()),
                     abs(m_metrics["loss"].item() - float(tg[f"losses_{mode}"][-1])))
        d_param = max((st.train_vars[k].cpu() - torch.from_numpy(tg[f"final_{mode}/{k}"])).abs().max().item()
                      for st in (state, multi) for k in st.train_vars)
        if not (d_loss <= TRAJ_LOSS_ATOL and d_param <= TRAJ_PARAM_ATOL):
            raise AssertionError(f"train trajectory[{mode}]: |dloss| {d_loss:.3g}, |dparam| {d_param:.3g}")
        log(f"train trajectory[{mode}] tiny, {steps} steps, sequential and multi-step: max |dloss| "
            f"{d_loss:.3g} (gate {TRAJ_LOSS_ATOL}), max |dparam| {d_param:.3g} (gate {TRAJ_PARAM_ATOL})")
        out[f"traj_{mode}"] = {"max_abs_d_loss": d_loss, "max_abs_d_param": d_param}
    return out


def train_function_checks(variables, cfgs, kernels, dev) -> dict:
    """(c) Each autograd Function against autograd through its plain version
    on the operands of every site of a batch-8 training step (TrainHParams(),
    golden images), f32 and bf16: the forward at phase 2's tolerances, every
    input's gradient within GRAD_RTOL. Returns {(name, dt): (forward max
    |d|, worst gradient share of its tolerance)}."""
    from roomnet_tpu_torch.models import roomnet as M
    from roomnet_tpu_torch.train.step import TrainHParams, init_train_state, make_train_step

    g = dict(np.load(GOLDEN / "forward_golden.npz"))
    gw = dict(np.load(GOLDEN / "forward_golden_wide.npz"))
    x8 = torch.from_numpy(np.concatenate([g["x_uint8_bgr"], gw["x_uint8_bgr"][:1]])).to(dev)
    y8 = torch.from_numpy(np.concatenate([g["argmax"], gw["argmax"][:1]]).astype(np.int64)).to(dev)
    names = {f"{n}_autograd": n for n in kernels}
    result = {}
    gen = torch.Generator(device=dev).manual_seed(7)
    for dt, cfg in cfgs.items():
        sites, saved = [], {fn: getattr(M, fn) for fn in names}

        def recorder(fn):
            def call(*args, **kwargs):
                sites.append((names[fn], args, kwargs))
                return saved[fn](*args, **kwargs)
            return call

        try:
            for fn in names:
                setattr(M, fn, recorder(fn))
            make_train_step(TrainHParams(), cfg)(init_train_state(variables), x8, y8)
        finally:
            for fn, f in saved.items():
                setattr(M, fn, f)
        for i, (name, args, kwargs) in enumerate(sites):
            fn, plain = saved[f"{name}_autograd"], kernels[name][1]
            leaves = [a.detach().clone().requires_grad_() if isinstance(a, torch.Tensor) and a.is_floating_point()
                      else a for a in args]
            grad_of = [a for a in leaves if isinstance(a, torch.Tensor) and a.requires_grad]
            got, want = fn(*leaves, **kwargs), plain(*leaves, **kwargs)
            fwd_err = compare(name, dt, args, got, want, f"train site {i}")
            y_got, y_want = (got[0], want[0]) if name == "dense_head" else (got, want)
            up = torch.randn(y_want.shape, generator=gen, device=dev).to(y_want.dtype)
            g_got = torch.autograd.grad(y_got, grad_of, up)
            g_want = torch.autograd.grad(y_want, grad_of, up)
            share = 0.0
            for a, b in zip(g_got, g_want):
                a, b = a.float(), b.float()
                d = (a - b).abs()
                tol = GRAD_RTOL[dt] * (b.abs() + b.abs().max())
                share = max(share, (d / tol.clamp(min=1e-30)).max().item())
                if not torch.isfinite(a).all() or (d > tol).any():
                    raise AssertionError(f"{name}[{dt}] train site {i}: gradient max |d| {d.max().item():.3g} "
                                         f"beyond {GRAD_RTOL[dt]} * (|ref| + max|ref|)")
            key = (name, dt)
            prev = result.get(key, (0.0, 0.0))
            result[key] = (max(prev[0], fwd_err), max(prev[1], share))
            log(f"autograd {name}[{dt}] train site {i} in {tuple(args[0].shape)}: forward max |d| "
                f"{fwd_err:.3g}, gradients of {len(grad_of)} inputs at {share:.3f} of the tolerance")
    return result


def train_launches(variables, cfgs, counts, zero_counts, dev) -> dict:
    """(d) The kernel launches of one training step at batch 8, per BN mode
    and dtype: 10/10/3/1 with TrainHParams(), 10/10/3/0 with batch stats."""
    from roomnet_tpu_torch.train.step import TrainHParams, init_train_state, make_train_step

    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randint(0, 256, size=(8, 224, 224, 3), dtype=np.uint8)).to(dev)
    y = torch.from_numpy(rng.randint(0, 6, size=(8,))).to(dev)
    want = {"infbn": {"conv3x3": 10, "relu6_pool_bn": 10, "residual_bn": 3, "dense_head": 1},
            "trainbn": {"conv3x3": 10, "relu6_pool_bn": 10, "residual_bn": 3, "dense_head": 0}}
    out = {}
    for dt, cfg in cfgs.items():
        for mode in want:
            hp = TrainHParams(compute_bn_mean_var=mode == "trainbn", update_bn_moving=mode == "trainbn")
            step_fn = make_train_step(hp, cfg)
            state = init_train_state(variables, hp)
            zero_counts()
            state, metrics = step_fn(state, x, y)
            got = counts()
            if got != want[mode]:
                raise AssertionError(f"train step[{dt}, {mode}]: launches {got} != {want[mode]}")
            if not (torch.isfinite(metrics["loss"]) and all(torch.isfinite(v).all() for v in state.train_vars.values())):
                raise AssertionError(f"train step[{dt}, {mode}]: a loss or param is not finite")
            out[(dt, mode)] = got
            log(f"train step[{dt}, {mode}] batch 8: launches {got}, loss {metrics['loss'].item():.4f}")
    return out


def train_times(variables, cfgs, dev, kinds) -> list:
    """(e) Steps of TrainHParams() at TRAIN_TIMED's (dtype, batch): ms per
    step and img/s as the median of CHAINS chains of CHAIN_STEPS steps
    (CUDA events around each chain), each split into forward, backward and
    optimizer by the events the step's `mark` records; peak memory after
    step 5 and step 20 of a fresh state, which must agree within 1%; the
    packed-weight cache's size beside them."""
    from roomnet_tpu_torch.ops.kernels import conv3x3 as KC
    from roomnet_tpu_torch.train.step import TrainHParams, init_train_state, make_train_step

    rows = []
    for dt, batch in TRAIN_TIMED:
        cfg = cfgs[dt]
        rng = np.random.RandomState(batch)
        x = torch.from_numpy(rng.randint(0, 256, size=(batch, 224, 224, 3), dtype=np.uint8)).to(dev)
        y = torch.from_numpy(rng.randint(0, 6, size=(batch,))).to(dev)
        step_fn = make_train_step(TrainHParams(), cfg)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(variables)
        peaks, cache = {}, {}
        for i in range(1, 21):
            state, _ = step_fn(state, x, y)
            if i in (5, 20):
                torch.cuda.synchronize()
                peaks[i], cache[i] = torch.cuda.max_memory_allocated(), len(KC._packed)
        if abs(peaks[20] - peaks[5]) > 0.01 * peaks[5] or cache[20] != cache[5]:
            raise AssertionError(f"train[{dt}] batch {batch}: peak memory {peaks} bytes, packed cache {cache}")
        chains = []
        for _ in range(CHAINS):
            evs = []
            for _ in range(CHAIN_STEPS):
                e = {k: torch.cuda.Event(enable_timing=True) for k in ("start", "forward", "backward", "end")}
                e["start"].record()
                state, metrics = step_fn(state, x, y, mark=lambda k, e=e: e[k].record())
                e["end"].record()
                evs.append(e)
            evs[-1]["end"].synchronize()
            split = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
            for e in evs:
                split["forward"] += e["start"].elapsed_time(e["forward"])
                split["backward"] += e["forward"].elapsed_time(e["backward"])
                split["optimizer"] += e["backward"].elapsed_time(e["end"])
            total = evs[0]["start"].elapsed_time(evs[-1]["end"])
            chains.append({"ms": total / CHAIN_STEPS, **{k: v / CHAIN_STEPS for k, v in split.items()}})
        if not torch.isfinite(metrics["loss"]):
            raise AssertionError(f"train[{dt}] batch {batch}: loss not finite")
        busy, top = profile_steps(lambda: step_fn(state, x, y), PROFILE_STEPS)
        med = sorted(chains, key=lambda c: c["ms"])[CHAINS // 2]
        row = {"dtype": dt, "batch": batch, "ms_per_step": med["ms"], "img_per_s": batch * 1e3 / med["ms"],
               "forward_ms": med["forward"], "backward_ms": med["backward"], "optimizer_ms": med["optimizer"],
               "chains_ms": [c["ms"] for c in chains], "peak_bytes_step5": peaks[5],
               "peak_bytes_step20": peaks[20], "packed_cache_entries": cache[20], "card": kinds,
               "profiled_device_busy_share": busy, "profiled_top_ms_per_step": top}
        rows.append(row)
        log(f"train[{dt}] batch {batch} TrainHParams() on {kinds}: {med['ms']:.3f} ms per step "
            f"({row['img_per_s']:.1f} img/s; median of {CHAINS} chains of {CHAIN_STEPS}: "
            + ", ".join(f"{c['ms']:.3f}" for c in chains) + f" ms), forward {med['forward']:.3f} ms, "
            f"backward {med['backward']:.3f} ms, optimizer {med['optimizer']:.3f} ms; peak memory "
            f"{peaks[5] / 2**20:.1f} MiB after step 5, {peaks[20] / 2**20:.1f} MiB after step 20; "
            f"packed-weight cache {cache[20]} entries; device busy {busy:.3f} of {PROFILE_STEPS} profiled "
            f"steps; device ms per step by kernel: " + "; ".join(f"{n} {ms:.3f}" for n, ms in top.items()))
        del state, x, y
    return rows


def profile_steps(run, steps: int, top: int = 12) -> tuple[float, dict]:
    """Run `steps` calls under torch.profiler: (the share of the steps'
    wall time, by CUDA events around them, that kernels kept the device
    busy, {kernel name (first 60 characters): device ms per step} of the
    `top` kernels by self device time). Kernels of one name are summed; a
    share above 1 would mean overlapping kernels."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(steps):
            run()
        end.record()
        end.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us == 0:
        raise AssertionError("torch.profiler recorded no device time")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    per_step = {e.key[:60]: e.self_device_time_total / 1e3 / steps for e in kernels[:top]}
    return device_us / 1e3 / start.elapsed_time(end), per_step



# -- the training loop (phase 9) and its tests' references ----------------------


LOOP_LR = 1e-3  # (c)'s learning rate, picked on the card (PERF.md §6)
LOOP_STEPS, LOOP_SAVE, LOOP_RESUME = 301, 100, 10
LOOP_ACC_GATE = 0.35  # step-300 validation accuracy; chance is 1/6
LOOP_TOL = 1e-5  # (b): Trainer against hand-driven steps, rtol = atol
PROFILE_WINDOW = (50, 70)  # (c)'s step calls under torch.profiler, before the timed segments


class LoopProbe:
    """Times a Trainer's run from outside it: the host clock at each call of
    its step function, the span of each validation, the train feeder's
    dequeue waits, and a torch.profiler window over the step calls
    [PROFILE_WINDOW[0], PROFILE_WINDOW[1]) with CUDA events around it."""

    def __init__(self, trainer):
        from roomnet_tpu_torch.data import loader

        self.calls, self.validations, self.waits = [], [], []
        self.busy = self.top = None
        self._loader = loader
        real_step, real_val = trainer._step_fn, trainer.run_validation

        def step_fn(ph, **kw):
            fn = real_step(ph, **kw)

            def run(*args):
                i = len(self.calls)
                if i == PROFILE_WINDOW[0]:
                    self._start()
                elif i == PROFILE_WINDOW[1]:
                    self._stop()
                self.calls.append(time.perf_counter())
                return fn(*args)
            return run

        def validation(*args, **kwargs):
            t0 = time.perf_counter()
            out = real_val(*args, **kwargs)
            self.validations.append((t0, time.perf_counter()))
            return out

        trainer._step_fn, trainer.run_validation = step_fn, validation

    def _start(self):
        from torch.profiler import ProfilerActivity, profile

        # Device activity alone: with the host's ops recorded too, the window
        # and key_averages() took about 18 s of phase 9 on an H100 host.
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        self.ev[0].record()

    def _stop(self):
        self.ev[1].record()
        self.ev[1].synchronize()
        self.prof.__exit__(None, None, None)
        kernels = [e for e in self.prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in kernels)
        if device_us == 0:
            raise AssertionError("torch.profiler recorded no device time in the training loop")
        kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
        steps = PROFILE_WINDOW[1] - PROFILE_WINDOW[0]
        self.busy = device_us / 1e3 / self.ev[0].elapsed_time(self.ev[1])
        self.top = {e.key[:60]: e.self_device_time_total / 1e3 / steps for e in kernels[:8]}

    def __enter__(self):
        real, waits = self._loader.TrainFeeder.dequeue, self.waits

        def dequeue(feeder):
            t0 = time.perf_counter()
            out = real(feeder)
            if feeder.shuffle:  # the train feeder; the val feeder reads in order
                waits.append(time.perf_counter() - t0)
            return out

        self._real = real
        self._loader.TrainFeeder.dequeue = dequeue
        return self

    def __exit__(self, *exc):
        self._loader.TrainFeeder.dequeue = self._real


def phase9(variables, cfgs, counts, zero_counts, per_forward, step_times, dev, smi) -> dict:
    """The training loop (docstring phase 9). Returns its numbers, and under
    "launches" each dtype's counts over its Trainer run ((b) f32, (c) bf16)."""
    import dataclasses
    import io

    from roomnet_tpu_torch.data.dataset import extract_fpaths
    from roomnet_tpu_torch.data.loader import to_device_async
    from roomnet_tpu_torch.params.checkpoint import CheckpointStore
    from roomnet_tpu_torch.train.loop import Phase, TrainConfig, Trainer
    from tools.make_synth_dataset import generate

    t_phase = time.perf_counter()
    schema_keys = {"step", "accuracy", "precisions", "recalls", "f-scores"}
    result = {"card": smi, "launches": {}}

    def want(forwards: int) -> dict:
        return {n: c * forwards for n, c in per_forward.items()}

    def checkpoints(tc) -> list:
        return [(s, sfx) for s, sfx, _ in CheckpointStore(tc.model_dir).list_checkpoints()]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_") as root:
        # (a) the data: 600 JPEGs of 250x330, split 540 / 60.
        data = os.path.join(root, "data")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            generate(data, per_class=100, seed=0)
        t1 = time.perf_counter()
        lists = {"train_list_fpath": os.path.join(root, "train_list.txt"),
                 "val_list_fpath": os.path.join(root, "val_list.txt"),
                 "label_mappings_fpath": os.path.join(root, "label_mappings.json")}
        train_txt, val_txt = extract_fpaths(data, *lists.values(), seed=0)
        if (len(train_txt), len(val_txt)) != (540, 60):
            raise AssertionError(f"extract_fpaths split {len(train_txt)} / {len(val_txt)}, not 540 / 60")
        result["data"] = {"generate_s": t1 - t0, "extract_fpaths_s": time.perf_counter() - t1}
        log(f"loop data: 600 JPEGs 250x330 (make_synth_dataset, {t1 - t0:.2f} s), extract_fpaths 540 / 60 "
            f"({time.perf_counter() - t1:.2f} s)")

        def config(name: str, **kw) -> TrainConfig:
            tc = TrainConfig(data_dir=data, stats_fpath=os.path.join(root, f"stats_{name}.json"),
                             model_dir=os.path.join(root, f"models_{name}"),
                             phases=(Phase(until_step=1 << 62, batch_size=45),), **lists, **kw)
            CheckpointStore(tc.model_dir).save(variables, 0)  # the converted weights at step 0
            return tc

        # (b) the loop adds nothing to the math: f32, inference BN, no dropout.
        tc = config("b", save_freq=5)
        tr = Trainer(tc, cfgs["f32"])
        with deterministic():
            states, want_losses = hand_driven(tr, 6)
            losses = record_losses(tr)
            zero_counts()
            with contextlib.redirect_stdout(io.StringIO()):
                state = tr.train(total_steps=6)
        got = counts()
        if got != want(7):
            raise AssertionError(f"loop (b): launches {got} != {want(7)} (6 step forwards, 1 validation forward)")
        result["launches"]["f32"] = got
        gap = state_gap(state_tensors(state), state_tensors(states[-1]), LOOP_TOL)
        d_loss = max(abs(float(a) - b) for a, b in zip(losses, want_losses))
        if not d_loss <= LOOP_TOL:
            raise AssertionError(f"loop (b): losses {d_loss:.3g} from the hand-driven steps")
        with open(tc.stats_fpath) as f:
            stats = json.load(f)
        if [e["step"] for e in stats] != [5] or set(stats[0]) != schema_keys:
            raise AssertionError(f"loop (b): stats {stats}")
        if checkpoints(tc) != [(0, "none"), (5, str(stats[0]["accuracy"]))]:
            raise AssertionError(f"loop (b): checkpoints {checkpoints(tc)}")
        result["hand_driven"] = {"max_abs_d_state": gap, "max_abs_d_loss": d_loss, "launches": got,
                                 "step5_accuracy": stats[0]["accuracy"]}
        log(f"loop (b) f32 batch 45, 6 steps, save_freq 5: Trainer vs hand-driven make_train_step max |d| "
            f"{gap:.3g} (params, BN stats, Adam; gate {LOOP_TOL}), losses {d_loss:.3g}; stats entry at step 5 "
            f"(accuracy {stats[0]['accuracy']}), checkpoint roomnet--{stats[0]['accuracy']}--5.npz; launches {got}")
        del tr, states, state

        # (c) the loop learns: bf16, frozen BN, a fresh head on the converted tower.
        tc = config("c", save_freq=LOOP_SAVE, learn_rate=LOOP_LR, restore_head=False)
        tr = Trainer(tc, cfgs["bf16"])
        zero_counts()
        with LoopProbe(tr) as probe, contextlib.redirect_stdout(io.StringIO()):
            state = tr.train(total_steps=LOOP_STEPS)
        got = counts()
        n_val = LOOP_STEPS // LOOP_SAVE
        if got != want(LOOP_STEPS + n_val):
            raise AssertionError(f"loop (c): launches {got} != {want(LOOP_STEPS + n_val)}")
        result["launches"]["bf16"] = got
        with open(tc.stats_fpath) as f:
            stats = json.load(f)
        curve = {e["step"]: e["accuracy"] for e in stats}
        steps = [LOOP_SAVE * (i + 1) for i in range(n_val)]
        if list(curve) != steps or any(set(e) != schema_keys for e in stats):
            raise AssertionError(f"loop (c): stats {stats}")
        if checkpoints(tc) != [(0, "none")] + [(s, str(curve[s])) for s in steps]:
            raise AssertionError(f"loop (c): checkpoints {checkpoints(tc)}")
        if int(state.step) != LOOP_STEPS:
            raise AssertionError(f"loop (c): ended at step {int(state.step)}")
        log(f"loop (c) bf16 batch 45, frozen BN, fresh head on the converted tower, lr {LOOP_LR:g}: "
            f"validation accuracy " + ", ".join(f"step {s} {a:.4f}" for s, a in curve.items())
            + f" (gate {LOOP_ACC_GATE} at step {steps[-1]}); launches {got}")
        if not curve[steps[-1]] >= LOOP_ACC_GATE:
            raise AssertionError(f"loop (c): step-{steps[-1]} accuracy {curve[steps[-1]]} < {LOOP_ACC_GATE}")
        tr_r = Trainer(dataclasses.replace(tc, restore_head=True), cfgs["bf16"])
        zero_counts()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            state_r = tr_r.train(total_steps=LOOP_RESUME)
        if f"Model restored at step {steps[-1]}" not in out.getvalue() or int(state_r.step) != steps[-1] + LOOP_RESUME:
            raise AssertionError(f"loop (c) resume: ended at step {int(state_r.step)}\n{out.getvalue()[:300]}")
        if counts() != want(LOOP_RESUME) or len(checkpoints(tc)) != n_val + 1:
            raise AssertionError(f"loop (c) resume: launches {counts()}, checkpoints {checkpoints(tc)}")
        log(f"loop (c) resume: a new Trainer restored step {steps[-1]} and ended at step {int(state_r.step)}")
        result["learning"] = {"learn_rate": LOOP_LR, "accuracy": curve, "launches": got,
                              "resumed_to": int(state_r.step)}
        orders = read_orders(tr_r, state_r)
        del tr, tr_r, state, state_r

        # (d) the CLI, as a user runs it, from a directory of its own.
        cli_dir = os.path.join(root, "cli")
        os.makedirs(cli_dir)
        repo = str(pathlib.Path(__file__).resolve().parent)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "roomnet_tpu_torch", "train", "--data-dir", data, "--steps",
                               "21", "--save-freq", "10", "--model-dir", "m"], cwd=cli_dir, env=env,
                              capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"python -m roomnet_tpu_torch train: exit {proc.returncode}\n{proc.stderr[-2000:]}")
        cli_ckpts = [s for s, _, _ in CheckpointStore(os.path.join(cli_dir, "m")).list_checkpoints()]
        with open(os.path.join(cli_dir, "all_train_stats.json")) as f:
            cli_stats = [e["step"] for e in json.load(f)]
        if cli_ckpts != [10, 20] or cli_stats != [10, 20]:
            raise AssertionError(f"python -m roomnet_tpu_torch train: checkpoints {cli_ckpts}, stats {cli_stats}")
        result["cli"] = {"wall_s": cli_s, "checkpoints": cli_ckpts}
        log(f"loop (d) python -m roomnet_tpu_torch train --steps 21 --save-freq 10: exit 0, checkpoints at steps "
            f"{cli_ckpts}, 2 stats entries ({cli_s:.1f} s with the interpreter's start)")

    # (e) times from (c), nothing claimed.
    segments = [LOOP_SAVE * 45 / (b[0] - a[1]) for a, b in zip(probe.validations, probe.validations[1:])]
    waits = np.array(probe.waits[10:]) * 1e3
    step_ms = np.diff(np.array(probe.calls[LOOP_SAVE:])) * 1e3
    x45 = np.random.RandomState(45).randint(0, 256, size=(45, 224, 224, 3), dtype=np.uint8)
    y45 = np.arange(45, dtype=np.int32) % 6
    pinned = torch.from_numpy(x45).pin_memory()
    xd = torch.empty(pinned.shape, dtype=torch.uint8, device=dev)
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        h2d_ms = cuda_ms(lambda: xd.copy_(pinned, non_blocking=True))
    stage_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        to_device_async((x45, y45), dev, side)
        stage_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    bare = next(r for r in step_times if (r["dtype"], r["batch"]) == ("bf16", 45))
    times = {"img_per_s_between_validations": segments, "bare_step_img_per_s": bare["img_per_s"],
             "bare_step_ms": bare["ms_per_step"], "host_ms_per_step_p50": float(np.median(step_ms)),
             "dequeue_wait_ms_p50": float(np.percentile(waits, 50)),
             "dequeue_wait_ms_p99": float(np.percentile(waits, 99)), "h2d_ms_batch45": h2d_ms,
             "stage_host_ms_batch45_p50": float(np.median(stage_ms)),
             "validation_s": [b - a for a, b in probe.validations], "profiled_device_busy_share": probe.busy,
             "profiled_steps": list(PROFILE_WINDOW), "profiled_top_ms_per_step": probe.top,
             "read_orders_ms_per_step": orders, "card": smi}
    result["times"] = times
    log(f"loop times [bf16, batch 45, {smi}]: Trainer " + " / ".join(f"{v:.1f}" for v in segments)
        + f" img/s between validations (host clock), bare step (phase 7) {bare['img_per_s']:.1f} img/s "
        f"({bare['ms_per_step']:.3f} ms); host ms per step p50 {times['host_ms_per_step_p50']:.3f}; dequeue wait "
        f"p50 {times['dequeue_wait_ms_p50']:.3f} ms, p99 {times['dequeue_wait_ms_p99']:.3f} ms; H2D {h2d_ms:.3f} ms "
        f"per batch (CUDA events), staging on the host {times['stage_host_ms_batch45_p50']:.3f} ms; validation "
        + ", ".join(f"{v:.2f}" for v in times["validation_s"]) + f" s; device busy {probe.busy:.3f} of steps "
        f"{PROFILE_WINDOW[0]}-{PROFILE_WINDOW[1]} (torch.profiler); device ms per step by kernel: "
        + "; ".join(f"{n} {v:.3f}" for n, v in probe.top.items()))
    log(f"loop read orders [bf16, batch 45, {smi}], ms per step over {READ_ORDER_STEPS} steps from a full queue "
        f"(host clock to a final synchronize), windows in the order {' '.join(READ_ORDERS)}: " + "; ".join(
            f"{o} " + " / ".join(f"{v:.3f}" for v in ms) for o, ms in orders.items()))
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"loop: phase 9 took {result['wall_s']:.1f} s")
    return result


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms inside the block. Its default wgrad
    algorithms may sum in another order from call to call: without this, the
    first chip runs of phase 9 (b) found the Trainer and the hand-driven
    steps, on the same batches, 1.36e-4 and 2.36e-5 apart in the Adam moment
    of conv 0 (whose gradient sums 2.2 million products per weight at batch
    45), with the params within LOOP_TOL."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


READ_ORDERS = ("now", "lagged", "lagged", "now")  # windows in turns, each order first and last once
READ_ORDER_STEPS = 15


def read_orders(trainer, state) -> dict:
    """The Trainer's step (its first phase, from `state`) in a loop like the
    Trainer's: stage a batch from a TrainFeeder over its train list on its
    copy stream (`to_device_async`), issue the step on it (`on_stream`),
    stage the next batch, then read a loss: the step's own ("now", the
    Trainer's order) or the step's before it ("lagged"). Windows of
    READ_ORDER_STEPS steps in the order READ_ORDERS, each started with the
    feeder's queue full (bounded wait) and the device drained, so each
    times the feeder at steady state, decoding one batch per step. Returns
    {order: [ms per step of each window]}: host clock to a final
    synchronize."""
    from roomnet_tpu_torch.data.loader import TrainFeeder, on_stream, to_device_async

    tc, dev = trainer.tc, trainer.device
    ph = tc.phases[0]
    step_fn = trainer._step_fn(ph)
    gen = torch.Generator(dev).manual_seed(tc.seed + 1)
    with open(tc.train_list_fpath) as f:
        lines = f.readlines()
    out = {o: [] for o in dict.fromkeys(READ_ORDERS)}
    with TrainFeeder(lines, batch_size=ph.batch_size, batches_per_queue=tc.batches_per_queue, shuffle=True,
                     im_side=tc.img_side, random_crop=True, preprocess=True, seed=tc.seed) as feeder:
        def stage():
            return to_device_async(feeder.dequeue(), dev, trainer._copy_stream)

        for order in READ_ORDERS:
            deadline = time.perf_counter() + 30.0
            while not feeder._q.full() and time.perf_counter() < deadline:
                time.sleep(0.01)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pending, prev = stage(), None
            for _ in range(READ_ORDER_STEPS):
                x, y = on_stream(pending)
                state, metrics = step_fn(state, x, y, gen)
                pending = stage()
                if order == "now":
                    float(metrics["loss"])
                else:
                    if prev is not None:
                        float(prev)
                    prev = metrics["loss"]
            torch.cuda.synchronize()
            out[order].append((time.perf_counter() - t0) * 1e3 / READ_ORDER_STEPS)
    return out


def hand_driven(trainer, steps: int) -> tuple[list, list]:
    """(states, losses) after each of `steps` calls of make_train_step, from
    `trainer.init_state()` (call it before the Trainer's run writes a
    checkpoint) and the batches of a fresh TrainFeeder over the trainer's
    train list and seed, with one dropout generator seeded tc.seed + 1: what
    `trainer.train(total_steps=steps)` computes when its first phase spans
    the run, since validation and checkpoints change no state."""
    from roomnet_tpu_torch.data.loader import TrainFeeder
    from roomnet_tpu_torch.train.step import make_train_step

    tc, dev = trainer.tc, trainer.device
    ph = tc.phases[0]
    with open(tc.train_list_fpath) as f:
        lines = f.readlines()
    step_fn = make_train_step(trainer._hp(ph), trainer.cfg)
    gen = torch.Generator(dev).manual_seed(tc.seed + 1)
    state = trainer.init_state()
    states, losses = [], []
    with TrainFeeder(lines, batch_size=ph.batch_size, batches_per_queue=tc.batches_per_queue, shuffle=True,
                     im_side=tc.img_side, random_crop=True, preprocess=True, seed=tc.seed) as feeder:
        for _ in range(steps):
            x, y = feeder.dequeue()
            state, metrics = step_fn(state, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), gen)
            states.append(state)
            losses.append(float(metrics["loss"]))
    return states, losses


def record_losses(trainer) -> list:
    """Wrap `trainer._step_fn` so that each step's loss tensor is appended to
    the list returned (read them after the run)."""
    real, losses = trainer._step_fn, []

    def step_fn(ph, **kw):
        fn = real(ph, **kw)

        def run(*args):
            state, metrics = fn(*args)
            losses.append(metrics["loss"])
            return state, metrics
        return run

    trainer._step_fn = step_fn
    return losses


def state_tensors(state) -> dict:
    """{name: tensor} of a TrainState: step, train vars, BN moving stats and
    the Adam count and moments, under the checkpoint's names."""
    from roomnet_tpu_torch.train.optimizer import flatten_opt_state

    return {"meta/step": state.step, **state.train_vars, **state.frozen_vars,
            **{f"opt/{k}": v for k, v in flatten_opt_state(state.opt_state).items()}}


def state_gap(got: dict, want: dict, tol: float) -> float:
    """Max |d| between two {name: array or tensor} dicts with the same keys;
    raises where |d| > tol + tol * |want|."""
    if set(got) != set(want):
        raise AssertionError(f"state keys differ: {sorted(set(got) ^ set(want))[:6]}")
    worst = 0.0
    for k in want:
        a = np.asarray(got[k].detach().cpu() if isinstance(got[k], torch.Tensor) else got[k], np.float64)
        b = np.asarray(want[k].detach().cpu() if isinstance(want[k], torch.Tensor) else want[k], np.float64)
        d = np.abs(a - b)
        if a.shape != b.shape or (d > tol + tol * np.abs(b)).any():
            raise AssertionError(f"{k}: max |d| {d.max() if d.size else 'shape'} beyond {tol}")
        worst = max(worst, float(d.max()) if d.size else 0.0)
    return worst


# -- phase 8: the serving daemon ----------------------------------------------
SEQ_TURNS, SEQ_PER_TURN = 4, 50  # sequential requests: 200 on each kind of connection
BURSTS, BURST = 5, 64


def http_request(port: int, method: str, path: str, body: bytes | None = None, conn=None):
    """(status, body bytes) of one request, on `conn` (keep-alive) or on a
    connection of its own."""
    import http.client

    c = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        c.request(method, path, body=body)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        if conn is None:
            c.close()


def http_json(port: int, method: str, path: str, body: bytes | None = None):
    status, data = http_request(port, method, path, body)
    return status, json.loads(data) if data else None


def phase8(variables, cfgs, gw, wide_logits, x256_u8, counts, zero_counts, per_forward, dev, smi) -> dict:
    """The serving daemon (docstring phase 8). Returns its numbers, and under
    "launches" each dtype's counts from its classify requests."""
    import base64

    from roomnet_tpu_torch.params import schema
    from roomnet_tpu_torch.params.checkpoint import CheckpointStore

    t_phase = time.perf_counter()
    want_probs = torch.softmax(torch.from_numpy(wide_logits), -1).numpy()
    tf_ids = gw["argmax"].astype(int)
    bodies = [png_bytes(im) for im in gw["x_uint8_bgr"]]
    payload = json.dumps({"images": [base64.b64encode(b).decode() for b in bodies]}).encode()
    flat = schema.flatten_variables(variables)
    head = f"dense/{len(variables['dense']) - 1}"
    rolled, nan = dict(flat), dict(flat)
    rolled[f"{head}/kernel"] = np.roll(flat[f"{head}/kernel"], 1, axis=1)
    rolled[f"{head}/bias"] = np.roll(flat[f"{head}/bias"], 1)
    nan["dense/0/kernel"] = np.full_like(flat["dense/0/kernel"], np.nan)
    result = {"card": smi, "launches": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as root:
        edir, imgs = os.path.join(root, "eval_models"), os.path.join(root, "imgs")
        estore = CheckpointStore(edir)
        estore.save(variables, 1, suffix="1.0")
        estore.save(schema.variables_from_numpy(rolled, device="cpu"), 2, suffix="0.0")
        os.makedirs(imgs)
        lst = os.path.join(root, "list.txt")
        with open(lst, "w") as f:
            for i, b in enumerate(bodies):
                path = os.path.join(imgs, f"crop_{i:02d}.png")
                pathlib.Path(path).write_bytes(b)
                f.write(f"{path} {tf_ids[i]}\n")
        for dt, cfg in cfgs.items():
            # A model dir per dtype, its step 1 the converted weights.
            mdir = os.path.join(root, f"models_{dt}")
            store = CheckpointStore(mdir)
            store.save(variables, 1, suffix="1.0")
            trees = {"rolled": rolled, "nan": nan}
            result[dt] = serve_checks(dt, cfg, variables, trees, (store, mdir, edir, lst), (bodies, payload),
                                      (tf_ids, want_probs), x256_u8, counts, zero_counts, per_forward, dev,
                                      result["launches"])
        # The CLI once, as a user runs it: the bf16 default, from the repo root.
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "roomnet_tpu_torch", "validate", "--list-file", lst,
                               "--batch-size", "32"], cwd=pathlib.Path(__file__).resolve().parent,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"python -m roomnet_tpu_torch validate: exit {proc.returncode}\n"
                                 f"{proc.stderr[-2000:]}")
        stats = json.loads(proc.stdout)
        if stats["accuracy"] != 1.0:
            raise AssertionError(f"python -m roomnet_tpu_torch validate: {stats}")
        result["cli_validate"] = {"accuracy": stats["accuracy"], "wall_s": time.perf_counter() - t0}
        log(f"server: python -m roomnet_tpu_torch validate --list-file <{len(bodies)} PNGs> --batch-size 32: accuracy "
            f"{stats['accuracy']} ({time.perf_counter() - t0:.1f} s with the interpreter's start)")
    result["times"] = serve_times(variables, cfgs["bf16"], dev, smi)
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"server: phase 8 took {result['wall_s']:.1f} s")
    return result


def serve_checks(dt, cfg, variables, trees, dirs, requests, golden, x256_u8, counts, zero_counts, per_forward,
                 dev, launches) -> dict:
    """Phase 8 (a) for one dtype: `trees` the rolled-head and NaN flat
    dicts, `dirs` (store, its dir, the evaluation dir, the list file),
    `requests` (the 64 PNG bodies, the /classify_batch payload of all 64),
    `golden` (TF argmax, phase 4's softmax). Adds the classify requests'
    launches to `launches[dt]`."""
    from roomnet_tpu_torch import CLASS_LABELS
    from roomnet_tpu_torch.infer.classify import RoomNetClassifier, evaluate_checkpoints
    from roomnet_tpu_torch.infer.server import ClassifierServer
    from roomnet_tpu_torch.params import schema

    store, mdir, edir, lst = dirs
    bodies, payload = requests
    tf_ids, want_probs = golden

    f32 = dt == "f32"
    clf = RoomNetClassifier(variables, cfg, batch_size=32, device=dev)
    t0 = time.perf_counter()
    srv = ClassifierServer(clf, port=0, warmup=True, max_inflight=64, model_dir=mdir).start()
    start_s = time.perf_counter() - t0
    port = srv.port
    out = {"start_s": start_s}
    try:
        for path in ("/healthz", "/readyz"):
            status, _ = http_json(port, "GET", path)
            if status != 200:
                raise AssertionError(f"server[{dt}] {path}: {status}")
        if http_json(port, "GET", "/labels") != (200, CLASS_LABELS):
            raise AssertionError(f"server[{dt}] /labels is not CLASS_LABELS")
        if http_json(port, "POST", "/reload") != (200, {"status": "reloaded", "step": 1}):
            raise AssertionError(f"server[{dt}] /reload of the step-1 checkpoint failed")

        def device_calls() -> int:
            return http_json(port, "GET", "/metrics")[1].get("serve/device_call", {}).get("count", 0)

        def classify_all() -> list:
            got = []
            for b in bodies:
                status, r = http_json(port, "POST", "/classify", b)
                if status != 200:
                    raise AssertionError(f"server[{dt}] /classify: {status} {r}")
                got.append(r)
            return got

        def check(where: str, results: list, shift: int = 0) -> float:
            """class_id == (TF argmax + shift) mod 6 for each golden image;
            with shift 0, the max |dprob| from phase 4's softmax (f32: <= 1e-5)."""
            err = 0.0
            for i, r in enumerate(results):
                if r.get("class_id") != (tf_ids[i] + shift) % 6:
                    raise AssertionError(f"server[{dt}] {where}: image {i} answered {r}, TF argmax {tf_ids[i]}")
                if shift == 0:
                    err = max(err, float(np.abs(np.asarray(r["probs"]) - want_probs[i]).max()))
            if f32 and shift == 0 and not err <= 1e-5:
                raise AssertionError(f"server[{dt}] {where}: f32 probs {err:.3g} from phase 4's softmax")
            return err

        zero_counts()
        c0 = device_calls()
        singles = classify_all()
        c1 = device_calls()
        status, batch = http_json(port, "POST", "/classify_batch", payload)
        c2 = device_calls()
        if status != 200 or c2 - c1 != -(-len(bodies) // 32):
            raise AssertionError(f"server[{dt}] /classify_batch of {len(bodies)}: {status}, {c2 - c1} device calls")
        status, data = http_request(port, "POST", "/classify_batch?stream=1", payload)
        lines = [json.loads(line) for line in data.splitlines()]
        if status != 200 or [line["index"] for line in lines] != list(range(len(bodies))):
            raise AssertionError(f"server[{dt}] ?stream=1: {status}, indices {[l.get('index') for l in lines]}")
        calls = device_calls() - c0
        got = counts()
        want = {n: c * calls for n, c in per_forward.items()}
        if got != want:
            raise AssertionError(f"server[{dt}]: launches {got} != {want} for {calls} device calls")
        launches[dt] = got
        errs = {"classify": check("/classify", singles), "classify_batch": check("/classify_batch", batch["results"]),
                "stream": check("?stream=1", lines)}
        across = max(float(np.abs(np.asarray(a["probs"]) - np.asarray(b["probs"])).max())
                     for a, b in zip(singles, batch["results"]))
        out.update(max_abs_dprob=errs, single_vs_batch_max_abs_dprob=across, device_calls=calls, launches=got)
        log(f"server[{dt}] batch 32: /classify x{len(bodies)}, /classify_batch ({c2 - c1} device calls), "
            f"?stream=1 ({len(lines)} lines): "
            f"class_id = TF argmax, max |dprob| from phase 4's softmax " +
            ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f", bucket 1 vs 32 {across:.3g}; launches "
            f"{got} over {calls} device calls; started in {start_s:.2f} s (warmup of 6 buckets)")

        # Each bucket's device call against the rows of the batch-256 forward.
        xb = torch.from_numpy(x256_u8).to(dev)
        ids256, p256 = (t.cpu().numpy() for t in clf._predict(clf.variables, xb))
        bucket_err = {}
        for b in srv._bucket_sizes:
            ids_b, probs_b = (t.cpu().numpy() for t in clf._predict(clf.variables, xb[:b]))
            d = float(np.abs(probs_b - p256[:b]).max())
            if not np.array_equal(ids_b, ids256[:b]) or (f32 and d > 1e-5):
                raise AssertionError(f"server[{dt}] bucket {b}: argmax or probs ({d:.3g}) differ from batch 256")
            bucket_err[b] = d
        out["bucket_max_abs_dprob"] = bucket_err
        log(f"server[{dt}] buckets {srv._bucket_sizes} against the batch-256 forward: argmax equal, max |dprob| "
            + ", ".join(f"{b}: {d:.3g}" for b, d in bucket_err.items()))
        del xb

        # Hot reload: the rolled head moves every answer by one class; a NaN
        # tree fails the probe and changes nothing.
        store.save(schema.variables_from_numpy(trees["rolled"], device="cpu"), 2, suffix="0.0")
        if http_json(port, "POST", "/reload") != (200, {"status": "reloaded", "step": 2}):
            raise AssertionError(f"server[{dt}] /reload of the rolled head failed")
        if http_json(port, "GET", "/version")[1]["step"] != 2:
            raise AssertionError(f"server[{dt}] /version after the reload")
        moved = classify_all()
        check("/classify after the rolled-head reload", moved, shift=1)
        store.save(schema.variables_from_numpy(trees["nan"], device="cpu"), 3, suffix="nan")
        status, rej = http_json(port, "POST", "/reload")
        if status != 409 or "non-finite" not in rej["error"]:
            raise AssertionError(f"server[{dt}] /reload of a NaN tree: {status} {rej}")
        if http_json(port, "GET", "/version")[1]["step"] != 2:
            raise AssertionError(f"server[{dt}] /version moved after a rejected reload")
        kept = classify_all()
        if [r["class_id"] for r in kept] != [r["class_id"] for r in moved] or max(
                float(np.abs(np.asarray(a["probs"]) - np.asarray(b["probs"])).max()) for a, b in zip(kept, moved)) > 1e-6:
            raise AssertionError(f"server[{dt}] answers changed after a rejected reload")
        log(f"server[{dt}] /reload: rolled head (step 2) moved all {len(moved)} answers to TF argmax + 1 mod 6; NaN tree "
            f"(step 3) answered 409 ({rej['error'][:80]}), step 2 and its answers kept")
    finally:
        srv.stop()
        clf.close()

    sweep = evaluate_checkpoints(edir, lst, cfg, batch_size=32, device=dev)
    accs = [(e["step"], e["accuracy"]) for e in sweep["checkpoints"]]
    if accs != [(1, 1.0), (2, 0.0)] or sweep["best"]["step"] != 1:
        raise AssertionError(f"evaluate_checkpoints[{dt}]: {accs}, best {sweep['best']['step']}")
    out["evaluate_checkpoints"] = accs
    log(f"evaluate_checkpoints[{dt}] over steps 1 (converted) and 2 (rolled head): accuracy {accs}, best step 1")
    return out


def serve_times(variables, cfg, dev, smi) -> dict:
    """Phase 8 (b): bench.py's serving setup, bf16, nothing claimed."""
    import cv2

    from roomnet_tpu_torch.infer.classify import RoomNetClassifier
    from roomnet_tpu_torch.infer.server import ClassifierServer
    from roomnet_tpu_torch.utils.profiling import SPANS
    from tools.make_synth_dataset import make_image

    ok, buf = cv2.imencode(".jpg", make_image(2, np.random.RandomState(1), 480, 640)[:, :, ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, 88])
    if not ok:
        raise AssertionError("cv2 could not encode the request image")
    body = buf.tobytes()
    clf = RoomNetClassifier(variables, cfg, batch_size=8, device=dev)
    srv = ClassifierServer(clf, port=0, max_inflight=64, warmup=True).start()
    port = srv.port
    side = clf.host_side
    try:
        def classify(conn=None):
            status, data = http_request(port, "POST", "/classify", body, conn)
            if status != 200:
                raise AssertionError(f"serving times: /classify {status} {data[:200]}")

        classify()
        SPANS.reset()
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        lat = {"keepalive": [], "per_connection": []}
        for turn in range(SEQ_TURNS):
            for mode in (("keepalive", "per_connection") if turn % 2 == 0 else ("per_connection", "keepalive")):
                for _ in range(SEQ_PER_TURN):
                    t0 = time.perf_counter()
                    classify(conn if mode == "keepalive" else None)
                    lat[mode].append((time.perf_counter() - t0) * 1e3)
        conn.close()
        seq = {m: {"p50_ms": float(np.percentile(v, 50)), "p99_ms": float(np.percentile(v, 99)), "n": len(v)}
               for m, v in lat.items()}

        def metrics():
            return http_json(port, "GET", "/metrics")[1]

        pool = ThreadPoolExecutor(BURST)

        def burst():
            list(pool.map(lambda _: classify(), range(BURST)))

        bursts = []
        try:
            for _ in range(BURSTS):
                m0 = metrics()
                t0 = time.perf_counter()
                burst()
                wall = time.perf_counter() - t0
                m1 = metrics()
                calls = m1["serve/device_call"]["count"] - m0["serve/device_call"]["count"]
                shipped = m1["serve/device_call_bytes"]["total"] - m0["serve/device_call_bytes"]["total"]
                bursts.append({"req_per_s": BURST / wall, "device_calls": calls,
                               "rows_per_call": BURST / calls,
                               "rows_over_bucket_rows": BURST / (shipped / (side * side * 3)),
                               "shipped_MB": shipped / 1e6})
            busy, top = profile_steps(burst, 1)
        finally:
            pool.shutdown()
        m = metrics()
        decode = []
        for _ in range(50):
            t0 = time.perf_counter()
            x1 = srv._preprocess(body)
            decode.append((time.perf_counter() - t0) * 1e3)
        spans = span_cost(clf, x1[None])
    finally:
        srv.stop()
        clf.close()
    med = {k: statistics.median(b[k] for b in bursts) for k in bursts[0]}
    out = {"card": smi, "sequential": seq, "bursts": bursts, "burst_median": med,
           "device_call_p50_ms": m["serve/device_call"]["p50_ms"], "fetch_p50_ms": m["serve/fetch"]["p50_ms"],
           "decode_ms_per_request": statistics.median(decode), "burst_device_busy_share": busy,
           "burst_top_device_ms": top, "predict_batch1_p50_ms_spans_on_off": spans}
    log(f"serving times [bf16, batch 8, {smi}]: sequential /classify p50 / p99 keep-alive "
        f"{seq['keepalive']['p50_ms']:.3f} / {seq['keepalive']['p99_ms']:.3f} ms, a connection per request "
        f"{seq['per_connection']['p50_ms']:.3f} / {seq['per_connection']['p99_ms']:.3f} ms ({SEQ_TURNS} turns of "
        f"{SEQ_PER_TURN}); {BURSTS} bursts of {BURST}: " + ", ".join(f"{b['req_per_s']:.1f}" for b in bursts)
        + f" req/s, median {med['device_calls']:.0f} device calls, {med['rows_per_call']:.2f} rows per call, "
        f"rows / bucket rows {med['rows_over_bucket_rows']:.3f}, {med['shipped_MB']:.2f} MB shipped; "
        f"serve/device_call p50 {out['device_call_p50_ms']:.3f} ms, serve/fetch p50 {out['fetch_p50_ms']:.3f} "
        f"ms, decode {out['decode_ms_per_request']:.3f} ms per request (host clock); device busy {busy:.3f} of "
        f"a profiled burst's wall time; device ms by kernel: " + "; ".join(f"{n} {v:.3f}" for n, v in top.items()))
    log(f"predict[bf16] batch 1 p50 with the e2e spans {spans['on']:.3f} ms, with trace a no-op "
        f"{spans['off']:.3f} ms (host clock, 4 turns of 50 each, {smi})")
    return out


def span_cost(clf, x1) -> dict:
    """p50 ms of `clf.predict(x1)` with predict_stream's e2e spans and with
    its `trace` replaced by a no-op, in turns."""
    import contextlib

    from roomnet_tpu_torch.infer import classify

    real = classify.trace
    lat = {"on": [], "off": []}
    try:
        for turn in range(4):
            for mode in (("on", "off") if turn % 2 == 0 else ("off", "on")):
                classify.trace = real if mode == "on" else (lambda name: contextlib.nullcontext())
                for _ in range(50):
                    t0 = time.perf_counter()
                    clf.predict(x1)
                    lat[mode].append((time.perf_counter() - t0) * 1e3)
    finally:
        classify.trace = real
    return {k: statistics.median(v) for k, v in lat.items()}


if __name__ == "__main__":
    main()
