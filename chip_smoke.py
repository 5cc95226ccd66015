#!/usr/bin/env python3
"""Smoke run of the PyTorch port (roomnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's RoomNet serving forward at 224² on the converted
reference checkpoint (artifacts/roomnet_params.npz) through its four CUDA
kernels, in phases; any failure raises and the script exits non-zero. A
phase's launch counts are differences of the kernels' counters
(`kernel/launches.<kernel>`) taken around the counted work by
ops/kernels/_build.card_launches_since, which also fails the phase if a
wrapper ran its plain version there; nothing zeroes them:

  1. The card's name and power limit; build the kernels from csrc/ (one
     nvcc per source, in parallel) and print the build time and ptxas usage;
     count the conv library's HGMMA (wgmma), UTMALDG and UTMASTG (TMA load
     and store) SASS lines, and the HGMMA lines of the TF32 kind in its f32
     TF32 split kernels (conv_tf32x3), with the cuobjdump beside that nvcc,
     each of which must be there (no cuobjdump fails the phase). With
     --parent DIR, DIR's csrc/conv3x3.cu is built beside them.
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
     cannot hold). Each site prints its launch plan: the conv's path
     (wgmma+TMA, mma.sync, the f32 TF32 split on wgmma+TMA or the f32
     CUDA cores), rows per warp, tile, warpgroups, stages, wgmma shape (and
     the TF32 split's wgmmas a tap and block, `tap_wgmmas`), Cout
     tiles, how the output is stored and shared
     memory (csrc/conv3x3.cu:rn_conv3x3_variant), the residual's strip, span, shared memory and
     blocks, the head's variant (resident or streamed, rows per block)
     beside an empty kernel's graph-replayed time.
     The bound is max(bytes / 3.35 TB/s, FLOPs / peak), peak 67 TFLOP/s for
     f32 arithmetic and 989 TFLOP/s for bf16 convolutions (H100 SXM); the
     f32 conv where it runs on the TF32 split counts the three TF32 products
     per f32 one that f32 accuracy needs (the kernel issues a fourth) at 495
     TFLOP/s, conv 0 the f32 peak. Bytes
     count each input element the function reads once (for the pool and the
     residual, only the rows and columns its windows or weights reach) and
     each output once. The phase ends with each dtype's summed conv kernel,
     library and bound times (f32: beside the CUDA-core method's bound).
     With --parent, each conv site (bf16 and f32) also holds DIR's kernel
     against the plain version and times it in the same turns (its line's
     "parent" ms, summed on those lines).
  4. The full forward against the TF-graph goldens (forward_golden.npz, 7
     images, and forward_golden_wide.npz, 64): f32 logits within 1e-4 and
     argmax exact (float and uint8-fold input); bf16 argmax exact and
     |dlogit| within BF16_DLOGIT; launch counts 10/10/3/1 per forward.
  5. The serving path: RoomNetClassifier.predict at batch 256 (throughput)
     and requests of batch 1, 3 and 8 (latency), bf16 and f32, with the
     launches counted over each dtype's run.
  6. The directory path, the main path of a user: a directory of PNG files
     written here (standard library zlib only) from the 64 wide-golden
     images, each centred in a 224x300 or 300x224 canvas with random
     margins, 8 noisy 2x images in 448x600 canvases, a name with spaces, an
     extensionless copy and a corrupt file. classify_im_dir and
     groundtruth_validation at batch 16, f32 and bf16, launches counted
     from just before to just after: argmax equal to the TF graph's, f32 probs
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
     of one step, counted from just before to just after:
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
     lines), the same answers; launches, counted from just before those
     requests to just after, 10/10/3/1 per serve/device_call of
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
 10. Scale-out (parallel/, the Trainer on a mesh, params/orbax_io.py), on a
     dataset of 120 JPEGs (make_synth_dataset, split 108 / 12), each Trainer
     from the converted weights at step 0, f32, 6 steps (3 with batch
     statistics and the moving update, then 3 with inference BN), save_freq 5,
     under cuDNN's deterministic algorithms: (a) a world of one over NCCL
     (`make_mesh()` without a process group): Trainer(mesh=...) against
     Trainer() at batch 45, max |d| 0 in params, BN stats and Adam state,
     equal stats entries, launches 70/70/21/4; (b) two ranks spawned on the
     one card over gloo (NCCL refuses two ranks on one device), replicated
     then sharded feed, at batch 46 (45 rounded up to the data axis, 23 rows
     a rank) against one process at 46: the ranks' states equal; params and
     BN stats, and the Adam moments (of their largest), each within the
     larger of DP_TOL / DP_MOMENT_SHARE and DP_FLOOR_TIMES the gap between
     one process and itself on the same batches with their rows reversed
     (the floor of any other order of summation); launches per rank per
     step 10/10/3/0 with batch statistics
     and 10/10/3/1 with inference BN; (c) the DCP store on the card: an async
     save of the converted weights, `wait`, a load equal to them; a one-rank
     orbax Trainer saves step 5, the two ranks of (b) resume it and save
     step 10 collectively, one process resumes step 10; (d) `python -m
     roomnet_tpu_torch train --data-parallel --ckpt-backend orbax --steps 6`
     as a subprocess: exit 0, a DCP checkpoint at step 5; (e) the bf16 step
     at batch 45, inference BN and batch statistics, without and with the
     world-of-one mesh, DP_TIMED_STEPS steps a window in the turns
     DP_WINDOWS, ms per step on the host clock, nothing claimed; (f) only
     where torch.cuda.device_count() >= 2: (b)'s replicated run over NCCL
     across two cards. The kernels line's dp_launches are (a)'s counts for
     f32 and (e)'s mesh windows' for bf16; dp_rank_step_launches are (b)'s
     per rank per step (f32) and (e)'s per mesh step (bf16).

 11. The server on a mesh (infer/server.py's lockstep ranks, `serve
     --data-parallel`), batch 32 on the converted weights, f32 and bf16, the
     same requests in every run (mesh_requests: one /classify, a 5-image
     /classify_batch and a 40-image ?stream=1, PNGs of make_image), each
     held against a one-process server on the same tree: (a) a world of one
     over NCCL (`make_mesh()`): max |dprob| 0 and class_id equal, buckets
     [1, 2, ..., 32], 10/10/3/1 launches per device call; (b) two ranks
     spawned on the one card over gloo (mesh_serve_rank; rank 0 serves and
     drives itself from a client thread): buckets [2, 4, 8, 16, 32], the
     lone request padded to 2 and both ranks making the same calls, f32
     probabilities within 1e-5 and class_id equal (bf16: class_id equal, as
     phase 8), 10/10/3/1 launches per rank per call; /reload of a second
     seeded tree (step 12) swaps both ranks and then answers as a
     one-process server on that tree; a NaN tree (step 13) answers 409 and
     both ranks keep step 12; SIGTERM with a 2 s drain ends both ranks with
     0; (c) `torchrun --nproc-per-node 1 -m roomnet_tpu_torch serve
     --data-parallel` as a subprocess: /readyz 200, one /classify, exit 0
     on SIGTERM to the rank; (d) only where torch.cuda.device_count() >= 2:
     (b) over NCCL across two cards; (e) times, bf16, nothing claimed:
     sequential keep-alive /classify p50 and a 64-way burst, without the
     mesh and with the world of one, in the turns MESH_TURNS. The kernels
     line's server_mesh_launches are (b)'s per rank per device call.

 12. Tensor parallelism over the mesh's 'model' axis in the training step
     (parallel/tensor.py, `make_train_step(..., tp=...)`): the converted
     weights, f32, TrainHParams(learn_rate=1e-3) with inference BN and with
     batch statistics and the moving update, TP_STEPS steps on the same
     TP_BATCH rows, each against the single-process step on the card, under
     cuDNN's deterministic algorithms. Each run's launches per step are
     10/10/3/1 (10/10/3/0 with batch statistics) and its conv3x3 kernel
     launches take Cout 8, 32 x3, 64 x2, 128 / n_model (block 4, split over
     'model'), 16 x3. (a) A world of one over NCCL
     (`make_mesh()`, tensor_parallel=True): max |d| 0. (b) A (1, 2) mesh, two
     ranks on the one card over gloo; (c) a (2, 2) mesh, four ranks over
     gloo, 8 rows a data rank: the ranks' gathered states equal, each rank
     holding half of every split leaf and of its Adam moments, the state
     within the larger of TP_TOL and TP_FLOOR_TIMES the floor of one process
     and, with batch statistics, the Adam moments within the larger of
     TP_MOMENT_SHARE and TP_FLOOR_TIMES the floor of their largest
     (tests/test_torch_parallel.py's rule, with phase 10 (b)'s floor). The
     floor of another summation order is the larger of one process on the
     rows reversed and the data-parallel (2, 1) mesh on (b)'s two ranks, no
     leaf split, against one process. (d) Only where
     torch.cuda.device_count() >= 2: (b) over NCCL across two cards. (e)
     Times, bf16 at batch 45, nothing claimed: ms per step without a mesh,
     with the world-of-one mesh (its data group and the TP placements) and
     with the TP placements alone (no data group: the TP code path's own
     cost), TP_TIMED_STEPS steps a window in the turns TP_WINDOWS, host
     clock. The kernels line's tp_rank_step_launches are (b)'s per rank per
     step (f32) and (e)'s per mesh step (bf16).

 13. From scratch through the curriculum (train/loop.py's Trainer from its
     own init_variables, TrainConfig.reference_curriculum's four phases:
     batch 8 with batch statistics and the moving update, 32 and 40 with
     dropout 0.3, then 45 with the BN freeze), on 600 JPEGs
     (make_synth_dataset, split 540 / 60): (a) f32, CURRICULUM_STEPS steps a
     phase, no validation, under cuDNN's deterministic algorithms: the
     Trainer against the same steps driven by hand through make_train_step
     (`hand_driven`: each phase's hparams, a new feeder at each batch size,
     one dropout generator), max |d| 0 in params, BN moving stats and Adam
     state and in the losses, across the three boundaries; launches per step
     10/10/3/0 in the first three phases and 10/10/3/1 in the last; (b) bf16,
     reference_curriculum(CURRICULUM_TOTAL), phases of 100 steps, save_freq
     CURRICULUM_SAVE, the loss read every CURRICULUM_LOG_EVERY steps as
     tools/train_synth_torch.py reads it: every loss finite, stats entries in
     the reference schema at steps 50-350, acc-named checkpoints, the
     validations before the freeze with batch statistics and those after with
     the moving ones (each validation's launches: 10/10/3/0 per forward
     before, 10/10/3/1 after), the launches per step of each phase as in (a);
     the freeze step's checkpoint validated again with moving statistics
     (equal to the run's entry) and with batch statistics (a record); a new
     Trainer resumes the step-CURRICULUM_RESUME checkpoint (batch 40, dropout)
     and runs across the freeze to the end; (c) times from (b), nothing
     claimed: each phase's img/s and host ms per step p50 (host clock, gaps
     between step calls without a validation), and the device's busy share
     over its step calls CURRICULUM_WINDOW (torch.profiler). The kernels
     line's curriculum_launches are (a)'s counts for f32 and (b)'s for bf16,
     curriculum_step_launches their launches per step by phase.

 14. The bench and the val-scale parity run: (a) `python -m
     roomnet_tpu_torch bench` (roomnet_tpu_torch/bench.py at its full sizes)
     in this process, its stdout captured: one JSON line whose keys and
     extras' keys are those of the repo root's bench.py (read from its
     source with ast, nothing imported) and its metric bench.py's string,
     every number in it finite and positive, `device` nvidia-smi's line,
     `device_forward_ms_batch256` within BENCH_FORWARD_SHARE of phase 5's
     bf16 device forward, and launches 10/10/3/1 per forward and per
     inference-BN train step of the run (`bench_forwards`); (b)
     tools/valset_torch.py's run on the 1,609 valset images that need no
     reference PNG: its drift guards pass, f32 argmax equal to the TF
     graph's on every image, the sample logits within 1e-4, bf16 flips under
     1%, and launches 10/10/3/1 per forward of each dtype's run. The kernels
     line's bench_launches are (a)'s counts on the bf16 rows (the bench runs
     bf16 alone, and its counts are one total: null on the f32 rows),
     valset_launches (b)'s by dtype.

 15. ResNet-50 v1.5 (models/resnet.py, `resnet50-v1.5-224-bf16`): the conv1x1
     library's SASS must hold HGMMA, UTMALDG and UTMASTG lines; at each of
     its 16 3x3 and 36 1x1 conv sites at batch 256 (random operands, the
     site's stride, padding, bias, ReLU and residual) the streamed conv3x3
     path (conv_wg_stream) and the persistent conv1x1 GEMM
     (conv1x1_bn_kernel) against their plain versions within one bf16 ulp,
     then timed in turns with cuDNN (F.conv2d on channels-last bf16 with
     the bias, then the residual add and the ReLU as PyTorch ops) and, with
     `--parent DIR`, DIR's conv1x1 at the 1x1 sites, beside the site's bound
     (benchmark/arch/resnet50/work.py's arithmetic: each operand read
     once, bf16 at 989 TFLOP/s, 3.35 TB/s), each summed per forward and,
     for the 1x1, per stage; each 1x1 site's line gives its persistent
     blocks and the tiles a block walks; then one batch-256 forward through
     RoomNetClassifier._predict (launches 16 conv3x3 and 36 conv1x1, and
     the tiles a block walks over the forward, from conv1x1.variant's
     plans) and its device time. `--only-phase15` runs phase 1 and this
     phase alone.

Phase 5 also prints utils/roofline.py's summary of the batch-256 device
forward, bf16 (2 bytes, the bf16 peak) and f32 (4 bytes, the f32 peak; the
convs on the TF32 split at a third of the TF32 peak).
Then the JSON line of serving, directory, training, server, trainer,
scale-out, mesh-server, tensor-parallel, curriculum, bench and valset numbers, the script's wall
time, one JSON line of per-kernel results and, last, the device line.
f32 parity needs TF32 off; the script turns it off for everything it runs.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import ctypes
import json
import math
import os
import pathlib
import shutil
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

from roomnet_tpu_torch.ops.kernels import _build
from roomnet_tpu_torch.utils.roofline import H100_BF16_PEAK_FLOPS as PEAK_BF16_TENSOR
from roomnet_tpu_torch.utils.roofline import H100_F32_PEAK_FLOPS as PEAK_F32
from roomnet_tpu_torch.utils.roofline import H100_HBM_BYTES_PER_S as HBM_BYTES_PER_S
from roomnet_tpu_torch.utils.roofline import H100_TF32_PEAK_FLOPS as PEAK_TF32
from roomnet_tpu_torch.utils.roofline import TF32X3_PASSES

WINDOW_MS = 20.0  # device time of one timed window
PER_FORWARD = {"conv3x3": 10, "relu6_pool_bn": 10, "residual_bn": 3, "dense_head": 1}  # launches per forward
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


def sass_counts(lib) -> dict:
    """Lines of `lib`'s SASS (cuobjdump -sass, from the toolkit that holds the
    nvcc the kernels are built with) that hold wgmma (HGMMA) and TMA loads
    and stores (UTMALDG, UTMASTG), and the HGMMA lines of the TF32 kind in
    the f32 entry's TF32 split kernels (functions named conv_tf32x3:
    "HGMMA_TF32"). Raises where that toolkit has no cuobjdump."""
    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        raise FileNotFoundError(f"no cuobjdump beside {_build._nvcc()}: the conv's SASS cannot be checked")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    counts = dict.fromkeys(("HGMMA", "UTMALDG", "UTMASTG", "HGMMA_TF32"), 0)
    function = ""
    for line in text.splitlines():
        if "Function :" in line:
            function = line
        for op in ("HGMMA", "UTMALDG", "UTMASTG"):
            counts[op] += op in line
        counts["HGMMA_TF32"] += "HGMMA" in line and "TF32" in line and "conv_tf32x3" in function
    return counts


def parent_library(checkout: pathlib.Path, name: str):
    """Starts one nvcc on another checkout's csrc/<name>.cu, with this
    checkout's flags, into build/roomnet_tpu_torch/parent/. Returns a
    function that waits for it and loads the library (ctypes), or raises
    with nvcc's log."""
    out = _build.BUILD_DIR / "parent" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = checkout / "roomnet_tpu_torch" / "csrc" / f"{name}.cu"
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{src}: build failed:\n{text}")
        return ctypes.CDLL(str(out))

    return finish


def parent_conv3x3(checkout: pathlib.Path):
    """Starts one nvcc on another checkout's csrc/conv3x3.cu (`parent_library`).
    Returns a function that waits for it and gives a conv3x3(x, kernel, bias) through
    that library's rn_conv3x3, which must take this checkout's C entry, on
    weights packed by that checkout's ops/kernels/conv3x3.py (its
    packed_kernel: pack_bf16 in bf16, pack_tf32x3 where its tf32_takes
    admits Cin, else pack_f32; NT at dim 3 of pack_tf32x3's). Its launches
    count nowhere."""
    import importlib.util

    from roomnet_tpu_torch.ops.kernels import conv3x3 as KC

    # Loaded as a sibling of this checkout's module, so that its relative
    # imports (blocks, _build) resolve here.
    spec = importlib.util.spec_from_file_location("roomnet_tpu_torch.ops.kernels._parent_conv3x3",
                                                  checkout / "roomnet_tpu_torch" / "ops" / "kernels" / "conv3x3.py")
    PK = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(PK)
    build = parent_library(checkout, "conv3x3")

    def finish():
        fn = build().rn_conv3x3
        fn.argtypes, fn.restype = KC._ARGS, ctypes.c_int

        def conv(x, kernel, bias=None):
            B, H, W, cin = x.shape
            bf16 = x.dtype == torch.bfloat16
            tf32x3 = not bf16 and PK.tf32_takes(cin)
            packed = PK.packed_kernel(kernel, x.dtype, tf32x3)
            cp = packed.shape[1] if bf16 else packed.shape[3 if tf32x3 else -1]
            y = torch.empty((B, H - 2, W - 2, kernel.shape[3]), dtype=x.dtype, device=x.device)
            rc = fn(x.data_ptr(), packed.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
                    B, H, W, cin, kernel.shape[3], cp, int(bf16), x.device.index,
                    torch.cuda.current_stream(x.device).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{checkout}: rn_conv3x3 returned CUDA error {rc}")
            return y

        return conv

    return finish


def parent_conv1x1(checkout: pathlib.Path):
    """Starts one nvcc on another checkout's csrc/conv1x1.cu (`parent_library`).
    Returns a function that waits for it and gives a conv1x1(x, kernel,
    bias, stride=, relu=, residual=) through that library's rn_conv1x1,
    whose C entry must take the arguments it took before the persistent
    kernel (no SM count), on weights packed by this checkout's pack_stream.
    Its launches count nowhere."""
    from roomnet_tpu_torch.ops.kernels import conv3x3 as KC

    build = parent_library(checkout, "conv1x1")

    def finish():
        fn = build().rn_conv1x1
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes, fn.restype = [P] * 5 + [I] * 9 + [P], ctypes.c_int

        def conv(x, kernel, bias=None, *, stride=1, relu=False, residual=None):
            B, H, W, cin = x.shape
            cout = kernel.shape[3]
            packed = KC.packed_kernel(kernel, x.dtype, layout="stream")
            y = torch.empty((B, (H - 1) // stride + 1, (W - 1) // stride + 1, cout), dtype=x.dtype,
                            device=x.device)
            rc = fn(x.data_ptr(), packed.data_ptr(), None if bias is None else bias.data_ptr(),
                    None if residual is None else residual.data_ptr(), y.data_ptr(), B, H, W, cin, cout, stride,
                    int(relu), packed.shape[2], x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{checkout}: rn_conv1x1 returned CUDA error {rc}")
            return y

        return conv

    return finish


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one NVIDIA GPU.")
    ap.add_argument("--only-phase15", action="store_true",
                    help="run phase 1 (the card, the build) and phase 15 (ResNet-50's kernels) alone")
    ap.add_argument("--parent", type=pathlib.Path, metavar="DIR",
                    help="another checkout whose csrc/conv3x3.cu phase 3 also checks and times at the "
                         "conv sites (bf16 and f32), and whose csrc/conv1x1.cu phase 15 times at the 1x1 "
                         "sites, in the same turns")
    opts = ap.parse_args(argv)
    wall0 = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; the port's smoke run needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from roomnet_tpu_torch.infer.classify import RoomNetClassifier
    from roomnet_tpu_torch.models import roomnet as M
    from roomnet_tpu_torch.ops.kernels import conv3x3 as KC
    from roomnet_tpu_torch.ops.kernels import dense_head as KD
    from roomnet_tpu_torch.ops.kernels import pool as KP
    from roomnet_tpu_torch.ops.kernels import residual as KR
    from roomnet_tpu_torch.params.schema import load_npz
    from roomnet_tpu_torch.utils.roofline import summarize

    kernels = {
        "conv3x3": (KC.conv3x3, KC.conv3x3_plain, "roomnet_tpu/ops/pallas/conv_b2.py:70"),
        "relu6_pool_bn": (KP.relu6_pool_bn, KP.relu6_pool_bn_plain, "roomnet_tpu/ops/pallas/pool.py:83"),
        "residual_bn": (KR.residual_bn, KR.residual_bn_plain, "roomnet_tpu/ops/pallas/residual.py:104"),
        "dense_head": (KD.dense_head, KD.dense_head_plain, "roomnet_tpu/ops/pallas/dense_head.py:53"),
    }
    per_forward = PER_FORWARD
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- phase 1: card, build -------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    t0 = time.perf_counter()
    parent_build = parent_conv3x3(opts.parent.resolve()) if opts.parent else None
    parent_build1 = parent_conv1x1(opts.parent.resolve()) if opts.parent else None
    _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    parent_conv = parent_build() if parent_build else None
    parent_conv1 = parent_build1() if parent_build1 else None
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(_build.SOURCES)} kernels "
        f"into {_build.BUILD_DIR}")
    for name in _build.SOURCES:
        logf = _build.BUILD_DIR / f"{name}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if any(w in line for w in ("entry function", "registers", "spill", "wgmma")):
                    log(f"  ptxas {name}: {line.strip()}")
    sass = sass_counts(_build.library_path("conv3x3"))
    log(f"  sass conv3x3: {sass}")
    if not (sass["HGMMA"] and sass["UTMALDG"] and sass["UTMASTG"] and sass["HGMMA_TF32"]):
        raise AssertionError(f"conv3x3: the library's SASS lacks wgmma, TMA or the f32 path's TF32 wgmma: {sass}")
    if opts.only_phase15:
        log(json.dumps({"card": smi, "resnet50": phase15(dev, parent_conv1)}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return

    def conv_variant(dt: str, args) -> str:
        """The conv kernel's variant for one launch (csrc/conv3x3.cu:rn_conv3x3_variant)."""
        x, k = args[0], args[1]
        v = KC.variant(tuple(x.shape), k.shape[3], x.dtype)
        names = ("Cout_p", "rows/warp") if dt == "bf16" else ("NT", "warp cols")
        if v["path"] == "tf32x3 wgmma+TMA":
            return (f"{v['path']}, NT {v['cp']} ({v['cout_tiles']} Cout tiles), m64 blocks {v['sub']}, tile "
                    f"{v['rows']}x{v['cols']}, {v['warpgroups']} warpgroups, {v['stages']} stages of "
                    f"{v['chunk']} channels, tap_wgmmas {v['tap_wgmmas']} x m64n{2 * v['cp']}k8 (B [hi | lo]), "
                    f"lane stores, smem {v['smem']} B")
        s = f"{v['path']}, {names[0]} {v['cp']}, {names[1]} {v['sub']}, tile {v['rows']}x{v['cols']}"
        if v["path"] == "wgmma+TMA":
            s += (f", {v['warpgroups']} warpgroups, {v['stages']} stages, m64n{v['cp']}k16, "
                  + (f"TMA store swizzle {v['out_swizzle']} B" if v["tma_store"] else "lane stores"))
        return s + f", smem {v['smem']} B"

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
        """(bytes, operations, peak) the function needs on this launch's
        operands. The f32 conv where it runs on the TF32 split counts the
        TF32X3_PASSES products per f32 one that f32 accuracy needs, at the
        TF32 peak (conv 0 stays on the CUDA cores' f32 peak)."""
        if name == "conv3x3":
            x, k, bias = args
            flops = 2 * out.numel() * 9 * x.shape[3]
            if dt == "bf16":
                return nbytes(x, k, bias, out), flops, PEAK_BF16_TENSOR
            if KC.tf32_takes(x.shape[3]):
                return nbytes(x, k, bias, out), TF32X3_PASSES * flops, PEAK_TF32
            return nbytes(x, k, bias, out), flops, PEAK_F32
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
    parent_total = {}
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
            parent_s = ""
            if parent_conv is not None and name == "conv3x3":
                parent_err = compare(name, dt, args, parent_conv(*args), plain(*args, **kwargs),
                                     f"site {i} at batch 256, --parent's kernel")
                fns["parent"] = lambda: parent_conv(*args)
            ms = in_turns(fns, eager=("plain",))
            if "parent" in ms:
                parent_total[dt] = parent_total.get(dt, 0.0) + ms["parent"]
                parent_s = f", parent {ms['parent']:.4f} ms (max |d| {parent_err:.3g})"
            k_ms, p_ms, l_ms = ms["kernel"], ms["plain"], ms.get("library")
            acc = timing.setdefault((name, dt), {"ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                                                 "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                                                 "cores_bound_ms": 0.0})
            if name == "conv3x3":
                # The CUDA cores' f32 method, for the record beside the bound.
                acc["cores_bound_ms"] += max(nb / HBM_BYTES_PER_S,
                                             2 * out.numel() * 9 * args[0].shape[3] / PEAK_F32) * 1e3
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
                f"bound {bound:.4f} ms ({by}), max |d| {err:.3g}{parent_s}{variant}")
            del out
        del sites
        torch.cuda.empty_cache()
    for dt in cfgs:
        t = timing["conv3x3", dt]
        log(f"time conv3x3[{dt}] summed over its sites [{smi}]: kernel {t['ms']:.4f} ms, "
            + (f"parent {parent_total[dt]:.4f} ms, " if dt in parent_total else "")
            + f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms"
            + (f" (CUDA-core method: {t['cores_bound_ms']:.4f} ms)" if dt == "f32" else ""))

    # -- phase 4: full forward vs the TF-graph goldens, launches per forward --
    base = _build.launch_counts()

    def counts():
        return _build.card_launches_since(base, PER_FORWARD)

    def start_counts():
        base.update(_build.launch_counts())

    for label, gd in (("forward_golden", g), ("forward_golden_wide", gw)):
        xu8 = torch.from_numpy(gd["x_uint8_bgr"]).to(dev)
        for dt, cfg in cfgs.items():
            start_counts()
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
        start_counts()
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
        # The analytic roofline of the whole forward (utils/roofline.py) at
        # this dtype's bytes and peak, against the device forward's time.
        dtype_bytes, peak = (2, PEAK_BF16_TENSOR) if dt == "bf16" else (4, PEAK_F32)
        conv_peak = None
        if dt == "f32":  # the convs on the TF32 split, as phase 3's bound counts them
            def conv_peak(cin):
                return PEAK_TF32 / TF32X3_PASSES if KC.tf32_takes(cin) else PEAK_F32
        roofline = summarize(cfg, 256, dtype_bytes=dtype_bytes, peak_flops=peak, measured_s=fwd_ms / 1e3,
                             conv_peak_flops=conv_peak)
        serving[dt] = {"img_per_s_batch256": thr, "device_forward_ms_batch256": fwd_ms,
                       "p50_ms": {f"batch{n}": v for n, v in lat.items()}, "forwards": forwards,
                       "roofline": roofline}
        log(f"serving[{dt}]: {thr:.1f} img/s at batch 256 (host clock, H2D included), device "
            f"forward {fwd_ms:.3f} ms; p50 latency " +
            ", ".join(f"batch {n} {v:.2f} ms" for n, v in lat.items()) +
            f"; launches {got} over {forwards} forwards")
        log(f"roofline[{dt}] (utils/roofline.py summarize(cfg, 256, dtype_bytes={dtype_bytes}, peak_flops={peak:g}"
            + (", conv_peak_flops=TF32 / 3 where the conv takes Cin" if conv_peak else "") + ") "
            f"of the device forward, {smi}): " + json.dumps(roofline))
        del clf, xb
        torch.cuda.empty_cache()

    # -- phase 6: the directory path ------------------------------------------
    directory = phase6(variables, cfgs, gw, wide_logits, x256_u8, serving, counts, start_counts,
                       per_forward, dev)
    launches = directory.pop("launches")

    # -- phase 7: the training step -------------------------------------------
    training = {"oracles": train_oracles(variables, dev)}
    grad_checks = train_function_checks(variables, cfgs, kernels, dev)
    step_launches = train_launches(variables, cfgs, counts, start_counts, dev)
    training["times"] = train_times(variables, cfgs, dev, smi)

    # -- phase 8: the serving daemon ------------------------------------------
    server = phase8(variables, cfgs, gw, wide_logits, x256_u8, counts, start_counts, per_forward, dev, smi)
    serve_launches = server.pop("launches")

    # -- phase 9: the training loop -------------------------------------------
    trainer = phase9(variables, cfgs, counts, start_counts, per_forward, training["times"], dev, smi)
    trainer_launches = trainer.pop("launches")

    # -- phase 10: scale-out ----------------------------------------------------
    scale_out = phase10(variables, cfgs, counts, start_counts, dev, smi)
    dp_launches = scale_out.pop("launches")
    dp_per_step = {"f32": scale_out["two_ranks_gloo"]["replicated"]["launches_per_rank_step"],
                   "bf16": scale_out["step_ms"]["per_step_launches"]}

    # -- phase 11: the server on a mesh -------------------------------------------
    server_mesh = phase11(variables, cfgs, counts, start_counts, per_forward, dev, smi)
    server_mesh.pop("launches")

    # -- phase 12: tensor parallelism ---------------------------------------------
    tensor_parallel = phase12(variables, counts, start_counts, dev, smi)
    tp_per_step = tensor_parallel.pop("launches")

    # -- phase 13: from scratch through the curriculum -----------------------------
    curriculum = phase13(cfgs, counts, start_counts, per_forward, dev, smi)
    curriculum_launches = curriculum.pop("launches")

    # -- phase 14: the bench and the val-scale parity run ---------------------------
    bench_valset = phase14(counts, start_counts, per_forward, serving, dev, smi)
    bv_launches = bench_valset.pop("launches")

    # -- phase 15: ResNet-50's kernels -------------------------------------------
    resnet50 = phase15(dev, parent_conv1)

    for dt in cfgs:
        log(f"max |d| against plain [{dt}]: " + ", ".join(
            f"{n} {max_err[(n, dt, 8)]:.3g} (batch 8) {max_err[(n, dt, 256)]:.3g} (batch 256)"
            for n in kernels))
    log(json.dumps({"card": smi, "serving": serving, "directory": directory, "training": training,
                    "server": server, "trainer": trainer, "scale_out": scale_out, "server_mesh": server_mesh,
                    "tensor_parallel": tensor_parallel, "curriculum": curriculum, "bench_valset": bench_valset,
                    "resnet50": resnet50}))
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
                "dp_launches": dp_launches[dt][name],
                "dp_rank_step_launches": {m: c[name] for m, c in dp_per_step[dt].items()},
                "server_mesh_launches": server_mesh["two_ranks_gloo"][dt]["launches_per_rank_call"][name],
                "tp_rank_step_launches": {m: c[name] for m, c in tp_per_step[dt].items()},
                "curriculum_launches": curriculum_launches[dt]["run"][name],
                "curriculum_step_launches": [c[name] for c in curriculum_launches[dt]["per_step"]],
                # The bench runs FAST_CONFIG alone and its counts are not split by dtype:
                # they sit on the bf16 rows, and the f32 rows have none measured.
                "bench_launches": bv_launches["bench"][name] if dt == "bf16" else None,
                "valset_launches": bv_launches["valset"][dt][name],
            })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


def phase6(variables, cfgs, gw, wide_logits, x256_u8, serving, counts, start_counts, per_forward, dev) -> dict:
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
                start_counts()
                with ThreadPoolExecutor(clf.decode_workers) as pool:
                    ids, confs, ok = clf.predict_stream(len(names), load_fill(arrays, lambda a: a, pool))
                result["launches"][dt] = check_counts(f"predict_stream[{dt}]", n_fwd)
                err = check_preds(f"predict_stream[{dt}]", ids, confs, ok, dt == "f32")
                log(f"directory[{dt}] through the decode seam: {int(ok.sum())} of {len(names)} items "
                    f"classified, argmax equal to the TF graph, max |dprob| {err:.3g}")
                continue
            out_dir = os.path.join(root, f"out_{dt}")
            start_counts()
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
            start_counts()
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
            start_counts()
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
            start_counts()
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


def train_launches(variables, cfgs, counts, start_counts, dev) -> dict:
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
            start_counts()
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


def phase9(variables, cfgs, counts, start_counts, per_forward, step_times, dev, smi) -> dict:
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
            start_counts()
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
        start_counts()
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
        start_counts()
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
    checkpoint), each with the hparams of its step's phase (`phase_at` from
    the restored step on), on the batches of a TrainFeeder over the
    trainer's train list and seed, made anew where the batch size changes
    as the Trainer makes it, with one dropout generator seeded tc.seed + 1:
    what `trainer.train(total_steps=steps)` computes, since validation and
    checkpoints change no state."""
    from roomnet_tpu_torch.data.loader import TrainFeeder
    from roomnet_tpu_torch.train.loop import phase_at
    from roomnet_tpu_torch.train.step import make_train_step

    tc, dev = trainer.tc, trainer.device
    with open(tc.train_list_fpath) as f:
        lines = f.readlines()
    gen = torch.Generator(dev).manual_seed(tc.seed + 1)
    state = trainer.init_state()
    start = int(state.step)
    states, losses, step_fns = [], [], {}
    feeder = batch = None
    try:
        for i in range(start, start + steps):
            ph = phase_at(tc.phases, i)
            if ph.batch_size != batch:
                if feeder is not None:
                    feeder.close()
                batch = ph.batch_size
                feeder = TrainFeeder(lines, batch_size=ph.batch_size, batches_per_queue=tc.batches_per_queue,
                                     shuffle=True, im_side=tc.img_side, random_crop=True, preprocess=True,
                                     seed=tc.seed)
            if ph not in step_fns:
                step_fns[ph] = make_train_step(trainer._hp(ph), trainer.cfg)
            x, y = feeder.dequeue()
            state, metrics = step_fns[ph](state, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), gen)
            states.append(state)
            losses.append(float(metrics["loss"]))
    finally:
        if feeder is not None:
            feeder.close()
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


# -- phase 10: scale-out -----------------------------------------------------------


DP_STEPS = 6  # (a), (b): 3 steps with batch statistics, then 3 with inference BN; a validation at step 5
# (b): two ranks against one process, params and BN moving stats (|d| / (1 + |want|)) and the Adam moments
# (of each tensor's largest), each within the larger of a fixed limit and DP_FLOOR_TIMES the floor: one
# process against itself on the same batches with their rows reversed, which changes only the order of
# every sum over rows. On an H100 that floor was 1.04e-4 to 1.09e-4 and 0.0125 to 0.0256 (PERF.md §6): under batch
# statistics a few gradients are small differences of large sums, and TF1 Adam's m / sqrt(v) turns their
# rounding into steps, so no limit below the floor holds for any order of summation.
DP_TOL = 1e-5
DP_MOMENT_SHARE = 5e-3
DP_FLOOR_TIMES = 2.0
DP_TIMED_STEPS = 20  # (e): steps per timed window
DP_WINDOWS = ("plain", "mesh", "mesh", "plain")  # (e): windows in turns
DP_JOIN_S = 420.0  # (b), (c), (f): the spawned ranks' join limit


class StepLaunches:
    """Wraps a Trainer's step function: the kernels' launches of each step
    call, by BN mode ("trainbn" with batch statistics, else "infbn"). A
    wrapper counts when it launches, on the host, so no sync is needed."""

    def __init__(self, trainer):
        self.by_mode: dict = {}
        real = trainer._step_fn

        def step_fn(ph, **kw):
            fn = real(ph, **kw)

            def run(*args):
                before = _build.launch_counts()
                out = fn(*args)
                got = _build.card_launches_since(before, PER_FORWARD)
                self.by_mode.setdefault("trainbn" if ph.compute_bn_mean_var else "infbn", []).append(got)
                return out
            return run

        trainer._step_fn = step_fn

    def per_step(self) -> dict:
        """{mode: counts of one step}; raises if the steps of a mode differ."""
        out = {}
        for mode, steps in self.by_mode.items():
            if any(s != steps[0] for s in steps):
                raise AssertionError(f"launches differ from step to step [{mode}]: {steps}")
            out[mode] = steps[0]
        return out


def dp_phases(batch: int) -> tuple:
    from roomnet_tpu_torch.train.loop import Phase

    return (Phase(until_step=3, batch_size=batch, compute_bn_mean_var=True, update_bn_moving=True),
            Phase(until_step=1 << 62, batch_size=batch))


def dp_rank(rank: int, world: int, backend: str, devices: list, store: str, jobs: list, out_dir: str) -> None:
    """One spawned rank of phase 10 (b), (c) and (f): each job (name,
    TrainConfig, steps) as `Trainer(tc, f32, mesh=make_mesh()).train(steps)`
    under cuDNN's deterministic algorithms; writes {name: state, per-step
    launches, stdout} to out_dir/rank{rank}.pkl."""
    import io
    import pickle

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from roomnet_tpu_torch.models.roomnet import DEFAULT_CONFIG
    from roomnet_tpu_torch.parallel import distributed
    from roomnet_tpu_torch.parallel.mesh import make_mesh
    from roomnet_tpu_torch.train.loop import Trainer

    distributed.initialize(f"file://{store}", world, rank, backend=backend, device=devices[rank], timeout_s=300.0)
    results = {}
    try:
        for name, tc, steps in jobs:
            tr = Trainer(tc, DEFAULT_CONFIG, mesh=make_mesh())
            probe = StepLaunches(tr)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with deterministic(), contextlib.redirect_stdout(buf):
                state = tr.train(total_steps=steps)
            results[name] = {"state": {k: v.detach().cpu().numpy() for k, v in state_tensors(state).items()},
                             "launches": probe.per_step(), "stdout": buf.getvalue(),
                             "wall_s": time.perf_counter() - t0}
    finally:
        distributed.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def spawn_ranks(backend: str, devices: list, jobs: list, root: str, fn=None, join_s: float = DP_JOIN_S) -> list:
    """Run `jobs` on len(devices) spawned ranks (`fn`, default dp_rank);
    each rank's results, by rank. Raises if a rank fails or the join
    outlasts join_s; every rank is stopped before it returns."""
    import pickle

    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="ranks_", dir=root)
    store = os.path.join(out_dir, "pg_store")
    ctx = mp.start_processes(fn or dp_rank, args=(len(devices), backend, devices, store, jobs, out_dir),
                             nprocs=len(devices), join=False, start_method="spawn")
    deadline = time.perf_counter() + join_s
    try:
        while not ctx.join(timeout=5.0):
            if time.perf_counter() > deadline:
                raise AssertionError(f"the {len(devices)} spawned ranks did not finish in {join_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(len(devices)):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def param_gap(got: dict, want: dict) -> tuple[float, str]:
    """The largest |d| / (1 + |want|) over the params, BN stats and step (the
    measure state_gap holds to its tol), and the tensor where it is."""
    return max((float((np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k]))
                       / (1.0 + np.abs(np.asarray(want[k], np.float64)))).max()), k)
               for k in want if not k.startswith("opt/"))


def moment_share(got: dict, want: dict) -> float:
    """The largest |d| of an Adam moment over its tensor's largest |value|."""
    return max(float(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k])).max()
                     / max(float(np.abs(np.asarray(want[k])).max()), 1e-30))
               for k in want if k.startswith(("opt/mu/", "opt/nu/")))


def phase10(variables, cfgs, counts, start_counts, dev, smi) -> dict:
    """Scale-out (docstring phase 10). Returns its numbers, and under
    "launches" the counts of its mesh runs in this process: f32 (a)'s
    Trainer, bf16 (e)'s mesh windows."""
    import io

    import torch.distributed as dist

    from roomnet_tpu_torch.data.dataset import extract_fpaths
    from roomnet_tpu_torch.parallel import distributed
    from roomnet_tpu_torch.parallel.mesh import make_mesh
    from roomnet_tpu_torch.params.checkpoint import CheckpointStore
    from roomnet_tpu_torch.params.orbax_io import OrbaxCheckpointStore
    from roomnet_tpu_torch.params.schema import flatten_variables
    from roomnet_tpu_torch.train.loop import TrainConfig, Trainer
    from roomnet_tpu_torch.train.step import TrainHParams, init_train_state, make_train_step
    from tools.make_synth_dataset import generate

    t_phase = time.perf_counter()
    result = {"card": smi, "launches": {}}
    nccl_cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as root:
        data = os.path.join(root, "data")
        with contextlib.redirect_stdout(io.StringIO()):
            generate(data, per_class=20, seed=1)
        lists = {"train_list_fpath": os.path.join(root, "train_list.txt"),
                 "val_list_fpath": os.path.join(root, "val_list.txt"),
                 "label_mappings_fpath": os.path.join(root, "label_mappings.json")}
        extract_fpaths(data, *lists.values(), seed=0)

        def config(name: str, batch: int, *, step0: bool = True, **kw) -> TrainConfig:
            tc = TrainConfig(data_dir=data, stats_fpath=os.path.join(root, f"stats_{name}.json"),
                             model_dir=os.path.join(root, f"models_{name}"), phases=dp_phases(batch), save_freq=5,
                             stall_timeout_s=0, **lists, **kw)
            if step0:
                CheckpointStore(tc.model_dir).save(variables, 0)  # the converted weights at step 0
            return tc

        def stats(tc) -> list:
            with open(tc.stats_fpath) as f:
                return json.load(f)

        # (a) A world of one over NCCL: the mesh adds nothing to the math.
        distributed.start_single(dev)
        if dist.get_backend() != "nccl":
            raise AssertionError(f"scale-out (a): the world of one runs {dist.get_backend()}, not nccl")
        mesh = make_mesh()
        tc_plain, tc_mesh = config("a_plain", 45), config("a_mesh", 45)
        with deterministic(), contextlib.redirect_stdout(io.StringIO()):
            plain = state_tensors(Trainer(tc_plain, cfgs["f32"]).train(total_steps=DP_STEPS))
            tr = Trainer(tc_mesh, cfgs["f32"], mesh=mesh)
            probe = StepLaunches(tr)
            start_counts()
            meshed = state_tensors(tr.train(total_steps=DP_STEPS))
            got = counts()
        want = {"conv3x3": 70, "relu6_pool_bn": 70, "residual_bn": 21, "dense_head": 4}
        if got != want:
            raise AssertionError(f"scale-out (a): launches {got} != {want} (3 batch-stat steps, 3 inference-BN "
                                 "steps, 1 validation forward)")
        gap = state_gap(meshed, plain, 0.0)
        if stats(tc_mesh) != stats(tc_plain):
            raise AssertionError(f"scale-out (a): stats {stats(tc_mesh)} != {stats(tc_plain)}")
        result["launches"]["f32"] = got
        result["world_of_one"] = {"backend": "nccl", "max_abs_d": gap, "launches": got,
                                  "per_step": probe.per_step(), "step5_accuracy": stats(tc_mesh)[0]["accuracy"]}
        log(f"scale-out (a) world of one over NCCL, f32 batch 45, {DP_STEPS} steps (3 batch-stat, 3 inference BN): "
            f"Trainer(mesh=make_mesh()) vs Trainer() max |d| {gap:.3g} (params, BN stats, Adam; gate 0), equal "
            f"stats at step 5; launches {got}, per step {probe.per_step()}")
        del tr

        # (c), first half: the DCP store on the card, and a one-rank checkpoint.
        store = OrbaxCheckpointStore(os.path.join(root, "c_store"), async_save=True)
        t0 = time.perf_counter()
        store.save(variables, 0, suffix="0.5")
        t_issue = time.perf_counter() - t0
        store.wait()
        t_save = time.perf_counter() - t0
        loaded, step = store.load()
        want_flat = flatten_variables(variables)
        if step != 0 or set(loaded) != set(want_flat) or any(
                not np.array_equal(loaded[k], want_flat[k]) for k in want_flat):
            raise AssertionError("scale-out (c): the DCP store's load differs from its async save")
        tc_one = config("c_resume", 46, ckpt_backend="orbax")
        with deterministic(), contextlib.redirect_stdout(io.StringIO()):
            Trainer(tc_one, cfgs["f32"]).train(total_steps=DP_STEPS)
        if [s for s, _, _ in OrbaxCheckpointStore(tc_one.model_dir).list_checkpoints()] != [5]:
            raise AssertionError("scale-out (c): no one-rank DCP checkpoint at step 5")

        # (b) Two ranks spawned on the one card over gloo (NCCL refuses two
        # ranks on one device), replicated then sharded feed, against one
        # process at the same global batch (46: 45 rounded up to the data axis).
        # The floor: one process on the same batches with their rows reversed,
        # which changes no math, only the order of every sum over rows.
        from roomnet_tpu_torch.data import loader

        def host(state) -> dict:
            return {k: v.detach().cpu().numpy() for k, v in state_tensors(state).items()}

        with deterministic(), contextlib.redirect_stdout(io.StringIO()):
            one = host(Trainer(config("b_one", 46), cfgs["f32"]).train(total_steps=DP_STEPS))
            real_dequeue = loader.TrainFeeder.dequeue

            def reversed_rows(feeder):
                x, y = real_dequeue(feeder)
                return (x[::-1].copy(), y[::-1].copy()) if feeder.shuffle else (x, y)

            loader.TrainFeeder.dequeue = reversed_rows
            try:
                rev = host(Trainer(config("b_rev", 46), cfgs["f32"]).train(total_steps=DP_STEPS))
            finally:
                loader.TrainFeeder.dequeue = real_dequeue
        floor, floor_at = param_gap(rev, one)
        gates = {"params": max(DP_TOL, DP_FLOOR_TIMES * floor),
                 "moments": max(DP_MOMENT_SHARE, DP_FLOOR_TIMES * moment_share(rev, one))}
        result["reorder_floor"] = {"param_gap": floor, "at": floor_at, "moment_share": moment_share(rev, one),
                                   "gates": gates}
        log(f"scale-out (b) floor: one process, rows reversed, vs one process: params and BN stats "
            f"{floor:.3g} (|d| / (1 + |want|), at {floor_at}), Adam moments {moment_share(rev, one):.3g} of their "
            "largest")
        jobs = [("replicated", config("b_rep", 46), DP_STEPS),
                ("sharded", config("b_shard", 46, feed_mode="sharded"), DP_STEPS),
                ("resume", config("c_resume", 46, step0=False, ckpt_backend="orbax"), DP_STEPS)]
        t0 = time.perf_counter()
        ranks = spawn_ranks("gloo", ["cuda:0", "cuda:0"], jobs, root)
        spawn_s = time.perf_counter() - t0

        def check_ranks(ranks, what: str) -> dict:
            out = {}
            for feed in ("replicated", "sharded"):
                if feed not in ranks[0]:
                    continue
                a, b = ranks[0][feed], ranks[1][feed]
                gap, at = param_gap(a["state"], one)
                share = moment_share(a["state"], one)
                log(f"scale-out {what} [{feed}]: vs one process, params and BN stats {gap:.3g} (at {at}), Adam "
                    f"moments {share:.3g} of their largest")
                if any(not np.array_equal(a["state"][k], b["state"][k]) for k in a["state"]):
                    raise AssertionError(f"scale-out {what} [{feed}]: the ranks' states differ")
                if not gap <= gates["params"]:
                    raise AssertionError(f"scale-out {what} [{feed}]: params {gap:.3g} from one process at {at} "
                                         f"(> {gates['params']:.3g})")
                if not share <= gates["moments"]:
                    raise AssertionError(f"scale-out {what} [{feed}]: Adam moments {share:.3g} of their largest from "
                                         f"one process (> {gates['moments']:.3g})")
                per = a["launches"]
                want_per = {"trainbn": {"conv3x3": 10, "relu6_pool_bn": 10, "residual_bn": 3, "dense_head": 0},
                            "infbn": {"conv3x3": 10, "relu6_pool_bn": 10, "residual_bn": 3, "dense_head": 1}}
                if per != want_per or b["launches"] != want_per:
                    raise AssertionError(f"scale-out {what} [{feed}]: launches per rank per step {per}, "
                                         f"{b['launches']} != {want_per}")
                out[feed] = {"param_gap": gap, "at": at, "moment_share": share, "launches_per_rank_step": per,
                             "wall_s": a["wall_s"]}
            return out

        result["two_ranks_gloo"] = check_ranks(ranks, "(b)")
        result["two_ranks_gloo"]["spawn_s"] = spawn_s
        for feed, r in result["two_ranks_gloo"].items():
            if feed != "spawn_s":
                log(f"scale-out (b) two ranks on one card over gloo [{feed} feed], f32 batch 46 (23 rows a rank), "
                    f"{DP_STEPS} steps: vs one process {r['param_gap']:.3g} (params, BN stats; gate "
                    f"{gates['params']:.3g}), Adam moments {r['moment_share']:.3g} of their largest (gate "
                    f"{gates['moments']:.3g}); launches per rank per step "
                    f"{r['launches_per_rank_step']}; {r['wall_s']:.1f} s on rank 0")

        # (c), second half: the two ranks resumed the one-rank checkpoint
        # (step 5) and saved step 10 collectively; one process resumes that.
        res = ranks[0]["resume"]
        if "Model restored at step 5" not in res["stdout"] or int(res["state"]["meta/step"]) != 5 + DP_STEPS:
            raise AssertionError(f"scale-out (c): the two ranks did not resume step 5\n{res['stdout'][-600:]}")
        ckpts = [s for s, _, _ in OrbaxCheckpointStore(tc_one.model_dir).list_checkpoints()]
        back = Trainer(config("c_resume", 46, step0=False, ckpt_backend="orbax"), cfgs["f32"]).init_state()
        if ckpts != [5, 10] or int(back.step) != 10:
            raise AssertionError(f"scale-out (c): checkpoints {ckpts}, resumed at step {int(back.step)}")
        result["dcp"] = {"async_issue_s": t_issue, "async_save_s": t_save, "checkpoints": ckpts,
                         "files": sorted(os.listdir(OrbaxCheckpointStore(tc_one.model_dir).latest_path()))}
        log(f"scale-out (c) DCP store on the card: async save issued in {t_issue * 1e3:.1f} ms, landed in "
            f"{t_save * 1e3:.1f} ms, load equal; one rank saved step 5, two ranks resumed it and saved step 10 "
            f"({', '.join(result['dcp']['files'])}), one process resumed step 10")

        # (d) The CLI, as a user runs it: train --data-parallel --ckpt-backend orbax.
        cli_dir = os.path.join(root, "cli")
        os.makedirs(cli_dir)
        repo = str(pathlib.Path(__file__).resolve().parent)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "roomnet_tpu_torch", "train", "--data-dir", data, "--steps", "6",
                               "--save-freq", "5", "--model-dir", "m", "--data-parallel", "--ckpt-backend", "orbax"],
                              cwd=cli_dir, env=env, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        cli_ckpts = [s for s, _, _ in OrbaxCheckpointStore(os.path.join(cli_dir, "m")).list_checkpoints()]
        if proc.returncode != 0 or cli_ckpts != [5]:
            raise AssertionError(f"train --data-parallel --ckpt-backend orbax: exit {proc.returncode}, checkpoints "
                                 f"{cli_ckpts}\n{proc.stderr[-2000:]}")
        result["cli"] = {"wall_s": cli_s, "checkpoints": cli_ckpts}
        log(f"scale-out (d) python -m roomnet_tpu_torch train --data-parallel --ckpt-backend orbax --steps 6: exit 0, "
            f"a DCP checkpoint at step 5 ({cli_s:.1f} s with the interpreter's start)")

        # (f) Only with two cards: (b) over NCCL across them.
        if nccl_cards >= 2:
            ranks = spawn_ranks("nccl", ["cuda:0", "cuda:1"], [("replicated", config("f_rep", 46), DP_STEPS)], root)
            result["two_cards_nccl"] = check_ranks(ranks, "(f)")
            r = result["two_cards_nccl"]["replicated"]
            log(f"scale-out (f) two ranks on two cards over NCCL [replicated feed], f32 batch 46, {DP_STEPS} steps: vs "
                f"one process {r['param_gap']:.3g} (gate {gates['params']:.3g}), Adam moments {r['moment_share']:.3g} "
                f"(gate {gates['moments']:.3g}); launches per rank per step {r['launches_per_rank_step']}; "
                f"{r['wall_s']:.1f} s on rank 0")

    # (e) bf16 ms per step at batch 45, without and with the mesh in the world
    # of one, in turns; nothing claimed.
    x45 = torch.from_numpy(np.random.RandomState(45).randint(0, 256, (45, 224, 224, 3), dtype=np.uint8)).to(dev)
    y45 = torch.arange(45, device=dev, dtype=torch.int32) % 6
    times, per_step = {}, {}
    mesh_launches = dict.fromkeys(counts(), 0)
    start_counts()
    for mode, hp in (("infbn", TrainHParams()),
                     ("trainbn", TrainHParams(compute_bn_mean_var=True, update_bn_moving=True))):
        steps = {"plain": make_train_step(hp, cfgs["bf16"]), "mesh": make_train_step(hp, cfgs["bf16"],
                                                                                      group=mesh.group("data"))}
        states = {k: init_train_state(variables, hp) for k in steps}
        gen = torch.Generator(dev).manual_seed(1)
        for k in steps:  # warm-up
            states[k], m = steps[k](states[k], x45, y45, gen)
        torch.cuda.synchronize()
        times[mode] = {k: [] for k in steps}
        for k in DP_WINDOWS:
            before = counts()
            t0 = time.perf_counter()
            for _ in range(DP_TIMED_STEPS):
                states[k], m = steps[k](states[k], x45, y45, gen)
            float(m["loss"])
            times[mode][k].append((time.perf_counter() - t0) * 1e3 / DP_TIMED_STEPS)
            if k == "mesh":
                got = {n: c - before[n] for n, c in counts().items()}
                per_step[mode] = {n: c // DP_TIMED_STEPS for n, c in got.items()}
                mesh_launches = {n: mesh_launches[n] + c for n, c in got.items()}
        del states
    result["launches"]["bf16"] = mesh_launches
    distributed.shutdown()
    result["step_ms"] = {"card": smi, "batch": 45, "dtype": "bf16", "windows": list(DP_WINDOWS),
                         "steps_per_window": DP_TIMED_STEPS, "ms": times, "per_step_launches": per_step}
    for mode, t in times.items():
        log(f"scale-out (e) bf16 batch 45 [{mode}, {smi}], ms per step (host clock, {DP_TIMED_STEPS} steps a window, "
            f"windows {' '.join(DP_WINDOWS)}): no mesh " + " / ".join(f"{v:.3f}" for v in t["plain"])
            + ", mesh (world of one, NCCL) " + " / ".join(f"{v:.3f}" for v in t["mesh"])
            + f"; launches per mesh step {per_step[mode]}")
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"scale-out: phase 10 took {result['wall_s']:.1f} s")
    return result


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


def phase8(variables, cfgs, gw, wide_logits, x256_u8, counts, start_counts, per_forward, dev, smi) -> dict:
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
                                      (tf_ids, want_probs), x256_u8, counts, start_counts, per_forward, dev,
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


def serve_checks(dt, cfg, variables, trees, dirs, requests, golden, x256_u8, counts, start_counts, per_forward,
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

        start_counts()
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
        SPANS.reset()  # the spans of the timed requests only; no launch count spans this
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



# -- phase 11: the server on a mesh ----------------------------------------------
MESH_BATCH = 32  # the serve CLI's default batch size
MESH_DRAIN_S = 2.0  # (b): the ranks' drain window at SIGTERM
MESH_RELOAD_STEPS = (12, 13)  # (b): a second seeded tree, then a NaN tree
MESH_SEQ = 50  # (e): sequential /classify requests a turn
MESH_TURNS = ("plain", "mesh", "mesh", "plain")  # (e): turns
MESH_JOIN_S = 420.0  # (b), (d): the spawned ranks' join limit


def mesh_requests(seed: int = 11, n_batch: int = 5, n_stream: int = 40) -> dict:
    """The requests of phase 11, the same in every run: {"single": a body,
    "batch": n_batch bodies, "stream": n_stream bodies}, PNGs of 240x320
    tools/make_synth_dataset.make_image images (class i mod 6) drawn from
    RandomState(seed)."""
    from tools.make_synth_dataset import make_image

    rng = np.random.RandomState(seed)
    bodies = [png_bytes(make_image(i % 6, rng, 240, 320)[:, :, ::-1]) for i in range(1 + n_batch + n_stream)]
    return {"single": bodies[0], "batch": bodies[1:1 + n_batch], "stream": bodies[1 + n_batch:]}


def classify_requests(port: int, requests: dict) -> dict:
    """One /classify, one /classify_batch and one /classify_batch?stream=1
    of `requests`: {name: (status, the result, the results or the NDJSON
    lines)}; a request that cannot connect gives (None, the error)."""
    import base64

    def batch(bodies) -> bytes:
        return json.dumps({"images": [base64.b64encode(b).decode() for b in bodies]}).encode()

    out = {}
    for name, path, body in (("single", "/classify", requests["single"]),
                             ("batch", "/classify_batch", batch(requests["batch"])),
                             ("stream", "/classify_batch?stream=1", batch(requests["stream"]))):
        try:
            status, data = http_request(port, "POST", path, body)
        except OSError as e:
            out[name] = (None, repr(e))
            continue
        if status == 200 and name == "stream":
            got = [json.loads(line) for line in data.splitlines()]
        else:
            got = json.loads(data) if data else None
            if status == 200 and name == "batch":
                got = got["results"]
        out[name] = (status, got)
    return out


def answers_gap(got: dict, want: dict, where: str) -> tuple[float, bool]:
    """(max |dprob|, every class_id equal) of two classify_requests results
    over every image; raises unless every request of both answered 200 with
    one result per image."""
    err, same = 0.0, True
    for name in ("single", "batch", "stream"):
        (gs, g), (ws, w) = got[name], want[name]
        if gs != 200 or ws != 200:
            raise AssertionError(f"{where} {name}: status {gs} against {ws}: {str(g)[:300]}")
        g, w = ([g], [w]) if name == "single" else (g, w)
        if len(g) != len(w) or any("probs" not in r for r in g + w):
            raise AssertionError(f"{where} {name}: {len(g)} results against {len(w)}, or one without probs")
        for a, b in zip(g, w):
            err = max(err, float(np.abs(np.asarray(a["probs"]) - np.asarray(b["probs"])).max()))
            same &= a["class_id"] == b["class_id"]
    return err, bool(same)


def count_predicts(clf) -> list:
    """Wraps the classifier's `_predict`: the batch size of each call is
    appended to the returned list."""
    sizes, predict = [], clf._predict

    def counted(variables, x):
        sizes.append(int(x.shape[0]))
        return predict(variables, x)

    clf._predict = counted
    return sizes


def mesh_serve(clf, requests: dict, *, model_dir: str | None = None, reloads=(), drain_s: float = MESH_DRAIN_S,
               ready_s: float = 300.0) -> dict:
    """One rank of a mesh server, as each rank of `serve --data-parallel`
    runs it: `ClassifierServer(clf, port=0, warmup=True, model_dir=...,
    drain_s=...).serve_forever()`. Rank 0 drives it from a client thread:
    /readyz until 200, `requests` (classify_requests), then for each
    (step, variables) of `reloads` a save into model_dir at that step (the
    port's CheckpointStore), POST /reload, /version and the requests again;
    then SIGTERM to its own process, which drains and stops every rank.
    Returns {"rc" or "error", "sizes": the batch size of each `_predict`
    call, "launches": the kernels' over them, "buckets", "model_version",
    "variables": the serving tree as numpy, "serve_s", and on rank 0
    "client"}."""
    import signal
    import threading

    from roomnet_tpu_torch.infer.server import ClassifierServer
    from roomnet_tpu_torch.params.checkpoint import CheckpointStore
    from roomnet_tpu_torch.params.schema import flatten_variables

    before = _build.launch_counts()
    sizes = count_predicts(clf)
    srv = ClassifierServer(clf, port=0, warmup=True, max_inflight=64, model_dir=model_dir, drain_s=drain_s)
    client: dict = {}

    def drive():
        try:
            deadline = time.perf_counter() + ready_s
            while srv.port == 0 or http_json(srv.port, "GET", "/readyz")[0] != 200:
                if time.perf_counter() > deadline:
                    raise AssertionError("the mesh server never became ready")
                time.sleep(0.05)
            client["initial"] = classify_requests(srv.port, requests)
            client["reloads"] = []
            for step, variables in reloads:
                CheckpointStore(model_dir).save(variables, step, suffix="mesh")
                status, reply = http_json(srv.port, "POST", "/reload")
                client["reloads"].append({"step": step, "status": status, "reply": reply,
                                          "version": http_json(srv.port, "GET", "/version")[1],
                                          "answers": classify_requests(srv.port, requests)})
        except Exception as e:  # noqa: BLE001 — the record says what failed
            client["error"] = f"{type(e).__name__}: {e}"
        finally:
            if not srv._stop.is_set():  # a failed mesh stops by itself
                os.kill(os.getpid(), signal.SIGTERM)

    thread = threading.Thread(target=drive, daemon=True) if srv.rank == 0 else None
    if thread is not None:
        thread.start()
    out = {"rank": srv.rank, "buckets": srv._bucket_sizes}
    t0 = time.perf_counter()
    try:
        out["rc"] = srv.serve_forever()
    except RuntimeError as e:
        out["error"] = f"{e}: {e.__cause__!r}"
    out["serve_s"] = time.perf_counter() - t0
    if thread is not None:
        thread.join(60.0)
        out["client"] = client
    since = _build.card_launches_since if clf.device.type == "cuda" else _build.launches_since
    out.update(sizes=list(sizes), launches=since(before, PER_FORWARD),
               model_version=dict(srv.model_version), variables=flatten_variables(clf.variables))
    return out


def mesh_serve_rank(rank: int, world: int, backend: str, devices: list, store: str, jobs: list,
                    out_dir: str) -> None:
    """One spawned rank of phase 11 (b) and (d): each job (name, config, flat
    weights, requests, model dir, reloads as (step, flat)) as `mesh_serve`
    of a batch-MESH_BATCH classifier on a mesh over the world; writes {name:
    result} to out_dir/rank{rank}.pkl."""
    import pickle

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from roomnet_tpu_torch.infer.classify import RoomNetClassifier
    from roomnet_tpu_torch.parallel import distributed
    from roomnet_tpu_torch.parallel.mesh import make_mesh
    from roomnet_tpu_torch.params.schema import variables_from_numpy

    distributed.initialize(f"file://{store}", world, rank, backend=backend, device=devices[rank], timeout_s=120.0)
    results = {}
    try:
        for name, cfg, flat, requests, model_dir, reloads in jobs:
            clf = RoomNetClassifier(variables_from_numpy(flat, cfg, devices[rank]), cfg, batch_size=MESH_BATCH,
                                    mesh=make_mesh())
            try:
                results[name] = mesh_serve(clf, requests, model_dir=model_dir, reloads=[
                    (step, variables_from_numpy(f, cfg, "cpu")) for step, f in reloads])
            finally:
                clf.close()
    finally:
        distributed.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def descendants(pid: int) -> list:
    """The pids of every process below `pid`, from /proc (a launcher may
    start its workers from any thread, in sessions of their own)."""
    children = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                stat = pathlib.Path(f"/proc/{d}/stat").read_text()
            except OSError:
                continue
            children.setdefault(int(stat.rsplit(")", 1)[1].split()[1]), []).append(int(d))
    out, todo = [], [pid]
    while todo:
        for c in children.get(todo.pop(), []):
            out.append(c)
            todo.append(c)
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase11(variables, cfgs, counts, start_counts, per_forward, dev, smi) -> dict:
    """The server on a mesh (docstring phase 11). Returns its numbers, and
    under "launches" the counts of (a)'s world-of-one requests by dtype."""
    import signal
    import urllib.request

    import torch.distributed as dist

    from roomnet_tpu_torch.infer.classify import RoomNetClassifier
    from roomnet_tpu_torch.infer.server import ClassifierServer
    from roomnet_tpu_torch.models.roomnet import init_variables
    from roomnet_tpu_torch.parallel import distributed
    from roomnet_tpu_torch.parallel.mesh import make_mesh
    from roomnet_tpu_torch.params import schema

    t_phase = time.perf_counter()
    result = {"card": smi, "launches": {}}
    requests = mesh_requests()
    n_images = 1 + len(requests["batch"]) + len(requests["stream"])
    flat = schema.flatten_variables(variables)
    second = schema.flatten_variables(init_variables(torch.Generator().manual_seed(12), cfgs["f32"]))
    nan = dict(flat, **{"dense/0/kernel": np.full_like(flat["dense/0/kernel"], np.nan)})

    def server(dt: str, tree, mesh=None):
        clf = RoomNetClassifier(tree, cfgs[dt], batch_size=MESH_BATCH, device=dev, mesh=mesh)
        return ClassifierServer(clf, port=0, warmup=True, max_inflight=64).start()

    def close(srv):
        srv.stop()
        srv.classifier.close()

    # The one-process server's answers: the reference of (a), (b) and (d).
    plain = {}
    trees = {"converted": variables, "second": schema.variables_from_numpy(second, cfgs["f32"], dev)}
    for dt in cfgs:
        for tree_name, tree in trees.items():
            srv = server(dt, tree)
            try:
                plain[(dt, tree_name)] = classify_requests(srv.port, requests)
            finally:
                close(srv)

    # (a) A world of one over NCCL: the mesh server against no mesh.
    distributed.start_single(dev)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"mesh server (a): the world of one runs {dist.get_backend()}, not nccl")
    mesh = make_mesh()
    result["world_of_one"] = {}
    for dt in cfgs:
        srv = server(dt, variables, mesh)
        try:
            sizes = count_predicts(srv.classifier)
            start_counts()
            got = classify_requests(srv.port, requests)
            launches = counts()
        finally:
            close(srv)
        gap, same = answers_gap(got, plain[(dt, "converted")], f"mesh server (a) [{dt}]")
        want = {n: c * len(sizes) for n, c in per_forward.items()}
        if gap != 0.0 or not same or srv._bucket_sizes != [1, 2, 4, 8, 16, 32] or launches != want:
            raise AssertionError(f"mesh server (a) [{dt}]: max |dprob| {gap:.3g} (gate 0), class_id equal {same}, "
                                 f"buckets {srv._bucket_sizes}, launches {launches} != {want}")
        result["launches"][dt] = launches
        result["world_of_one"][dt] = {"max_abs_dprob": gap, "buckets": srv._bucket_sizes, "calls": sizes,
                                      "launches": launches}
        log(f"mesh server (a) world of one over NCCL [{dt}], batch {MESH_BATCH}: {n_images} images through /classify, "
            f"/classify_batch and ?stream=1 against the one-process server: max |dprob| {gap:.3g} (gate 0), class_id "
            f"equal; buckets {srv._bucket_sizes}; device calls {sizes}, launches {launches} (10/10/3/1 each)")

    # (e) Times, bf16, nothing claimed: the one-process server against the
    # world-of-one mesh server, in turns.
    servers = {"plain": server("bf16", variables), "mesh": server("bf16", variables, mesh)}
    try:
        import http.client

        seq = {k: [] for k in servers}
        burst = {k: [] for k in servers}
        pool = ThreadPoolExecutor(BURST)
        try:
            for k in MESH_TURNS:
                port = servers[k].port
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
                for _ in range(MESH_SEQ):
                    t0 = time.perf_counter()
                    status, _ = http_request(port, "POST", "/classify", requests["single"], conn)
                    seq[k].append((time.perf_counter() - t0) * 1e3)
                    if status != 200:
                        raise AssertionError(f"mesh server (e) [{k}]: /classify {status}")
                conn.close()
                t0 = time.perf_counter()
                statuses = list(pool.map(lambda _: http_request(port, "POST", "/classify", requests["single"])[0],
                                         range(BURST)))
                burst[k].append(BURST / (time.perf_counter() - t0))
                if set(statuses) != {200}:
                    raise AssertionError(f"mesh server (e) [{k}]: burst statuses {set(statuses)}")
        finally:
            pool.shutdown()
    finally:
        for srv in servers.values():
            close(srv)
    distributed.shutdown()
    result["times"] = {"card": smi, "dtype": "bf16", "batch": MESH_BATCH, "turns": list(MESH_TURNS),
                       "sequential_p50_ms": {k: float(np.percentile(v, 50)) for k, v in seq.items()},
                       "burst_req_per_s": burst}
    log(f"mesh server (e) [bf16, batch {MESH_BATCH}, {smi}]: sequential /classify p50 (keep-alive, {MESH_SEQ} a "
        f"turn, turns {' '.join(MESH_TURNS)}) no mesh {result['times']['sequential_p50_ms']['plain']:.3f} ms, world "
        f"of one {result['times']['sequential_p50_ms']['mesh']:.3f} ms; {BURST}-way burst req/s no mesh "
        + " / ".join(f"{v:.1f}" for v in burst["plain"]) + ", world of one "
        + " / ".join(f"{v:.1f}" for v in burst["mesh"]))

    # (b) Two ranks spawned on the one card over gloo; (d) only with two
    # cards, NCCL across them.
    def mesh_runs(backend: str, devices: list, root: str, what: str) -> dict:
        jobs = []
        for dt in cfgs:
            mdir = os.path.join(root, f"models_{what}_{dt}")
            os.makedirs(mdir)
            jobs.append((dt, cfgs[dt], flat, requests, mdir,
                         [(MESH_RELOAD_STEPS[0], second), (MESH_RELOAD_STEPS[1], nan)]))
        t0 = time.perf_counter()
        ranks = spawn_ranks(backend, devices, jobs, root, fn=mesh_serve_rank, join_s=MESH_JOIN_S)
        out = {"spawn_s": time.perf_counter() - t0}
        n_data = len(devices)
        for dt in cfgs:
            r0, r1 = ranks[0][dt], ranks[1][dt]
            c = r0["client"]
            where = f"mesh server {what} [{dt}]"
            if "error" in c or r0.get("rc") != 0 or r1.get("rc") != 0:
                raise AssertionError(f"{where}: client {c.get('error')}, rank 0 {r0.get('rc', r0.get('error'))}, "
                                     f"rank 1 {r1.get('rc', r1.get('error'))}")
            buckets = [n_data * 2 ** i for i in range(6) if n_data * 2 ** i < MESH_BATCH] + [MESH_BATCH]
            if r0["buckets"] != buckets or r0["sizes"] != r1["sizes"] or r0["sizes"][len(buckets)] != n_data:
                raise AssertionError(f"{where}: buckets {r0['buckets']} != {buckets}, or the ranks' calls differ "
                                     f"({r0['sizes']} / {r1['sizes']}), or the lone request did not pad to {n_data}")
            for r in (r0, r1):
                want = {n: k * len(r["sizes"]) for n, k in per_forward.items()}
                if r["launches"] != want:
                    raise AssertionError(f"{where}: rank {r['rank']} launches {r['launches']} != {want} for "
                                         f"{len(r['sizes'])} device calls")
            gap, same = answers_gap(c["initial"], plain[(dt, "converted")], where)
            good, bad = c["reloads"]
            if good["status"] != 200 or good["reply"] != {"status": "reloaded", "step": MESH_RELOAD_STEPS[0]}:
                raise AssertionError(f"{where}: /reload of the second tree: {good['status']} {good['reply']}")
            gap2, same2 = answers_gap(good["answers"], plain[(dt, "second")], where + " after /reload")
            if bad["status"] != 409 or "non-finite" not in bad["reply"]["error"]:
                raise AssertionError(f"{where}: /reload of a NaN tree: {bad['status']} {bad['reply']}")
            kept, _ = answers_gap(bad["answers"], good["answers"], where + " after the NaN /reload")
            for r in (r0, r1):
                if r["model_version"]["step"] != MESH_RELOAD_STEPS[0] or any(
                        not np.array_equal(r["variables"][k], second[k]) for k in second):
                    raise AssertionError(f"{where}: rank {r['rank']} serves step {r['model_version']['step']}, or "
                                         "not the second tree, after the NaN reload")
            f32 = dt == "f32"
            if not (same and same2) or (f32 and max(gap, gap2) > 1e-5) or kept > 1e-6:
                raise AssertionError(f"{where}: class_id equal {same} / {same2}, max |dprob| {gap:.3g} / {gap2:.3g} "
                                     f"(f32 gate 1e-5), {kept:.3g} after the NaN reload")
            per_call = {n: k // len(r0["sizes"]) for n, k in r0["launches"].items()}
            out[dt] = {"max_abs_dprob": gap, "after_reload_max_abs_dprob": gap2, "after_nan_max_abs_dprob": kept,
                       "buckets": r0["buckets"], "calls": r0["sizes"], "launches_per_rank_call": per_call,
                       "nan_reload": bad["reply"]["error"][:120], "serve_s": [r0["serve_s"], r1["serve_s"]]}
            log(f"{where}, batch {MESH_BATCH}: buckets {r0['buckets']}, the lone request padded to {n_data}; "
                f"{n_images} images against the one-process server: max |dprob| {gap:.3g}, class_id equal; /reload "
                f"step {MESH_RELOAD_STEPS[0]} on both ranks, then {gap2:.3g} from a one-process server on that tree; "
                f"NaN tree 409, both ranks kept step {MESH_RELOAD_STEPS[0]} (answers moved {kept:.3g}); SIGTERM with "
                f"--drain {MESH_DRAIN_S:g}: both ranks 0; {len(r0['sizes'])} device calls a rank, launches per rank "
                f"per call {per_call}")
        return out

    nccl_cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as root:
        result["two_ranks_gloo"] = mesh_runs("gloo", ["cuda:0", "cuda:0"], root, "(b)")
        if nccl_cards >= 2:
            result["two_cards_nccl"] = mesh_runs("nccl", ["cuda:0", "cuda:1"], root, "(d)")

    # (c) The CLI, as a user launches it.
    port, profile_port = free_port(), free_port()
    repo = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (str(repo), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1", "-m",
                             "roomnet_tpu_torch", "serve", "--data-parallel", "--port", str(port), "--profile-port",
                             str(profile_port)],
                            cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def kill_all():  # torchrun and every process below it
        for pid in descendants(proc.pid) + [proc.pid]:
            with contextlib.suppress(OSError):
                os.kill(pid, signal.SIGKILL)

    try:
        deadline = time.perf_counter() + 300
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=10) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            if proc.poll() is not None or time.perf_counter() > deadline:
                kill_all()
                raise AssertionError(f"serve --data-parallel never answered /readyz 200 in "
                                     f"{time.perf_counter() - t0:.1f} s (exit {proc.poll()}):\n"
                                     f"{proc.communicate()[0][-2000:]}")
            time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        status, answer = http_json(port, "POST", "/classify", requests["single"])
        if status != 200 or answer["class_id"] != plain[("bf16", "converted")]["single"][1]["class_id"]:
            raise AssertionError(f"serve --data-parallel /classify: {status} {answer}")
        # --profile-port: a one-second capture of the live daemon, requests
        # sent until it returns, holds the worker thread's spans and the
        # card's kernels.
        with ThreadPoolExecutor(1) as ex:
            capture = ex.submit(lambda: json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{profile_port}/capture?seconds=1", timeout=120).read()))
            sent = 0
            while not capture.done():
                http_request(port, "POST", "/classify", requests["single"])
                sent += 1
            trace_path = capture.result()["trace"]
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        shutil.rmtree(os.path.dirname(os.path.dirname(trace_path)), ignore_errors=True)
        captured = {"requests": sent, "serve/device_call": sum(e.get("name") == "serve/device_call" for e in events),
                    "kernel": sum(e.get("cat") == "kernel" for e in events)}
        if not (captured["serve/device_call"] and captured["kernel"]):
            cats = sorted({str(e.get("cat")) for e in events})
            raise AssertionError(f"serve --profile-port: the capture holds {captured} ({len(events)} events, "
                                 f"categories {cats})")
        # torchrun exits 1 on a signal of its own; the serve rank is below it.
        ranks = descendants(proc.pid)
        for pid in ranks:
            os.kill(pid, signal.SIGTERM)
        out_text = proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None or descendants(proc.pid):
            kill_all()
            out_text = proc.communicate()[0]
    if proc.returncode != 0:
        raise AssertionError(f"serve --data-parallel: exit {proc.returncode}\n{out_text[-2000:]}")
    result["cli"] = {"ready_s": ready_s, "wall_s": time.perf_counter() - t0, "exit": proc.returncode,
                     "capture_events": captured}
    log(f"mesh server (c) torchrun --nproc-per-node 1 -m roomnet_tpu_torch serve --data-parallel --profile-port: "
        f"/readyz 200 after {ready_s:.1f} s (interpreter, build and warmup), /classify 200, a 1 s capture under "
        f"{captured['requests']} requests holds {captured['serve/device_call']} serve/device_call spans and "
        f"{captured['kernel']} kernels, "
        "SIGTERM to the rank: exit 0")
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"mesh server: phase 11 took {result['wall_s']:.1f} s")
    return result


# -- phase 12: tensor parallelism --------------------------------------------------
TP_BATCH = 16  # (a)-(d): the global batch, the same 16 rows in every step
TP_STEPS = 2
# (b)-(d): the state within the larger of tests/test_torch_parallel.py's TOL (params, BN stats; with inference
# BN the Adam moments too) and TP_FLOOR_TIMES the floor, and with batch statistics the Adam moments within the
# larger of its MOMENT_SHARE and TP_FLOOR_TIMES the floor (phase 10 (b)'s rule). The floor, against one
# process: the larger of one process on the same rows reversed and the data-parallel (2, 1) mesh, no leaf
# split. On an H100 they were 6.4e-7 / 5.2e-6 and 1.23e-5 / 4.3e-5 (params / moments) with inference BN, and
# 1.43e-4 / 0.0392 and 7.73e-4 / 0.0286 with batch statistics (PERF.md §6), where some CE gradients are
# small differences of large sums and TF1 Adam's m / sqrt(v) turns their rounding into steps: no limit below
# the floor holds there for any order of summation.
TP_TOL = 1e-4
TP_MOMENT_SHARE = 5e-3
TP_FLOOR_TIMES = 2.0
TP_HP = dict(learn_rate=1e-3)
TP_MODES = {"infbn": {}, "trainbn": dict(compute_bn_mean_var=True, update_bn_moving=True)}
TP_TIMED_STEPS = 20  # (e): steps per timed window
TP_WINDOWS = ("plain", "mesh", "tp", "tp", "mesh", "plain")  # (e): windows in turns
TP_JOIN_S = 420.0  # (b)-(d): the spawned ranks' join limit


@contextlib.contextmanager
def conv_couts(out: list):
    """Appends to `out` the Cout that every conv3x3 CUDA launch in the block
    passes to the kernel (csrc/conv3x3.cu:rn_conv3x3's ninth argument)."""
    real = _build.entry

    def entry(name, symbol, argtypes):
        fn = real(name, symbol, argtypes)
        if symbol != "rn_conv3x3":
            return fn

        def launch(*args):
            out.append(int(args[8]))
            return fn(*args)
        return launch

    _build.entry = entry
    try:
        yield
    finally:
        _build.entry = real


def tp_batch(dev) -> tuple:
    """(a)-(d)'s batch: TP_BATCH uint8 BGR images at 224 and their labels."""
    rng = np.random.RandomState(12)
    return (torch.from_numpy(rng.randint(0, 256, (TP_BATCH, 224, 224, 3), dtype=np.uint8)).to(dev),
            torch.from_numpy(rng.randint(0, 6, (TP_BATCH,)).astype(np.int32)).to(dev))


def tp_steps(variables, mode: str, dev, mesh=None, *, reverse: bool = False) -> dict:
    """TP_STEPS f32 steps of make_train_step(TrainHParams(**TP_HP, mode)) on
    tp_batch, under cuDNN's deterministic algorithms. With a mesh: this
    rank's rows, its slices of the leaves that variables_shardings(...,
    tensor_parallel=True) splits (and of their Adam moments), the step's tp
    over the mesh's 'model' axis. Returns the whole state as numpy (gathered
    over 'model': a collective), this rank's local shapes, and each step's
    launches and conv Couts. `reverse`: the batch's rows in reverse order."""
    from roomnet_tpu_torch.models.roomnet import DEFAULT_CONFIG
    from roomnet_tpu_torch.parallel import tensor as PT
    from roomnet_tpu_torch.parallel.mesh import variables_shardings
    from roomnet_tpu_torch.train.step import TrainHParams, init_train_state, make_train_step

    hp = TrainHParams(**TP_HP, **TP_MODES[mode])
    x, y = tp_batch(dev)
    if reverse:
        x, y = x.flip(0), y.flip(0)
    state = init_train_state(variables, hp)
    group = tp = None
    if mesh is not None:
        n = TP_BATCH // mesh.shape["data"]
        x, y = x[mesh.coords[0] * n:(mesh.coords[0] + 1) * n], y[mesh.coords[0] * n:(mesh.coords[0] + 1) * n]
        shardings = variables_shardings(list(state.train_vars), mesh, tensor_parallel=True)
        state = PT.shard_train_state(state, shardings, mesh)
        group, tp = mesh.group("data"), PT.tensor_parallel(shardings, mesh)
    local = {k: tuple(v.shape) for k, v in state.train_vars.items()}
    local.update({f"opt/mu/{k}": tuple(v.shape) for k, v in state.opt_state.mu.items()})
    step = make_train_step(hp, DEFAULT_CONFIG, group=group, tp=tp)
    launches, couts = [], []
    with deterministic():
        for _ in range(TP_STEPS):
            before = _build.launch_counts()
            c = []
            with conv_couts(c):
                state, metrics = step(state, x, y)
            launches.append(_build.card_launches_since(before, PER_FORWARD))
            couts.append(c)
        loss = float(metrics["loss"])
    if mesh is not None:
        state = PT.unshard_train_state(state, shardings, mesh)
    return {"state": {k: v.detach().cpu().numpy() for k, v in state_tensors(state).items()}, "local": local,
            "launches": launches, "couts": couts, "loss": loss}


def tp_rank(rank: int, world: int, backend: str, devices: list, store: str, jobs: list, out_dir: str) -> None:
    """One spawned rank of phase 12 (b)-(d): each job (name, n_model, mode)
    as tp_steps on an (world // n_model, n_model) mesh of the converted
    weights; writes {name: tp_steps' result} to out_dir/rank{rank}.pkl."""
    import pickle

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from roomnet_tpu_torch.parallel import distributed
    from roomnet_tpu_torch.parallel.mesh import make_mesh
    from roomnet_tpu_torch.params.schema import load_npz

    distributed.initialize(f"file://{store}", world, rank, backend=backend, device=devices[rank], timeout_s=300.0)
    results = {}
    try:
        dev = torch.device(devices[rank])
        variables = load_npz(pathlib.Path(__file__).resolve().parent / "artifacts" / "roomnet_params.npz",
                             device=dev)
        for name, n_model, mode in jobs:
            t0 = time.perf_counter()
            results[name] = tp_steps(variables, mode, dev, make_mesh(world // n_model, n_model))
            results[name]["wall_s"] = time.perf_counter() - t0
    finally:
        distributed.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def tp_gap(got: dict, want: dict, mode: str, gates: dict | None = None) -> dict:
    """got's whole state against want's: the largest |d| / (1 + |want|) of
    the params, BN stats, step and Adam count (param_gap) and the Adam
    moments' largest share (moment_share). With `gates` ({"tol", "share"}),
    "fault" says what lies beyond them (None where nothing does): state_gap
    at gates["tol"] over everything but, with batch statistics, the Adam
    moments, which are held to gates["share"] of each tensor's largest."""
    gap, at = param_gap(got, want)
    out = {"param_gap": gap, "at": at, "moment_share": moment_share(got, want), "fault": None}
    if gates is None:
        return out
    moments = {k for k in want if k.startswith(("opt/mu/", "opt/nu/"))} if mode == "trainbn" else set()
    try:
        state_gap({k: got[k] for k in got if k not in moments}, {k: want[k] for k in want if k not in moments},
                  gates["tol"])
    except AssertionError as e:
        out["fault"] = str(e)
    if moments and out["moment_share"] > gates["share"]:
        out["fault"] = f"Adam moments {out['moment_share']:.3g} of their largest (> {gates['share']:.3g})"
    return out


def phase12(variables, counts, start_counts, dev, smi) -> dict:
    """Tensor parallelism (docstring phase 12). Returns its numbers, and
    under "launches" the per-rank-per-step counts: f32 from (b), bf16 from
    (e)'s mesh windows."""
    import torch.distributed as dist

    from roomnet_tpu_torch.models.roomnet import FAST_CONFIG
    from roomnet_tpu_torch.parallel import distributed
    from roomnet_tpu_torch.parallel import tensor as PT
    from roomnet_tpu_torch.parallel.mesh import make_mesh, variables_shardings
    from roomnet_tpu_torch.train.step import TrainHParams, init_train_state, make_train_step

    t_phase = time.perf_counter()
    result = {"card": smi, "launches": {}}
    per_step = {"infbn": {"conv3x3": 10, "relu6_pool_bn": 10, "residual_bn": 3, "dense_head": 1},
                "trainbn": {"conv3x3": 10, "relu6_pool_bn": 10, "residual_bn": 3, "dense_head": 0}}

    def couts_for(n_model: int) -> list:
        return [8, 32, 32, 32, 64, 64, 128 // n_model, 16, 16, 16]

    def check_launches(run: dict, mode: str, n_model: int, what: str) -> None:
        if run["launches"] != [per_step[mode]] * TP_STEPS:
            raise AssertionError(f"tensor parallel {what} [{mode}]: launches per step {run['launches']} != "
                                 f"{per_step[mode]}")
        if run["couts"] != [couts_for(n_model)] * TP_STEPS:
            raise AssertionError(f"tensor parallel {what} [{mode}]: conv3x3 launches with Cout {run['couts']} != "
                                 f"{couts_for(n_model)} a step")

    one = {mode: tp_steps(variables, mode, dev) for mode in TP_MODES}
    # (a) A world of one over NCCL with tensor_parallel=True: the same bits as no mesh.
    start_counts()
    distributed.start_single(dev)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"tensor parallel (a): the world of one runs {dist.get_backend()}, not nccl")
    mesh = make_mesh()
    result["world_of_one"] = {}
    for mode in TP_MODES:
        run = tp_steps(variables, mode, dev, mesh)
        gap = state_gap(run["state"], one[mode]["state"], 0.0)
        check_launches(run, mode, 1, "(a)")
        result["world_of_one"][mode] = {"max_abs_d": gap, "launches_per_step": run["launches"][0],
                                        "loss": run["loss"], "loss_no_mesh": one[mode]["loss"]}
        log(f"tensor parallel (a) world of one over NCCL, tensor_parallel=True, f32 batch {TP_BATCH}, {TP_STEPS} "
            f"steps [{mode}]: vs no mesh max |d| {gap:.3g} (params, BN stats, Adam; gate 0), loss {run['loss']!r} "
            f"vs {one[mode]['loss']!r}; launches per step {run['launches'][0]}, conv Couts {run['couts'][0]}")

    # (e) bf16 ms per step at batch 45 in turns, nothing claimed: no mesh;
    # the world-of-one mesh, its data group and the TP placements; the TP
    # placements alone (no data group), the TP code path's own cost.
    x45 = torch.from_numpy(np.random.RandomState(45).randint(0, 256, (45, 224, 224, 3), dtype=np.uint8)).to(dev)
    y45 = torch.arange(45, device=dev, dtype=torch.int32) % 6
    times, tp_per_step = {}, {}
    start_counts()
    for mode, extra in TP_MODES.items():
        hp = TrainHParams(**extra)
        base = init_train_state(variables, hp)
        shardings = variables_shardings(list(base.train_vars), mesh, tensor_parallel=True)
        tp = PT.tensor_parallel(shardings, mesh)
        steps = {"plain": make_train_step(hp, FAST_CONFIG),
                 "mesh": make_train_step(hp, FAST_CONFIG, group=mesh.group("data"), tp=tp),
                 "tp": make_train_step(hp, FAST_CONFIG, tp=tp)}
        states = {k: base if k == "plain" else PT.shard_train_state(base, shardings, mesh) for k in steps}
        for k in steps:  # warm-up
            states[k], m = steps[k](states[k], x45, y45)
        torch.cuda.synchronize()
        times[mode] = {k: [] for k in steps}
        for k in TP_WINDOWS:
            before = counts()
            t0 = time.perf_counter()
            for _ in range(TP_TIMED_STEPS):
                states[k], m = steps[k](states[k], x45, y45)
            float(m["loss"])
            times[mode][k].append((time.perf_counter() - t0) * 1e3 / TP_TIMED_STEPS)
            if k == "mesh":
                tp_per_step[mode] = {n: (c - before[n]) // TP_TIMED_STEPS for n, c in counts().items()}
        if tp_per_step[mode] != per_step[mode]:
            raise AssertionError(f"tensor parallel (e) [{mode}]: launches per step {tp_per_step[mode]} != "
                                 f"{per_step[mode]}")
        del states
    distributed.shutdown()
    result["launches"]["bf16"] = tp_per_step
    result["step_ms"] = {"card": smi, "batch": 45, "dtype": "bf16", "windows": list(TP_WINDOWS),
                         "steps_per_window": TP_TIMED_STEPS, "ms": times, "per_step_launches": tp_per_step}
    for mode, t in times.items():
        log(f"tensor parallel (e) bf16 batch 45 [{mode}, {smi}], ms per step (host clock, {TP_TIMED_STEPS} steps a "
            f"window, windows {' '.join(TP_WINDOWS)}): no mesh " + " / ".join(f"{v:.3f}" for v in t["plain"])
            + ", the world-of-one mesh with TP (NCCL) " + " / ".join(f"{v:.3f}" for v in t["mesh"])
            + ", TP alone, no data group " + " / ".join(f"{v:.3f}" for v in t["tp"])
            + f"; launches per mesh step {tp_per_step[mode]}")

    # (b) (1, 2) on the one card over gloo (NCCL refuses two ranks on one
    # device), (c) (2, 2), the JAX test's DP x TP shape, (d) (1, 2) over NCCL
    # across two cards where there are two: each against one process. (b)'s
    # two ranks also run the data-parallel (2, 1) mesh, no leaf split, for
    # the floor.
    n_model = 2
    tp_jobs = [(mode, n_model, mode) for mode in TP_MODES]
    runs = [("(b)", "two_ranks_gloo", "gloo", ["cuda:0"] * 2, tp_jobs + [(f"dp_{m}", 1, m) for m in TP_MODES]),
            ("(c)", "four_ranks_gloo", "gloo", ["cuda:0"] * 4, tp_jobs)]
    if torch.cuda.device_count() >= 2:
        runs.append(("(d)", "two_cards_nccl", "nccl", ["cuda:0", "cuda:1"], tp_jobs))
    spawned = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as root:
        for what, key, backend, devices, jobs in runs:
            t0 = time.perf_counter()
            spawned[what] = spawn_ranks(backend, devices, jobs, root, fn=tp_rank, join_s=TP_JOIN_S)
            result[key] = {"spawn_s": time.perf_counter() - t0, "mesh": [len(devices) // n_model, n_model],
                           "backend": backend}
            log(f"tensor parallel {what}: spawning and running the ranks took {result[key]['spawn_s']:.1f} s")

    # The floor of another order of summation, the larger of two: one
    # process on the rows reversed, which changes only the order of every
    # sum over rows, and the data-parallel (2, 1) mesh (phase 10's path, no leaf
    # split) on the rows, which splits the sums over the ranks as (c) does.
    result["floor"], gates = {}, {}
    for mode in TP_MODES:
        rev = tp_gap(tp_steps(variables, mode, dev, reverse=True)["state"], one[mode]["state"], mode)
        dp = tp_gap(spawned["(b)"][0][f"dp_{mode}"]["state"], one[mode]["state"], mode)
        gates[mode] = {"tol": max(TP_TOL, TP_FLOOR_TIMES * max(rev["param_gap"], dp["param_gap"])),
                       "share": max(TP_MOMENT_SHARE, TP_FLOOR_TIMES * max(rev["moment_share"], dp["moment_share"]))}
        result["floor"][mode] = {"rows_reversed": rev, "data_parallel_2x1": dp, "gates": gates[mode]}
        log(f"tensor parallel floor [{mode}]: vs one process, params and BN stats (|d| / (1 + |want|)) and Adam "
            f"moments (of their largest): one process on the rows reversed {rev['param_gap']:.3g} (at {rev['at']}) "
            f"and {rev['moment_share']:.3g}; the data-parallel (2, 1) mesh, no leaf split, {dp['param_gap']:.3g} "
            f"(at {dp['at']}) and {dp['moment_share']:.3g}; gates {gates[mode]['tol']:.3g} and, with batch "
            f"statistics, {gates[mode]['share']:.3g} of the moments' largest")

    for what, key, backend, devices, jobs in runs:
        ranks, out, n_data = spawned[what], result[key], len(devices) // n_model
        for mode in TP_MODES:
            r0 = ranks[0][mode]
            for r, other in enumerate(ranks[1:], start=1):
                if any(not np.array_equal(other[mode]["state"][k], v) for k, v in r0["state"].items()):
                    raise AssertionError(f"tensor parallel {what} [{mode}]: rank {r}'s state differs from rank 0's")
            for r, rk in enumerate(ranks):
                check_launches(rk[mode], mode, n_model, f"{what} rank {r}")
                for k, shape in rk[mode]["local"].items():
                    path = k.split("/", 2)[2] if k.startswith("opt/") else k
                    whole = one[mode]["state"][path].shape
                    split = path == "blocks/3/conv/0" or (path.startswith("dense/") and path.endswith("/kernel"))
                    want = whole[:-1] + (whole[-1] // n_model,) if split else whole
                    if shape != want:
                        raise AssertionError(f"tensor parallel {what} rank {r}: {k} holds {shape}, not {want}")
            gaps = tp_gap(r0["state"], one[mode]["state"], mode, gates[mode])
            out[mode] = {**gaps, "launches_per_rank_step": r0["launches"][0], "b4_cout": r0["couts"][0][6],
                         "loss": r0["loss"], "loss_one": one[mode]["loss"], "wall_s": r0["wall_s"]}
            dp_note = ""
            if n_data == 2:
                own = tp_gap(r0["state"], spawned["(b)"][0][f"dp_{mode}"]["state"], mode)
                out[mode]["vs_data_parallel_2x1"] = own
                dp_note = (f"; vs the data-parallel (2, 1) mesh on the same rows {own['param_gap']:.3g} and "
                           f"{own['moment_share']:.3g}")
            log(f"tensor parallel {what} {n_data}x{n_model} mesh, {len(devices)} ranks over {backend}, f32 batch "
                f"{TP_BATCH} ({TP_BATCH // n_data} rows a data rank), {TP_STEPS} steps [{mode}]: vs one process "
                f"params and BN stats {gaps['param_gap']:.3g} (|d| / (1 + |want|), at {gaps['at']}; gate "
                f"{gates[mode]['tol']:.3g}), Adam moments {gaps['moment_share']:.3g} of their largest (gate "
                f"{gates[mode]['share'] if mode == 'trainbn' else gates[mode]['tol']:.3g}){dp_note}; loss "
                f"{r0['loss']!r} vs {one[mode]['loss']!r}; each rank holds 1/{n_model} of the split leaves and "
                f"their moments; launches per rank per step {r0['launches'][0]}, B4 conv Cout {r0['couts'][0][6]}; "
                f"{r0['wall_s']:.1f} s on rank 0")
            if gaps["fault"]:
                raise AssertionError(f"tensor parallel {what} [{mode}]: against one process: {gaps['fault']}")
    if torch.cuda.device_count() < 2:
        log("tensor parallel (d): not run (one card: NCCL across two cards needs two)")
    result["launches"]["f32"] = {mode: result["two_ranks_gloo"][mode]["launches_per_rank_step"] for mode in TP_MODES}
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"tensor parallel: phase 12 took {result['wall_s']:.1f} s")
    return result


# -- phase 13: from scratch through the curriculum -----------------------------------
CURRICULUM_STEPS = 3  # (a): steps per phase
CURRICULUM_TOTAL = 400  # (b): reference_curriculum(total_steps=CURRICULUM_TOTAL), phases of 100 steps
CURRICULUM_SAVE = 50  # (b): save_freq
CURRICULUM_RESUME = 250  # (b): the checkpoint a new Trainer resumes, inside the second dropout phase
CURRICULUM_WINDOW = (60, 80)  # (c): each phase's step calls under torch.profiler
CURRICULUM_LOG_EVERY = 25  # (b): tools/train_synth_torch.py's loss read


class CurriculumProbe:
    """Watches a Trainer's run from outside it: each step call's phase (its
    index in tc.phases), host clock and kernel launches; each validation's
    BN mode, step, span and launches; and, given `window`, each phase's
    step calls [window[0], window[1]) under torch.profiler (device activity
    alone), the device's busy share over them by CUDA events."""

    def __init__(self, trainer, window=None):
        self.steps, self.validations, self.busy, self.overhead = [], [], {}, []
        self._window, self._calls = window, {}
        real_step, real_val, phases = trainer._step_fn, trainer.run_validation, trainer.tc.phases

        def step_fn(ph, **kw):
            fn = real_step(ph, **kw)

            def run(*args):
                p = phases.index(ph)
                i = self._calls[p] = self._calls.get(p, -1) + 1
                if window and i in window:
                    t0 = time.perf_counter()
                    (self._start if i == window[0] else self._stop)(p)
                    self.overhead.append((t0, time.perf_counter()))
                before, t = _build.launch_counts(), time.perf_counter()
                out = fn(*args)
                self.steps.append((p, t, _build.card_launches_since(before, PER_FORWARD)))
                return out
            return run

        def validation(state, reader, use_batch_stats=False):
            before, t0 = _build.launch_counts(), time.perf_counter()
            out = real_val(state, reader, use_batch_stats=use_batch_stats)
            self.validations.append({"step": int(state.step), "batch_stats": use_batch_stats, "t0": t0,
                                     "t1": time.perf_counter(),
                                     "launches": _build.card_launches_since(before, PER_FORWARD)})
            return out

        trainer._step_fn, trainer.run_validation = step_fn, validation

    def _start(self, p):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        self.ev[0].record()

    def _stop(self, p):
        self.ev[1].record()
        self.ev[1].synchronize()
        self.prof.__exit__(None, None, None)
        device_us = sum(e.self_device_time_total for e in self.prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        if device_us == 0:
            raise AssertionError("torch.profiler recorded no device time in the curriculum run")
        self.busy[p] = device_us / 1e3 / self.ev[0].elapsed_time(self.ev[1])

    def per_step(self, phase_index: int) -> dict:
        """The launches of one step of a phase; raises if its steps differ."""
        got = [c for p, _, c in self.steps if p == phase_index]
        if not got or any(c != got[0] for c in got):
            raise AssertionError(f"phase {phase_index}: launches differ from step to step or no step ran: "
                                 f"{got[:3]} ...")
        return got[0]

    def phase_times(self, phases) -> list:
        """Per phase: img/s and host ms per step (p50) on the host clock,
        from the gaps between consecutive step calls (the first five of a
        phase left out, and any gap holding a validation or the probe's own
        profiler work), and the profiled device busy share."""
        out = []
        for p, ph in enumerate(phases):
            ts = [t for q, t, _ in self.steps if q == p]
            spans = [(v["t0"], v["t1"]) for v in self.validations] + self.overhead
            gaps = [b - a for a, b in zip(ts[4:], ts[5:]) if not any(s0 < b and s1 > a for s0, s1 in spans)]
            out.append({"batch": ph.batch_size, "steps": len(ts), "timed_gaps": len(gaps),
                        "img_per_s": ph.batch_size * len(gaps) / sum(gaps) if gaps else None,
                        "host_ms_per_step_p50": float(np.median(gaps)) * 1e3 if gaps else None,
                        "device_busy_share": self.busy.get(p)})
        return out


def phase13(cfgs, counts, start_counts, per_forward, dev, smi) -> dict:
    """From scratch through the curriculum (docstring phase 13). Returns its
    numbers, and under "launches" each dtype's counts over its Trainer run
    and per step of each phase ((a) f32, (b) bf16)."""
    import dataclasses
    import io

    from roomnet_tpu_torch.data.dataset import extract_fpaths
    from roomnet_tpu_torch.data.loader import TrainFeeder
    from roomnet_tpu_torch.params.checkpoint import CheckpointStore
    from roomnet_tpu_torch.train.loop import TrainConfig, Trainer
    from roomnet_tpu_torch.train.metrics import make_stats_entry
    from tools.make_synth_dataset import generate

    t_phase = time.perf_counter()
    schema_keys = {"step", "accuracy", "precisions", "recalls", "f-scores"}
    trainbn = {**per_forward, "dense_head": 0}
    want_step = [trainbn, trainbn, trainbn, per_forward]  # per step of each phase: batch statistics, then frozen
    result = {"card": smi, "launches": {}}

    def times(c: dict, n: int) -> dict:
        return {k: v * n for k, v in c.items()}

    def total(*parts: dict) -> dict:
        return {k: sum(p[k] for p in parts) for k in per_forward}

    def checkpoints(model_dir: str) -> list:
        return [(s, sfx) for s, sfx, _ in CheckpointStore(model_dir).list_checkpoints()]

    def step_launches(probe, what: str, phase_indices) -> list:
        got = [probe.per_step(p) for p in phase_indices]
        want = [want_step[p] for p in phase_indices]
        if got != want:
            raise AssertionError(f"curriculum {what}: launches per step by phase {got} != {want}")
        return got

    with tempfile.TemporaryDirectory(prefix="chip_smoke_curriculum_") as root:
        data = os.path.join(root, "data")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            generate(data, per_class=100, seed=0)
        lists = {"train_list_fpath": os.path.join(root, "train_list.txt"),
                 "val_list_fpath": os.path.join(root, "val_list.txt"),
                 "label_mappings_fpath": os.path.join(root, "label_mappings.json")}
        train_txt, val_txt = extract_fpaths(data, *lists.values(), seed=0)
        if (len(train_txt), len(val_txt)) != (540, 60):
            raise AssertionError(f"extract_fpaths split {len(train_txt)} / {len(val_txt)}, not 540 / 60")
        result["data_s"] = time.perf_counter() - t0

        def config(name: str, **kw) -> TrainConfig:
            return TrainConfig(data_dir=data, stats_fpath=os.path.join(root, f"stats_{name}.json"),
                               model_dir=os.path.join(root, f"models_{name}"), img_side=cfgs["bf16"].im_side,
                               **lists, **kw)

        # (a) f32, hand-driven across the three boundaries.
        n_a = 4 * CURRICULUM_STEPS
        tc = config("a", save_freq=0, phases=TrainConfig.reference_curriculum(n_a))
        tr = Trainer(tc, cfgs["f32"], device=dev)
        with deterministic():
            states, want_losses = hand_driven(tr, n_a)
            losses = record_losses(tr)
            probe = CurriculumProbe(tr)
            start_counts()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                state = tr.train(total_steps=n_a)
        got = counts()
        if "No model found to restore from" not in out.getvalue() or int(state.step) != n_a:
            raise AssertionError(f"curriculum (a): not from scratch or ended at {int(state.step)}")
        per_phase = step_launches(probe, "(a)", range(4))
        if got != total(*(times(c, CURRICULUM_STEPS) for c in per_phase)):
            raise AssertionError(f"curriculum (a): launches {got}")
        gap = state_gap(state_tensors(state), state_tensors(states[-1]), 0.0)
        d_loss = max(abs(float(a) - b) for a, b in zip(losses, want_losses))
        if d_loss != 0.0 or len(losses) != n_a:
            raise AssertionError(f"curriculum (a): losses {d_loss:.3g} from the hand-driven steps")
        result["launches"]["f32"] = {"run": got, "per_step": per_phase}
        result["hand_driven"] = {"max_abs_d_state": gap, "max_abs_d_loss": d_loss, "launches": got,
                                 "losses": want_losses}
        log(f"curriculum (a) f32 from the Trainer's own init, phases of {CURRICULUM_STEPS} steps at batch 8 "
            f"(batch statistics), 32 and 40 (dropout 0.3), 45 (frozen BN), cuDNN deterministic: Trainer vs "
            f"hand-driven make_train_step max |d| {gap:.3g} (params, BN moving stats, Adam; gate 0), losses "
            f"{d_loss:.3g}; launches {got}, per step by phase {per_phase}")
        del tr, states, state

        # (b) bf16, the compressed curriculum, from scratch, then a resume inside a dropout phase.
        tc = config("b", save_freq=CURRICULUM_SAVE, phases=TrainConfig.reference_curriculum(CURRICULUM_TOTAL),
                    stall_timeout_s=900.0)
        freeze = tc.phases[2].until_step
        tr = Trainer(tc, cfgs["bf16"], device=dev)
        losses = record_losses(tr)
        probe = CurriculumProbe(tr, CURRICULUM_WINDOW)
        start_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            state = tr.train(total_steps=CURRICULUM_TOTAL, log_every=CURRICULUM_LOG_EVERY)
        wall_b = time.perf_counter() - t0
        got = counts()
        losses = [float(v) for v in losses]
        if len(losses) != CURRICULUM_TOTAL or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"curriculum (b): {len(losses)} losses, non-finite at steps "
                                 f"{[i for i, v in enumerate(losses) if not math.isfinite(v)][:10]}")
        per_phase = step_launches(probe, "(b)", range(4))
        with open(tc.stats_fpath) as f:
            stats = json.load(f)
        curve = {e["step"]: e["accuracy"] for e in stats}
        steps = list(range(CURRICULUM_SAVE, CURRICULUM_TOTAL, CURRICULUM_SAVE))
        if list(curve) != steps or any(set(e) != schema_keys for e in stats):
            raise AssertionError(f"curriculum (b): stats {stats}")
        if checkpoints(tc.model_dir) != [(s, str(curve[s])) for s in steps]:
            raise AssertionError(f"curriculum (b): checkpoints {checkpoints(tc.model_dir)}")
        modes = [(v["step"], v["batch_stats"]) for v in probe.validations]
        if modes != [(s, s < freeze) for s in steps]:
            raise AssertionError(f"curriculum (b): validation BN modes {modes}")
        for v in probe.validations:
            heads, convs = v["launches"]["dense_head"], v["launches"]["conv3x3"]
            forwards = convs // per_forward["conv3x3"]
            want = times(trainbn if v["batch_stats"] else per_forward, forwards)
            if forwards < 1 or v["launches"] != want:
                raise AssertionError(f"curriculum (b): validation at step {v['step']}: launches {v['launches']}")
        val_launches = total(*(v["launches"] for v in probe.validations))
        if got != total(val_launches, *(times(c, CURRICULUM_TOTAL // 4) for c in per_phase)):
            raise AssertionError(f"curriculum (b): launches {got}")
        result["launches"]["bf16"] = {"run": got, "per_step": per_phase}
        result["compressed"] = {"accuracy": curve, "loss_first_last": [losses[0], losses[-1]],
                                "validation_batch_stats": dict(modes), "launches": got, "wall_s": wall_b}
        log(f"curriculum (b) bf16 reference_curriculum({CURRICULUM_TOTAL}) from scratch, save_freq "
            f"{CURRICULUM_SAVE}: {CURRICULUM_TOTAL} finite losses ({losses[0]:.4f} -> {losses[-1]:.4f}), "
            f"validation accuracy " + ", ".join(f"step {s} {a:.4f}" for s, a in curve.items())
            + f"; batch statistics in the validations before the freeze (step {freeze}), moving ones after "
            f"(dense_head launches " + ", ".join(str(v["launches"]["dense_head"]) for v in probe.validations)
            + f"); launches per step by phase {per_phase}, {got} in all; {wall_b:.1f} s")

        # The freeze step's weights validated both ways.
        frozen_dir = os.path.join(root, "models_freeze")
        os.makedirs(frozen_dir)
        src = next(p for s, _, p in CheckpointStore(tc.model_dir).list_checkpoints() if s == freeze)
        shutil.copy(src, frozen_dir)
        tr_f = Trainer(dataclasses.replace(tc, model_dir=frozen_dir), cfgs["bf16"], device=dev)
        with contextlib.redirect_stdout(io.StringIO()):
            state_f = tr_f.init_state()
        at_freeze = {}
        for use_batch_stats in (False, True):
            with TrainFeeder(val_txt, batch_size=tc.val_batch_size, batches_per_queue=10, shuffle=False,
                             im_side=tc.img_side, random_crop=False, preprocess=False, seed=tc.seed) as reader:
                y_true, y_pred = tr_f.run_validation(state_f, reader, use_batch_stats=use_batch_stats)
            at_freeze["batch" if use_batch_stats else "moving"] = make_stats_entry(freeze, y_true, y_pred)["accuracy"]
        if at_freeze["moving"] != curve[freeze]:
            raise AssertionError(f"curriculum (b): step-{freeze} checkpoint validates at {at_freeze['moving']} "
                                 f"with moving statistics, the run recorded {curve[freeze]}")
        result["at_freeze"] = at_freeze
        log(f"curriculum (b) step {freeze} (the freeze), the same weights: validation accuracy with moving "
            f"statistics {at_freeze['moving']:.4f} (the run's entry), with batch statistics "
            f"{at_freeze['batch']:.4f}; a record at {CURRICULUM_TOTAL} steps, not a gate")
        del tr_f, state_f

        resume_dir = os.path.join(root, "models_resume")
        os.makedirs(resume_dir)
        src = next(p for s, _, p in CheckpointStore(tc.model_dir).list_checkpoints() if s == CURRICULUM_RESUME)
        shutil.copy(src, resume_dir)
        tc_r = dataclasses.replace(tc, model_dir=resume_dir, stats_fpath=os.path.join(root, "stats_resume.json"))
        tr_r = Trainer(tc_r, cfgs["bf16"], device=dev)
        losses_r = record_losses(tr_r)
        probe_r = CurriculumProbe(tr_r)
        with contextlib.redirect_stdout(io.StringIO()) as out:
            state_r = tr_r.train(total_steps=CURRICULUM_TOTAL - CURRICULUM_RESUME, log_every=CURRICULUM_LOG_EVERY)
        losses_r = [float(v) for v in losses_r]
        resumed = [s for s in steps if s > CURRICULUM_RESUME]
        if (f"Model restored at step {CURRICULUM_RESUME}" not in out.getvalue()
                or int(state_r.step) != CURRICULUM_TOTAL
                or len(losses_r) != CURRICULUM_TOTAL - CURRICULUM_RESUME
                or not all(math.isfinite(v) for v in losses_r)):
            raise AssertionError(f"curriculum (b) resume: ended at step {int(state_r.step)}, "
                                 f"{len(losses_r)} losses\n{out.getvalue()[:300]}")
        with open(tc_r.stats_fpath) as f:
            resumed_stats = [e["step"] for e in json.load(f)]
        if resumed_stats != resumed or [s for s, _ in checkpoints(resume_dir)] != [CURRICULUM_RESUME] + resumed:
            raise AssertionError(f"curriculum (b) resume: stats {resumed_stats}, checkpoints "
                                 f"{checkpoints(resume_dir)}")
        step_launches(probe_r, "(b) resume", (2, 3))
        if [(v["step"], v["batch_stats"]) for v in probe_r.validations] != [(s, s < freeze) for s in resumed]:
            raise AssertionError(f"curriculum (b) resume: validations {probe_r.validations}")
        result["resume"] = {"from": CURRICULUM_RESUME, "to": int(state_r.step), "loss_last": losses_r[-1]}
        log(f"curriculum (b) resume: a new Trainer restored step {CURRICULUM_RESUME} (dropout 0.3, batch 40) and "
            f"ran across the freeze to step {int(state_r.step)}: finite losses, validations at {resumed} "
            f"(moving statistics), launches per step by phase as in the run")
        del tr, tr_r, state, state_r

    # (c) times from (b), nothing claimed.
    result["times"] = probe.phase_times(tc.phases)
    log(f"curriculum times [bf16, {smi}], by phase: " + "; ".join(
        f"batch {t['batch']}: {t['img_per_s']:.1f} img/s, host ms per step p50 {t['host_ms_per_step_p50']:.3f} "
        f"({t['timed_gaps']} gaps), device busy {t['device_busy_share']:.3f} over steps "
        f"{CURRICULUM_WINDOW[0]}-{CURRICULUM_WINDOW[1]} of the phase" for t in result["times"])
        + "; validation s " + ", ".join(f"{v['t1'] - v['t0']:.2f}" for v in probe.validations))
    result["validation_s"] = [v["t1"] - v["t0"] for v in probe.validations]
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"curriculum: phase 13 took {result['wall_s']:.1f} s")
    return result


# -- phase 14: the bench and the val-scale parity run ------------------------------
BENCH_FORWARD_SHARE = 0.25  # (a): the bench's device forward within this share of phase 5's


def bench_py_result() -> tuple[str, str, set, set]:
    """(metric, unit, top-level keys, keys of "extras") of the JSON object the
    repo root's bench.py prints as its result, read from its source with ast:
    nothing of it is imported."""
    import ast

    tree = ast.parse((pathlib.Path(__file__).resolve().parent / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "result" for t in node.targets)):
            fields = dict(zip((k.value for k in node.value.keys), node.value.values))
            return (fields["metric"].value, fields["unit"].value, set(fields),
                    {k.value for k in fields["extras"].keys})
    raise AssertionError("bench.py: no `result = {...}` assignment")


def bench_forwards(burst_calls: int, **sizes) -> int:
    """Forwards (or inference-BN train steps, 10/10/3/1 launches each) of one
    run of roomnet_tpu_torch/bench.py at `bench.sizes(**sizes)`, the sizes
    `bench.run(**sizes)` uses: the inference segment's warm-up, timed calls,
    latency warm-up and latency calls; each train batch's warm-up and chains;
    the e2e warm-up and runs; the daemon's warm-up (buckets 1, 2, 4, ...,
    serve_batch), its first request, the keep-alive connection's first, the
    interleaved pairs and the burst's device calls."""
    from roomnet_tpu_torch import bench

    n = bench.sizes(**sizes)
    return ((1 + n["infer_iters"] + 1 + n["latency_calls"]) + 2 * (1 + n["chains"] * n["train_iters"])
            + (1 + n["e2e_runs"] * math.ceil(n["e2e_images"] / n["batch"]))
            + (n["serve_batch"].bit_length() + 2 + 2 * n["serve_pairs"] + burst_calls))


def phase15(dev, parent_conv1=None) -> dict:
    """ResNet-50 v1.5's kernels (docstring phase 15). Returns per site and
    per kernel the kernel's, cuDNN's, the bound's and (given
    `parent_conv1`, parent_conv1x1's conv) the parent's ms at batch 256,
    the 1x1's per stage, and the classifier's forward."""
    from roomnet_tpu_torch.infer.classify import RoomNetClassifier
    from roomnet_tpu_torch.models import registry
    from roomnet_tpu_torch.models import resnet as R
    from roomnet_tpu_torch.ops.kernels import conv1x1 as K1
    from roomnet_tpu_torch.ops.kernels import conv3x3 as KC

    sass = sass_counts(_build.library_path("conv1x1"))
    log(f"phase 15: sass conv1x1: {sass}")
    if not (sass["HGMMA"] and sass["UTMALDG"] and sass["UTMASTG"]):
        raise AssertionError(f"conv1x1: the library's SASS lacks wgmma, TMA loads or TMA stores: {sass}")
    cfg, batch = registry.get("resnet50-v1.5-224-bf16"), 256
    g = torch.Generator(device=dev).manual_seed(15)
    keys = ("ms", "library_ms", "bound_ms")
    sites, per_stage = [], {}
    per_forward = {"conv3x3": dict.fromkeys(keys, 0.0),
                   "conv1x1": dict.fromkeys(keys + (("parent_ms",) if parent_conv1 else ()), 0.0)}
    for site in cfg.conv_sites():
        k, side, cin, cout, s = (3 if site["kernel"] == "conv3x3" else 1), site["side"], site["cin"], site["cout"], \
            site["stride"]
        so = (side - 1) // s + 1
        x = torch.randn(batch, side, side, cin, generator=g, device=dev).bfloat16()
        w = (torch.randn(k, k, cin, cout, generator=g, device=dev) / (k * cin ** 0.5)).bfloat16()
        bias = torch.randn(cout, generator=g, device=dev)
        res = torch.randn(batch, so, so, cout, generator=g, device=dev).bfloat16() if site["residual"] else None
        kw = {"stride": s, "relu": site["relu"], "residual": res}
        if k == 3:
            kern, plain, kw = KC.conv3x3, KC.conv3x3_plain, dict(kw, padding=1)
        else:
            kern, plain = K1.conv1x1, K1.conv1x1_plain
        got, want = kern(x, w, bias, **kw).float(), plain(x, w, bias, **kw).float()
        d = (got - want).abs()
        if (d > 2.0 ** -7 * (8 + want.abs())).any() or not torch.isfinite(got).all():
            raise AssertionError(f"{site['kernel']} {site['site']}: kernel disagrees with plain, max |d| "
                                 f"{d.max().item():.3g}")
        err = d.max().item()
        del got, want, d
        xl, rl = x.permute(0, 3, 1, 2), None if res is None else res.permute(0, 3, 1, 2)
        wl, bl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last), bias.bfloat16()

        def library():
            y = F.conv2d(xl, wl, bl, stride=s, padding=k // 2)
            if rl is not None:
                y = y.add_(rl)
            return y.relu_() if site["relu"] else y

        fns = {"kernel": lambda: kern(x, w, bias, **kw), "library": library}
        if k == 1 and parent_conv1 is not None:
            fns["parent"] = lambda: parent_conv1(x, w, bias, **kw)
        t = in_turns(fns)
        read = batch * (side * side if k == 3 else so * so) * cin
        nb = 2 * (read + k * k * cin * cout + batch * so * so * cout * (2 if res is not None else 1)) + 4 * cout
        ops = 2 * batch * so * so * cout * k * k * cin
        bound = 1e3 * max(nb / HBM_BYTES_PER_S, ops / PEAK_BF16_TENSOR)
        if k == 3:
            plan = v = KC.variant(tuple(x.shape), cout, x.dtype, padding=1, stride=s)
        else:
            v = K1.variant(tuple(x.shape), cout, stride=s, residual=res is not None)
            plan = (f"{v['blocks']} blocks walk {v['tiles']} tiles ({v['tiles'] / v['blocks']:.2f} a block, at "
                    f"most {v['tiles_per_block']}); {v}")
        parent = f", parent {t['parent']:.4f} ms" if "parent" in t else ""
        log(f"  {site['kernel']} {site['site']} {side}x{side}x{cin}->{cout} s{s}: kernel {t['kernel']:.4f} ms"
            f"{parent}, cuDNN {t['library']:.4f} ms, bound {bound:.4f} ms "
            f"({'bytes' if nb / HBM_BYTES_PER_S >= ops / PEAK_BF16_TENSOR else 'operations'}), "
            f"{100 * bound / t['kernel']:.1f}% of it, max |d| {err:.3g}; {plan}")
        times = {"ms": t["kernel"], "library_ms": t["library"], "bound_ms": bound}
        if "parent" in t:
            times["parent_ms"] = t["parent"]
        sites.append({**site, **times, "max_abs_err": err, "variant": v})
        sums = [per_forward[site["kernel"]]]
        if k == 1:
            sums.append(per_stage.setdefault(site["site"].split("/")[0], dict.fromkeys(times, 0.0)))
        for total in sums:
            for key, val in times.items():
                total[key] += val
        del x, w, res, xl, rl, wl
    for name, s in per_forward.items():
        parent = f", parent {s['parent_ms']:.4f} ms" if "parent_ms" in s else ""
        log(f"phase 15: {name} per batch-256 forward: kernel {s['ms']:.4f} ms{parent}, cuDNN "
            f"{s['library_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms ({100 * s['bound_ms'] / s['ms']:.1f}% of it)")
    for name, s in per_stage.items():
        parent = f", parent {s['parent_ms']:.4f} ms" if "parent_ms" in s else ""
        log(f"phase 15: conv1x1 {name}: kernel {s['ms']:.4f} ms{parent}, cuDNN {s['library_ms']:.4f} ms, bound "
            f"{s['bound_ms']:.4f} ms ({100 * s['bound_ms'] / s['ms']:.1f}% of it)")
    clf = RoomNetClassifier(R.init_variables(torch.Generator(device=dev).manual_seed(0), cfg), cfg,
                            batch_size=batch, device=dev)
    x_u8 = torch.randint(0, 256, (batch, cfg.im_side, cfg.im_side, 3), dtype=torch.uint8, device=dev,
                         generator=g)
    plans = [K1.variant((batch, st["side"], st["side"], st["cin"]), st["cout"], stride=st["stride"],
                        residual=st["residual"]) for st in cfg.conv_sites() if st["kernel"] == "conv1x1"]
    tiles, blocks = sum(v["tiles"] for v in plans), sum(v["blocks"] for v in plans)
    before = _build.launch_counts()
    clf._predict(clf.variables, x_u8)
    torch.cuda.synchronize()
    launches = {n: c for n, c in _build.card_launches_since(before).items() if c}
    if launches != {"conv3x3": 16, "conv1x1": 36}:
        raise AssertionError(f"phase 15: a ResNet-50 forward launched {launches}, not 16 conv3x3 and 36 conv1x1")
    forward_ms = cuda_ms(lambda: clf._predict(clf.variables, x_u8))
    clf.close()
    log(f"phase 15: RoomNetClassifier._predict, batch 256: {forward_ms:.3f} ms device time, launches {launches}, "
        f"conv1x1 tiles {tiles} over {blocks} blocks ({tiles / blocks:.2f} a block; conv1x1.variant's plans)")
    return {"sites": sites, "per_forward": per_forward, "per_stage": per_stage, "forward_ms": forward_ms,
            "launches": launches, "conv1x1_plans": {"tiles": tiles, "blocks": blocks}}


def phase14(counts, start_counts, per_forward, serving, dev, smi) -> dict:
    """The bench and the val-scale parity run (docstring phase 14). Returns
    their numbers, and under "launches" the bench's counts (bf16) and each
    dtype's over the valset run."""
    import io

    from roomnet_tpu_torch import cli
    from tools import valset_torch

    t_phase = time.perf_counter()
    # (a) `python -m roomnet_tpu_torch bench`, in this process.
    out = io.StringIO()
    start_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["bench"])
    bench_s = time.perf_counter() - t0
    bench_launches = counts()
    lines = out.getvalue().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench: {len(lines)} lines on stdout, one expected:\n{out.getvalue()[:1000]}")
    line = json.loads(lines[0])
    metric, unit, top, extras = bench_py_result()
    if set(line) != top or set(line["extras"]) != extras or (line["metric"], line["unit"]) != (metric, unit):
        raise AssertionError(f"bench: keys {sorted(set(line) ^ top)} and extras {sorted(set(line['extras']) ^ extras)} "
                             f"differ from bench.py's, or the metric {line['metric']!r} or unit {line['unit']!r}")

    def numbers(obj, where: str):
        if isinstance(obj, dict):
            for k, v in obj.items():
                yield from numbers(v, f"{where}.{k}")
        elif isinstance(obj, (bool, int, float)):
            yield where, obj

    for where, v in numbers({k: line[k] for k in ("value", "vs_baseline", "extras")}, "bench"):
        if v is not True and not (isinstance(v, (int, float)) and not isinstance(v, bool) and math.isfinite(v)
                                  and v > 0):
            raise AssertionError(f"{where} = {v!r}: every number of the bench's line must be finite and positive")
    if line["extras"]["device"] not in smi.splitlines():
        raise AssertionError(f"bench: device {line['extras']['device']!r}, nvidia-smi says {smi!r}")
    fwd, ref = line["extras"]["device_forward_ms_batch256"], serving["bf16"]["device_forward_ms_batch256"]
    if abs(fwd / ref - 1) > BENCH_FORWARD_SHARE:
        raise AssertionError(f"bench: device forward {fwd:.3f} ms, phase 5's {ref:.3f} ms (limit "
                             f"{BENCH_FORWARD_SHARE:.0%})")
    forwards = bench_forwards(line["extras"]["serving_burst_device_calls"])
    if bench_launches != {n: c * forwards for n, c in per_forward.items()}:
        raise AssertionError(f"bench: launches {bench_launches}, {forwards} forwards and inference-BN steps of "
                             f"{per_forward} expected")
    log(f"bench (python -m roomnet_tpu_torch bench in this process, {smi}): {bench_s:.1f} s; keys equal bench.py's; "
        f"every number finite and positive; device forward {fwd:.3f} ms against phase 5's {ref:.3f} ms; launches "
        f"{bench_launches} ({forwards} forwards and steps); the line: {lines[0]}")

    # (b) tools/valset_torch.py on the 1,609 undocumented images.
    launches = {}

    @contextlib.contextmanager
    def measure(dt: str):
        start_counts()
        yield
        launches[dt] = counts()

    t0 = time.perf_counter()
    val = valset_torch.run(dev, indices="undocumented", measure=measure)
    val_s = time.perf_counter() - t0
    if not val["ok"] or val["scored"] != len(valset_torch.undocumented_indices()):
        raise AssertionError(f"valset: {json.dumps(val)}")
    for dt, n in val["forwards"].items():
        if launches[dt] != {k: c * n for k, c in per_forward.items()}:
            raise AssertionError(f"valset[{dt}]: launches {launches[dt]}, {n} forwards of {per_forward} expected")
    flip_d = max((float(np.abs(np.subtract(lg["bf16"], lg["bf16_plain_cpu"])).max())
                  for lg in val["bf16_flip_logits"].values()), default=0.0)
    flip_plain = sum(int(np.argmax(lg["bf16"]) == np.argmax(lg["bf16_plain_cpu"]))
                     for lg in val["bf16_flip_logits"].values())
    log(f"valset ({val['scored']} undocumented images, {val['decoder']} decode, {smi}): f32 {val['f32_mismatches']} "
        f"argmax mismatches against the TF graph's {val['argmax_key']}, bf16 {val['bf16_flips']} flips "
        f"({100 * val['bf16_flip_rate']:.3f}%, gate {100 * valset_torch.FLIP_GATE:g}%) at "
        f"{val['bf16_flip_indices']} (f32 top-2 margins {val['bf16_flip_f32_top2_margins']}; the plain versions on "
        f"the CPU flip {flip_plain} of them to the same class, bf16 logits max |d| {flip_d:.3g} from the card's), "
        f"sample logits max |d| "
        f"{val['sample_logits_max_abs_diff']:.3g} over {val['sample_images']} images; build {val['build_s']:.1f} s, "
        f"score {val['score_s']:.1f} s, {val_s:.1f} s in all; launches {launches}")
    result = {"bench": line, "bench_s": bench_s, "bench_forwards": forwards, "valset": val, "valset_s": val_s,
              "wall_s": time.perf_counter() - t_phase,
              "launches": {"bench": bench_launches, "valset": launches}}
    log(f"bench and valset: phase 14 took {result['wall_s']:.1f} s")
    return result


if __name__ == "__main__":
    main()
