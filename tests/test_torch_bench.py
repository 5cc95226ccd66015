"""roomnet_tpu_torch/bench.py, the port's benchmark, on the CPU at tiny sizes
(tests/tiny.py's geometry, 6 classes, bf16 compute): its JSON object has
exactly the keys of the repo root's bench.py (read from its source with ast
by chip_smoke.bench_py_result: the root bench.py imports JAX at run time)
and its metric and unit strings and reference rate; every number is finite and positive; under a clock that
steps by STEP seconds a call, `value` and `vs_baseline` are bench.py's
formulas (without bench.py's rounding: the port reports numbers unrounded);
the e2e stage keys are the `e2e/*` spans; a failing segment raises
SegmentError naming itself and leaves no temp directory; the launches of a
run are chip_smoke.bench_forwards' count (the plain versions counted as
launches); without CUDA and without --device the bench raises.
"""

import ast
import dataclasses
import itertools
import math
import os
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import tiny_config
from roomnet_tpu_torch import bench as B
from roomnet_tpu_torch import cli as tcli
from roomnet_tpu_torch.infer.classify import RoomNetClassifier
from roomnet_tpu_torch.infer.server import ClassifierServer
from roomnet_tpu_torch.models.roomnet import init_variables
from roomnet_tpu_torch.ops.kernels import conv3x3 as KC
from roomnet_tpu_torch.ops.kernels import dense_head as KD
from roomnet_tpu_torch.ops.kernels import pool as KP
from roomnet_tpu_torch.ops.kernels import residual as KR
from roomnet_tpu_torch.params import schema
from roomnet_tpu_torch.utils.profiling import SPANS

pytest.importorskip("cv2")
REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = dataclasses.replace(tiny_config(), num_classes=6, compute_dtype=torch.bfloat16)
# The run's sizes, as run() keywords.
SIZES = {"batch": 4, "infer_iters": 2, "latency_calls": 3, "train_batch": 3, "cap_batch": 4, "train_iters": 2,
         "chains": 3, "e2e_images": 10, "e2e_unique": 3, "e2e_runs": 2, "serve_batch": 2, "serve_pairs": 2, "burst": 4}
STEP = 0.25
# The tiny geometry's launches per forward: one conv and pool per block layer, one residual, the head.
TINY_PER_FORWARD = {"conv3x3": 3, "relu6_pool_bn": 3, "residual_bn": 1, "dense_head": 1}
KERNELS = ((KC, "conv3x3", "conv3x3_plain"), (KP, "relu6_pool_bn", "relu6_pool_bn_plain"),
           (KR, "residual_bn", "residual_bn_plain"), (KD, "dense_head", "dense_head_plain"))


def count_plain_launches(mp):
    """Count each kernel's plain version as a launch of its wrapper, outside a
    backward (the head's backward calls its plain version again)."""
    for mod, wrapper, plain in KERNELS:
        def counted(*args, _w=getattr(mod, wrapper), _p=getattr(mod, plain), **kwargs):
            if torch._C._current_graph_task_id() == -1:
                _w.launches += 1
            return _p(*args, **kwargs)
        mp.setattr(mod, plain, counted)
        mp.setattr(getattr(mod, wrapper), "launches", 0)


def tiny_run(**kw) -> dict:
    return B.run("cpu", cfg=CFG, variables=init_variables(torch.Generator().manual_seed(0), CFG), **{**SIZES, **kw})


CLOCKS = ("perf_counter", "stepping")


def one_run(clock: str) -> dict:
    """One tiny run on the CPU: with the real clock, or with a clock that
    steps by STEP a call, with the launches counted."""
    with pytest.MonkeyPatch.context() as mp:
        if clock == "stepping":
            ticks = itertools.count()
            mp.setattr(B, "clock", lambda: STEP * next(ticks))
        count_plain_launches(mp)
        line = tiny_run()
        launches = {name: getattr(mod, name).launches for mod, name, _ in KERNELS}
        spans = {k.split("/", 1)[1] for k in SPANS.summary() if k.startswith("e2e/")}
        forwards = chip_smoke.bench_forwards(line["extras"]["serving_burst_device_calls"], **SIZES)
    return {"line": line, "launches": launches, "spans": spans, "forwards": forwards}


@pytest.fixture(scope="module")
def runs():
    return {clock: one_run(clock) for clock in CLOCKS}


@pytest.mark.parametrize("clock", CLOCKS)
def test_keys_and_metric_are_bench_pys(runs, clock):
    line = runs[clock]["line"]
    metric, unit, keys, extras = chip_smoke.bench_py_result()
    assert set(line) == keys and "extras" in keys
    assert set(line["extras"]) == extras
    assert line["metric"] == metric == B.METRIC
    assert line["unit"] == unit
    assert line["extras"]["device"] == "cpu"


def test_reference_rate_is_bench_pys():
    tree = ast.parse((REPO / "bench.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign) and n.targets[0].id == "REF_TRAIN_IPS")
    assert B.REF_TRAIN_IPS == eval(compile(ast.Expression(node.value), "bench.py", "eval"), {"__builtins__": {}})


@pytest.mark.parametrize("clock", CLOCKS)
def test_every_number_is_finite_and_positive(runs, clock):
    result = runs[clock]
    def numbers(obj):
        if isinstance(obj, dict):
            for v in obj.values():
                yield from numbers(v)
        elif isinstance(obj, (bool, int, float)):
            yield obj

    line = result["line"]
    got = list(numbers({k: line[k] for k in ("value", "vs_baseline", "extras")}))
    assert len(got) >= 28  # 24 in extras, 2 at the top, and the stages' seconds
    for v in got:
        assert v is True or (not isinstance(v, bool) and math.isfinite(v) and v > 0), v


def test_value_and_vs_baseline_are_bench_pys_formulas(runs):
    """bench.py: value = BATCH * iters / t, vs_baseline = the median chain's
    TRAIN_BATCH * iters / t over REF_TRAIN_IPS, each t two clock reads apart."""
    line, size = runs["stepping"]["line"], SIZES
    assert line["value"] == size["batch"] * size["infer_iters"] / STEP
    assert line["vs_baseline"] == size["train_batch"] * size["train_iters"] / STEP / B.REF_TRAIN_IPS
    ex = line["extras"]
    assert ex["train_capacity_images_per_sec_batch128"] == size["cap_batch"] * size["train_iters"] / STEP
    assert ex["device_forward_ms_batch256"] == 1e3 * size["batch"] / line["value"]
    assert ex["p50_single_image_latency_ms"] == ex["steady_state_serving_p50_ms"] == STEP * 1e3
    assert ex["end_to_end_dir_inference_images_per_sec"] == size["e2e_images"] / STEP
    x_bytes = size["batch"] * CFG.im_side ** 2 * 3
    assert ex["relay_host_to_device_MBps"] == ex["serving_relay_MBps"] == x_bytes / 1e6 / STEP
    assert ex["concurrent_serving_req_per_sec"] == size["burst"] / STEP


@pytest.mark.parametrize("clock", CLOCKS)
def test_e2e_stage_keys_are_the_e2e_spans(runs, clock):
    result = runs[clock]
    stages = result["line"]["extras"]["e2e_stage_seconds_per_run"]
    assert set(stages) == result["spans"]
    assert {"decode", "wait_decode", "dispatch", "fetch"} <= set(stages)
    assert result["line"]["extras"]["e2e_decode_images_per_sec_in_run"] == SIZES["e2e_images"] / stages["decode"]


@pytest.mark.parametrize("clock", CLOCKS)
def test_launches_are_chip_smokes_count(runs, clock):
    result = runs[clock]
    """chip_smoke.py phase 14 holds the card's counts to bench_forwards(...)
    forwards and inference-BN steps of 10/10/3/1; here each counts
    TINY_PER_FORWARD."""
    assert result["launches"] == {n: c * result["forwards"] for n, c in TINY_PER_FORWARD.items()}


@pytest.mark.parametrize("segment,target,name", [
    ("e2e", RoomNetClassifier, "predict_paths"),
    ("serving", ClassifierServer, "start"),
])
def test_a_failing_segment_raises_and_names_itself(monkeypatch, segment, target, name):
    made = []
    real_mkdtemp = B.tempfile.mkdtemp

    def mkdtemp(*args, **kwargs):
        made.append(real_mkdtemp(*args, **kwargs))
        return made[-1]

    def broken(self, *args, **kwargs):
        raise OSError("planted")

    monkeypatch.setattr(B.tempfile, "mkdtemp", mkdtemp)
    monkeypatch.setattr(target, name, broken)
    with pytest.raises(B.SegmentError, match=f"bench segment '{segment}' failed: OSError: planted"):
        tiny_run(infer_iters=1, latency_calls=1, train_iters=1)
    assert made and not any(os.path.exists(d) for d in made)


def test_bench_raises_without_cuda_and_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["bench"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        B.main()


def test_weights_are_the_converted_npz_else_seed_0(tmp_path):
    got = schema.flatten_tensors(B.load_variables(torch.device("cpu")))
    with np.load(B.PARAMS) as data:
        assert set(got) == set(data.files)
        for k in data.files:
            np.testing.assert_array_equal(got[k].numpy(), data[k])
    got = schema.flatten_tensors(B.load_variables(torch.device("cpu"), CFG, tmp_path / "missing.npz"))
    want = schema.flatten_tensors(init_variables(torch.Generator().manual_seed(0), CFG))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_sizes_are_the_module_constants_unless_overridden(monkeypatch):
    """One source of the sizes: run() and chip_smoke.bench_forwards read the
    constants as they stand at the call, overridden by lower-case keywords."""
    assert B.sizes() == {name.lower(): getattr(B, name) for name in B.SIZES}
    assert set(SIZES) == set(B.sizes())
    assert B.sizes(batch=4)["batch"] == 4 and B.sizes(batch=4)["burst"] == B.BURST
    monkeypatch.setattr(B, "CHAINS", 5)
    assert B.sizes()["chains"] == 5
    assert (chip_smoke.bench_forwards(1, chains=5) - chip_smoke.bench_forwards(1, chains=3)
            == chip_smoke.bench_forwards(1) - chip_smoke.bench_forwards(1, chains=3) == 2 * 2 * B.TRAIN_ITERS)
    with pytest.raises(TypeError, match="unknown bench sizes"):
        B.sizes(batches=4)
    with pytest.raises(TypeError, match="unknown bench sizes"):
        B.run("cpu", cfg=CFG, batches=4)
