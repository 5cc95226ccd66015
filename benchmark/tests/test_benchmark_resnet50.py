"""ResNet-50's pieces of the benchmark (benchmark/arch/resnet50/ and its two
roofline readers): the work counts by hand, and the readers' refusal to
divide a count the program did not run."""

from __future__ import annotations

import copy
import json
import time

import pytest
import torch

from benchmark.lib import harness
from benchmark.lib.peaks import PEAK_BF16
from benchmark.lib.trace import Trace

from .conftest import tiny_cell

R50 = harness.load_arch("resnet50")
CELL = "r50-bf16-infer-b256"
READERS = ("conv1x1_roofline.r50", "conv3x3_roofline.r50")


def config() -> dict:
    return json.loads((harness.ROOT / "benchmark" / "configs" / "resnet50-v1.5-224-bf16.json").read_text())


def site(name):
    return next(launch for launch in R50.work.launches(config(), 256) if launch["site"] == name)


def test_sites_by_hand():
    # layer2/0/conv2: the stride-2 3x3 conv, 56x56x128 -> 28x28x128, pad 1.
    c = site("layer2/0/conv2")
    assert c["kernel"] == "conv3x3" and c["ops"] == 2 * 256 * 28 * 28 * 128 * 9 * 128
    assert c["bytes"] == 2 * (256 * 56 * 56 * 128 + 9 * 128 * 128 + 256 * 28 * 28 * 128) + 4 * 128
    # layer2/0/proj: the stride-2 1x1 projection reads the pixels it uses alone.
    p = site("layer2/0/proj")
    assert p["kernel"] == "conv1x1" and p["ops"] == 2 * 256 * 28 * 28 * 256 * 512
    assert p["bytes"] == 2 * (256 * 28 * 28 * 256 + 256 * 512 + 256 * 28 * 28 * 512) + 4 * 512
    # layer4/2/conv3: 7x7x512 -> 2048 with the residual read once.
    r = site("layer4/2/conv3")
    assert r["bytes"] == 2 * (256 * 49 * 512 + 512 * 2048 + 2 * 256 * 49 * 2048) + 4 * 2048
    assert r["bound_s"] == max(r["bytes"] / 3.35e12, r["ops"] / PEAK_BF16)


def test_forward_work():
    cfg, launches = config(), R50.work.launches(config(), 256)
    assert [x["kernel"] for x in launches].count("conv1x1") == 36
    assert [x["kernel"] for x in launches].count("conv3x3") == 16
    assert R50.work.forward_flops(cfg, 1) == pytest.approx(8.18e9, rel=1e-3)
    assert R50.work.forward_ideal_s(cfg, 256) == pytest.approx(256 * R50.work.forward_flops(cfg, 1) / PEAK_BF16)
    assert R50.work.bound_s(cfg, 256, "conv3x3") * 1e3 == pytest.approx(0.979, abs=1e-3)
    assert R50.work.bound_s(cfg, 256, "conv1x1") * 1e3 == pytest.approx(3.426, abs=1e-3)


@pytest.fixture(scope="module")
def readings():
    cell = tiny_cell(CELL)
    ctx = harness.Context(cell, 2**33 + 9, 0.3, False, torch.device("cpu"), time.monotonic(), log=lambda m: None)
    r = harness.load_driver(cell).run(ctx).readings
    r.trace = Trace((0, 10**9), [("conv_wg_stream", 0, 10**8), ("conv1x1_bn_kernel", 10**8, 3 * 10**8)], [])
    return r


def read(r, metric):
    return harness.load_module(harness.reader_path(harness.ROOT, metric), metric.replace(".", "_")).read(r)


def test_the_rooflines_read_their_own_kernels(readings):
    per_forward = {k: sum(1 for x in R50.work.launches(readings.cfg, readings.batch) if x["kernel"] == k)
                   for k in ("conv1x1", "conv3x3")}
    for metric, kernel, seconds in (("conv1x1_roofline.r50", "conv1x1", 0.2), ("conv3x3_roofline.r50", "conv3x3", 0.1)):
        want = 100 * R50.work.bound_s(readings.cfg, readings.batch, kernel) * readings.forwards / seconds
        assert read(readings, metric) == pytest.approx(want)
        before, after = readings.spans
        assert after[f"kernel/launches.{kernel}"]["total"] - before.get(f"kernel/launches.{kernel}", {}).get(
            "total", 0) == per_forward[kernel] * readings.forwards


@pytest.mark.parametrize("counter", ["kernel/launches.conv1x1", "kernel/launches.conv3x3"])
@pytest.mark.parametrize("change", ["one more", "missing"])
def test_a_count_the_program_did_not_run_is_not_divided(readings, counter, change):
    r = copy.copy(readings)
    before, after = r.spans
    after = copy.deepcopy(after)
    if change == "missing":
        del after[counter]
    else:
        after[counter]["total"] += 1
    r.spans = (before, after)
    metric = "conv1x1_roofline.r50" if counter.endswith("conv1x1") else "conv3x3_roofline.r50"
    assert read(readings, metric) is not None and read(r, metric) is None
