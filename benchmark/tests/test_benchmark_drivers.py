"""Each cell end to end at roomnet-tiny on the CPU (the kernels' plain
versions), with and without the trace."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark.lib import harness

from .conftest import CELLS, run_tiny, tiny_cell

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_runs_end_to_end_on_the_cpu(name, trace, capsys):
    cell = tiny_cell(name)
    result = run_tiny(cell, trace=trace)
    keys = list(result)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu" and result["device"]["count"] == 1
    if trace:
        # The CPU has no device trace: the metrics read from it are left
        # out, and every other per-layer metric is read.
        assert set(result["metrics"]) == {m["name"] for m in cell.per_layer if m["source"] != "device_trace"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in result["device"] and "window_s" in result["device"]
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    harness.emit(result)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") and " limit " in line for line in tail)


@pytest.mark.parametrize("name", CELLS)
def test_the_device_trace_readers_read_a_trace(name):
    """The readers the CPU leaves out (no device trace there), on the
    readings of a CPU run given a device trace in which every kernel the
    readers look for ran for a tenth of the window."""
    from benchmark.lib.trace import Trace

    cell = tiny_cell(name)
    ctx = harness.Context(cell, 2**33 + 7, 0.3, False, torch.device("cpu"), time.monotonic(), log=lambda msg: None)
    readings = harness.load_driver(cell).run(ctx).readings
    names = [m["name"] for m in cell.per_layer if m["source"] == "device_trace"]
    kernels = {"conv_wg", "conv_tf32x3", "relu6_pool_bn_kernel"}
    readings.trace = Trace((0, 10**9), [(k, i * 10**8, (i + 1) * 10**8) for i, k in enumerate(sorted(kernels))], [])
    for metric in names:
        value = harness.load_module(harness.reader_path(cell.root, metric), metric.replace(".", "_")).read(readings)
        assert value is not None and value > 0, metric
