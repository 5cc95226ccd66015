"""On the card: the control, the reference in the program's place at the
precision below the configuration's, comes out not correct, at a size a
test run holds (each cell's own configuration at 224, with the fewer
images that its driver's `TEST_TRAFFIC` names).

    python3 -m pytest benchmark/tests -m cuda

Skips where there is no card (decided inside the test)."""

from __future__ import annotations

import copy
import time

import pytest

from benchmark import control as control_cli
from benchmark.lib import harness

from .conftest import CELLS

@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_number(name, cuda_device):
    cell = harness.resolve(name)
    cell.workload = copy.deepcopy(cell.workload)
    driver = harness.load_driver(cell)
    cell.workload["traffic"].update(driver.TEST_TRAFFIC["cuda"])
    ctx = harness.Context(cell, 2**33 + 21, 1.0, False, cuda_device, time.monotonic())
    numbers = driver.control(ctx, control_cli.CONTROL_PRECISION[cell.config["precision"]])
    over = {k: v for k, v in numbers.items() if k in ctx.limits and not v <= ctx.limits[k]}
    assert over, (numbers, ctx.limits)
