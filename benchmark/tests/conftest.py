"""Shared pieces of the benchmark's tests: each cell at its architecture's
tiny configuration (`reference.TINY`), which lets every cell run end to end
on the CPU, where each kernel wrapper runs its plain PyTorch version, at
the small traffic its driver names (`TEST_TRAFFIC`). The cells are
BENCHMARK.json's: no test names one."""

from __future__ import annotations

import copy
import json
import pathlib
import time

import pytest
import torch

from benchmark.lib import harness


def manifest(root: pathlib.Path = harness.ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cells(root: pathlib.Path = harness.ROOT) -> tuple[str, ...]:
    return tuple(w["name"] for w in manifest(root)["workloads"])


CELLS = cells()


def tiny_cell(name: str, root: pathlib.Path = harness.ROOT) -> harness.Cell:
    """The cell as BENCHMARK.json defines it (driver, limits, metrics), at
    its architecture's tiny configuration in its configuration's precision,
    with small traffic."""
    cell = harness.resolve(name, root)
    cell.config = dict(cell.arch.reference.TINY, precision=cell.config["precision"])
    cell.workload = copy.deepcopy(cell.workload)
    cell.workload["traffic"].update(harness.load_driver(cell).TEST_TRAFFIC["cpu"])
    return cell


def run_tiny(cell: harness.Cell, *, seed: int = 2**33 + 5, seconds: float = 0.6, trace: bool = False) -> dict:
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.monotonic())


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels")
    return torch.device("cuda", 0)
