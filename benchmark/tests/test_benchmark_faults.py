"""A run with the timed path broken underneath comes out not correct: each
fault that the cell can have (faults.py), planted under the program, on a
run that skips only the look for a card (roomnet-tiny on the CPU)."""

from __future__ import annotations

import pytest

from benchmark import faults

from .conftest import CELLS, run_tiny, tiny_cell

CASES = [(name, fault) for name in CELLS
         for fault in faults.FAULTS[tiny_cell(name).workload["driver"]]]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_makes_the_run_not_correct(name, fault):
    cell = tiny_cell(name)
    with faults.planted(fault, cell.arch):
        result = run_tiny(cell)
    assert result["correct"] is False, result["checks"]
    over = [k for k, c in result["checks"].items() if not c["value"] <= c["limit"]]
    assert over


def test_planting_restores_the_program():
    arch = tiny_cell(CELLS[0]).arch
    before = arch.program.classifier
    with faults.planted("altered", arch):
        assert arch.program.classifier is not before
    assert arch.program.classifier is before
