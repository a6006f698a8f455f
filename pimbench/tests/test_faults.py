"""The checks fail where they must: the control (the reference one
precision lower in the program's place) and each fault planted in the
timed path (`pimbench/faults.py`) come out not correct, at a tiny size on
the CPU.  The cells are one chip each, so the exchange between chips has
no fault to plant."""

import pytest

from pimbench.tests.conftest import run_cell

CELLS = ["cornell-render", "cornell-train", "cornell-bake"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(root, capsys, workload):
    rc, line, err = run_cell(root, workload, capsys, "--control")
    assert rc == 0, err
    assert line["correct"] is False and line["failed"] >= 1


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_planted_fault_is_not_correct(root, capsys, restore_program, workload, fault):
    rc, line, err = run_cell(root, workload, capsys, "--fault", fault)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]
