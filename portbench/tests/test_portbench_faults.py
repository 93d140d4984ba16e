"""The comparison that decides ``correct`` fails what it has to fail, at a size
the CPU holds, with each cell's own limits: the control (the plain reference
in float8, put in the program's place) and the faults a cell can have
(``harness/faults.py``), planted in the timed path underneath an otherwise
whole run.  The program itself passes."""

import pytest

import tiny
from harness import faults

CONTROL = "float8_e4m3fn"
CELLS = tiny.cells()
TRAIN = [n for n in CELLS if tiny.cell(n).traffic["driver"] == "train"]


@pytest.mark.parametrize("name", tiny.cells())
def test_the_program_passes_and_the_control_fails(name):
    cell = tiny.cell(name)
    result, _, _ = tiny.run(cell, control=CONTROL)
    assert result["correct"], result["checks"]
    assert any(v > cell.limits[k] for k, v in result["control"].items()), result["control"]


def test_a_step_that_leaves_its_state_unchanged_fails():
    for name in TRAIN:
        with faults.planted("unchanged"):
            result, _, _ = tiny.run(tiny.cell(name))
        assert not result["correct"]
        assert result["checks"]["change"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_fails(name, fault):
    with faults.planted(fault):
        result, _, _ = tiny.run(tiny.cell(name))
    assert not result["correct"], result["checks"]

