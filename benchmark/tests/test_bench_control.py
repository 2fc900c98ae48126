"""The control comes out not correct: the reference put in the program's
place one precision step below what the configuration states (float8
surrogate operands; for training also TF32 network products), judged
against the cell's limits at a size a test run holds. The same readings at
the cells' own sizes on the card come from `python3 -m benchmark.control`."""
from __future__ import annotations

import pytest

from benchmark import harness, run

from .conftest import CELLS, SEED, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name):
    cell = tiny_cell(name)
    r = run.driver(cell, SEED, "cpu")
    r.setup()
    r.window(0.0)
    r.release()
    checks = harness.judge_line(r.numbers("control"), cell["limits"])
    assert not all(c["ok"] for c in checks.values()), checks
    program = harness.judge_line(r.numbers("program"), cell["limits"])
    assert all(c["ok"] for c in program.values()), program
