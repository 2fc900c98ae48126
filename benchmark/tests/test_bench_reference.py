"""The reference against the port's plain path on the CPU at a tiny size:
a whole run of each cell (set-up, window, comparison) comes out correct,
the Philox twin meets the known answers, and the reference imports nothing
of the program."""
from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.reference import philox, policy

from .conftest import CELLS, ROOT, SEED, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_agrees_with_the_reference(name):
    result, checks = run.execute(tiny_cell(name), SEED, 0.0, False, device="cpu")
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 1
    for c in checks.values():
        assert c["value"] <= c["limit"]


def test_the_sim_window_resets_aircraft():
    r = run.driver(tiny_cell("control_distilled.sim_1e6"), SEED, "cpu")
    r.setup()
    r.window(0.0)
    resets = sum(int((x["x"]["is_done"] | x["x"]["bad_done"]).sum()) for x, _ in r.kept.values())
    assert resets > 0


def test_philox_known_answers():
    for ctr, key, want in philox.KNOWN_ANSWERS:
        got = philox.philox4x32_10([np.array([c], np.uint32) for c in ctr], key)
        assert tuple(int(g[0]) for g in got) == want
    u = philox.uniforms((1, 2), np.arange(1000), range(2))
    assert u.shape == (8, 1000) and (u >= 0).all() and (u < 1).all()


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -3.0 - 2 ** -12])
    assert policy.to_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, -3.0]


def test_the_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(ROOT, "benchmark", "reference")
    for fn in os.listdir(ref_dir):
        if not fn.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref_dir, fn), encoding="utf-8").read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy", "math", "typing", "__future__"), \
                    f"{fn} imports {n}"
