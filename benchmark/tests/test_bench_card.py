"""On the card: one short run of each cell, by the command BENCHMARK.json
names, prints a correct result line (skipped without an NVIDIA GPU)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from .conftest import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(cuda_card, repo_root, name):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", name,
                          "--seed", "3000000077", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["kind"] == cuda_card
    assert list(line)[-1] == "checks"
