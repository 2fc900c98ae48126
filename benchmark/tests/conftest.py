"""Shared helpers of the benchmark's CPU tests: the cells of BENCHMARK.json,
shrunk by their traffic kind's `tiny` to a size a test run holds (the same
code paths, the program on its plain CPU versions)."""
from __future__ import annotations

import copy
import os

import pytest

from benchmark import harness

ROOT = harness.ROOT
SEED = 3_000_000_019   # beyond 32 signed bits: a run takes any seed up to a little over 2**31
CELLS = [w["name"] for w in harness.load_manifest(ROOT)["workloads"]]


def kind_of(name: str) -> str:
    return harness.cell(harness.load_manifest(ROOT), ROOT, name)["traffic"]["kind"]


def tiny_cell(name: str) -> dict:
    cell = copy.deepcopy(harness.cell(harness.load_manifest(ROOT), ROOT, name))
    return harness.kind_module(cell["traffic"]["kind"]).tiny(cell)


@pytest.fixture
def cuda_card():
    """Skips a test that needs the card where there is none; decided here,
    when the test runs, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.cuda.get_device_name(0)


@pytest.fixture
def repo_root(monkeypatch):
    monkeypatch.chdir(ROOT)
    return os.getcwd()
