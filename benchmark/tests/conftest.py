"""Shared helpers of the benchmark's CPU tests: cells of BENCHMARK.json
shrunk to a size a test run holds (the same code paths, the program on its
plain CPU versions)."""
from __future__ import annotations

import copy
import os

import pytest

from benchmark import harness

ROOT = harness.ROOT
SEED = 3_000_000_019   # beyond 32 signed bits: a run takes any seed up to a little over 2**31


def tiny_cell(name: str) -> dict:
    cell = copy.deepcopy(harness.cell(harness.load_manifest(ROOT), ROOT, name))
    if cell["traffic"]["kind"] == "sim":
        cell["traffic"].update(aircraft=256, check_rows=128, check_within=40, warmup_steps=2)
    else:
        cell["config"].update(n_rollout_threads=6, buffer_size=16, data_chunk_length=4,
                              num_mini_batch=3, ppo_epoch=2)
        cell["traffic"].update(check_envs=4)
    return cell


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
