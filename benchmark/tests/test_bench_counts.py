"""The yardstick's counts at small n against the repo's recorded figures:
57,620 FLOP per aircraft for the 43 nets, 193,752 for the distilled trunk
(the trunk's widths read from its npz), and the step's bytes."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from benchmark import counts

from .conftest import ROOT


def config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json"), encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_surrogate_flops_match_the_recorded_counts(n):
    assert counts.surrogate_flops(config("heading_43nets")["surrogate"]) * n == 57_620 * n
    assert counts.surrogate_flops(config("control_distilled")["surrogate"]) * n == 193_752 * n


def test_the_trunks_widths_are_its_npzs():
    s = config("control_distilled")["surrogate"]
    with np.load(os.path.join(ROOT, s["file"])) as z:
        H, F = z["W1"].shape
        assert (H, F) == (s["hidden"], s["features"]) and len(z["names"]) == s["outputs"]
        # the trunk_flops formula: 2 n (H F + H H + 43 (H + F))
        assert counts.surrogate_flops(s) == 2.0 * (H * F + H * H + 43 * (H + F))


def test_step_bytes_and_bounds():
    assert counts.STEP_READ_BYTES + counts.STEP_WRITE_BYTES == 275
    n = 1_000_000
    # distilled: bound by operations (0.196 ms); 43 nets: by bytes (0.082 ms)
    d = counts.env_step_bound_s(config("control_distilled")["surrogate"], n)
    g = counts.env_step_bound_s(config("heading_43nets")["surrogate"], n)
    assert d == pytest.approx(193_752 * n / 989e12)
    assert g == pytest.approx((275 * n + counts.surrogate_weight_bytes(
        config("heading_43nets")["surrogate"])) / 3.35e12)


def test_training_flops():
    c = config("heading_43nets")
    f = counts.network_flops(c["networks"], 22, 4)
    # ~0.6 MFLOP per forward of actor and critic
    assert 5.9e5 < f["actor"] + f["critic"] < 6.1e5
    it = counts.train_iteration_flops(c, 22, 4)
    assert set(it) == {"bf16", "float32"}
    # the update's 16 epochs over 3e6 samples dominate: ~8.7e13 FLOP
    assert 8.5e13 < it["float32"] < 9.0e13
    assert it["bf16"] == 57_620 * 3000 * 1000
