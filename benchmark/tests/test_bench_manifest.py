"""BENCHMARK.json against the contract it is written to, and every cell's
files found by name."""
from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import harness

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$|"
                   r"experts_per_tok|widths|features|outputs)")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def test_top_level_keys_and_sizes():
    m = manifest()
    assert set(m) == TOP_KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16 and 1 <= len(m["command"]) <= 32
    for p in m["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for word in m["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells at this run length fits its 43,200 s
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_use_the_allowed_characters(section):
    m = manifest()
    names = [e["name"] for e in m[section]]
    assert len(names) == len(set(names))
    for e in m[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])


def test_configs_are_used_and_cut_in_depth_only():
    m = manifest()
    used = {w["config"] for w in m["workloads"]}
    files = set()
    for c in m["configs"]:
        assert c["name"] in used
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(m["paths"][0] + "/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as f:
            conf = json.load(f)
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key)
            assert key in conf["reduced_from"]


def test_workloads_and_metrics_follow_the_contract():
    m = manifest()
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    pairs = set()
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        reported = [e for e in m["end_to_end"] if w["name"] in e.get("workloads", [w["name"]])]
        assert "setup_s" in {e["name"] for e in reported} and len(reported) >= 2
        layers = [p for p in m["per_layer"] if w["name"] in p.get("workloads", [w["name"]])]
        assert layers
        for p in layers:
            assert p["moves"] in {e["name"] for e in reported}
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(1, len(m["workloads"]) // 4)
    for p in m["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert p["moves"] in e2e and p["source"] in ("device_trace", "program_span",
                                                        "program_counter", "host_clock")
        if p["name"].endswith("_roofline") or "mfu" in p["name"]:
            assert p["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_each_cells_files_are_found_by_name(cell):
    c = harness.cell(harness.load_manifest(ROOT), ROOT, cell)
    kind = harness.kind_module(c["traffic"]["kind"])
    assert {"program", "control"} <= set(kind.MODES) and callable(kind.tiny)
    for method in ("setup", "window", "end_to_end", "context", "release", "numbers"):
        assert callable(getattr(kind.Run, method))
    assert c["limits"] and all("limit" in v and "lower" in v for v in c["limits"].values())
    for v in c["limits"].values():
        # each limit lies between its two readings: above the program's,
        # below the control's (or the fault's) where there is one
        assert v["lower"] <= v["limit"] and (v["upper"] is None or v["limit"] < v["upper"])
    for p in c["per_layer"]:
        reader = harness.metric_reader(p["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES, reader.SOURCE) == \
            (p["unit"], p["layer"], p["moves"], p["source"])


def test_one_layer_one_name():
    m = manifest()
    by_module = {}
    for p in m["per_layer"]:
        by_module.setdefault(p["layer"], []).append(p["name"])
    assert set(by_module) == {"trainer loop", "policy and update", "host dispatch of the collect",
                              "kernels", "model step", "device"}


def test_a_missing_cell_is_named():
    with pytest.raises(harness.CellError, match="no workload"):
        harness.cell(harness.load_manifest(ROOT), ROOT, "no_such.cell")
