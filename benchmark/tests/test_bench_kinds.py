"""A traffic kind joins the benchmark as added files: its driver
`benchmark/kinds/<kind>.py`, its traffic, its limits and entries in
BENCHMARK.json, with no file that is there edited. A kind with no file, or
whose name is not a plain name, is refused before any driver is imported."""
from __future__ import annotations

import filecmp
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.sim import SimRun
from benchmark.training import TrainRun

from .conftest import ROOT

CELL = "heading_43nets.stub"

STUB_KIND = '''"""Traffic kind "stub": doubles a vector from the seed `steps` times."""
import time

import torch

MODES = ("program", "control")


def tiny(cell):
    return cell


class Run:
    def __init__(self, cell, seed, device="cuda"):
        self.steps, self.seed = int(cell["traffic"]["steps"]), seed

    def setup(self):
        self.x = torch.rand(8, generator=torch.Generator().manual_seed(self.seed))

    def window(self, seconds, tracer=None):
        t0 = time.perf_counter()
        for _ in range(self.steps):
            self.y = self.x * 2.0
        return {"steps": self.steps, "window_s": max(time.perf_counter() - t0, 1e-9)}

    def end_to_end(self, w):
        return {"sim_agent_steps_per_s": w["steps"] / w["window_s"]}

    def context(self, w, tracer):
        return {}

    def release(self):
        pass

    def numbers(self, mode="program"):
        y = self.y if mode == "program" else self.y + 1.0
        return {"stub_err": float((y - 2.0 * self.x).abs().max())}
'''

DRIVE = '''import os, sys
from benchmark import harness, run
assert harness.HERE == os.path.join(os.getcwd(), "benchmark"), harness.HERE
cell = harness.cell(harness.load_manifest("."), ".", sys.argv[1])
result, checks = run.execute(cell, 3_000_000_019, 0.0, False, device="cpu")
harness.emit(result, checks)
'''

MAIN = '''import json, sys
from benchmark import run
rc = run.main(["--workload", sys.argv[1], "--seed", "1", "--seconds", "1"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] == "torch"
                or m in ("benchmark.sim", "benchmark.training"))
print(json.dumps({"rc": rc, "loaded": loaded}), file=sys.stderr)
'''


def checkout(tmp_path, kind: str, kind_file: bool):
    """A copy of the benchmark's files with one cell of traffic kind `kind`
    added as new files and entries: its traffic, its limits, its driver
    (where `kind_file`), a workload and a place in one end-to-end metric's
    list."""
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    manifest = harness.load_manifest(ROOT)
    manifest["workloads"].append({"name": CELL, "config": "heading_43nets", "traffic": "stub",
                                  "chips": 1, "why": "a kind that the harness has never seen"})
    next(m for m in manifest["end_to_end"]
         if m["name"] == "sim_agent_steps_per_s")["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    (bench / "traffic" / "stub.json").write_text(json.dumps({"kind": kind, "steps": 3}))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"numbers": {"stub_err": {"lower": 0.0, "limit": 0.5, "upper": 1.0}}}))
    if kind_file:
        (bench / "kinds" / f"{kind}.py").write_text(STUB_KIND)
    return root


def python(root, *args) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *args], cwd=root, capture_output=True, text=True,
                          timeout=300)


def test_a_new_kind_is_driven_from_added_files_alone(tmp_path):
    root = checkout(tmp_path, "stub", kind_file=True)
    added = {"kinds/stub.py", "traffic/stub.json", f"limits/{CELL}.json"}
    ours = os.path.join(ROOT, "benchmark")
    for dirpath, dirnames, files in os.walk(root / "benchmark"):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in files:
            rel = os.path.relpath(os.path.join(dirpath, fn), root / "benchmark")
            if rel not in added:
                assert filecmp.cmp(os.path.join(dirpath, fn), os.path.join(ours, rel),
                                   shallow=False), rel
    out = python(root, "-c", DRIVE, CELL)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["attempted"] == 3 and line["failed"] == 0
    assert set(line["metrics"]) == {"sim_agent_steps_per_s", "setup_s", "peak_mem_mib"}
    assert list(line)[-1] == "checks" and set(line["checks"]) == {"stub_err"}


@pytest.mark.parametrize("kind", ["no_such_kind", "../sim"])
def test_a_kind_with_no_file_or_a_path_for_a_name_is_refused(tmp_path, kind):
    root = checkout(tmp_path, kind, kind_file=False)
    out = python(root, "-m", "benchmark.run", "--workload", CELL, "--seed", "1",
                 "--seconds", "1")
    assert out.returncode == 2 and out.stdout == ""
    assert f"traffic kind {kind!r} has no driver" in out.stderr
    out = python(root, "-c", MAIN, CELL)
    assert out.returncode == 0 and out.stdout == "", out.stderr[-4000:]
    probe = json.loads(out.stderr.strip().splitlines()[-1])
    assert probe == {"rc": 2, "loaded": []}   # refused before torch or a driver was imported


@pytest.mark.parametrize("kind", [None, "no_such_kind", "../sim", "sim/../train", "a..b",
                                  "sim.py"])
def test_the_lookup_takes_only_a_plain_name_with_a_file(kind):
    with pytest.raises(harness.CellError, match="has no driver"):
        harness.kind_path(kind)


def test_the_two_kinds_drive_the_existing_runs():
    assert harness.kind_module("sim").Run is SimRun
    assert harness.kind_module("train").Run is TrainRun
