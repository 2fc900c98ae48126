"""What every cell shares: finding a cell's files by name, the set-up
clock, the device's description, the import check and the result line.

A cell of `BENCHMARK.json` names a configuration and a traffic mix; the
configuration's entry names its file, the traffic is
`benchmark/traffic/<name>.json`, the limits of the cell's comparison, with
the readings they were set from, are `benchmark/limits/<cell>.json` and
each per-layer metric is `benchmark/metrics/<name>.py`. The traffic's
"kind" names its driver, `benchmark/kinds/<kind>.py`, which gives

- `Run(cell, seed, device)`: `setup()`; `window(seconds, tracer)` -> a dict
  with "steps" or "iterations" (the result's `attempted`) and what the
  next three read; `end_to_end(w)` -> the cell's end-to-end metrics but
  `setup_s` and `peak_mem_mib`; `context(w, tracer)` -> what the per-layer
  readers read; `release()`, which frees the program's state;
  `numbers(mode)` -> the compared numbers, judged against the limits;
- `MODES`: the modes of `numbers` that `benchmark.control` reads, the
  program's ("program"), the control's ("control") and each fault's;
- `tiny(cell)`: the cell shrunk in place, and returned, to a size the CPU
  tests hold.

A later cell, configuration, metric or traffic kind is added by adding
files and entries only: a new kind brings its driver, traffic, limits and
readers, and its own planted faults in a test file of its own; the tests
that drive every cell (`tests/test_bench_{reference,control,card}.py`)
read the cells from `BENCHMARK.json`.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import sys
import time
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "neuralplane_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
_T_IMPORTED = time.perf_counter()


class CellError(RuntimeError):
    """The manifest or a cell's files are missing or inconsistent."""


def load_manifest(root: str) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise CellError(f"no BENCHMARK.json in {root}")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _json(path: str) -> dict:
    if not os.path.exists(path):
        raise CellError(f"missing {os.path.relpath(path, os.path.dirname(HERE))}")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cell(manifest: dict, root: str, name: str) -> dict:
    """The cell `name` with its configuration, traffic, limits and the
    metrics it reports ({"end_to_end": [...], "per_layer": [...]} entries of
    the manifest)."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    conf_entry = next((c for c in manifest["configs"] if c["name"] == entry["config"]), None)
    if conf_entry is None:
        raise CellError(f"workload {name!r} names an unknown config {entry['config']!r}")
    config = _json(os.path.join(root, conf_entry["file"]))
    traffic = _json(os.path.join(HERE, "traffic", f"{entry['traffic']}.json"))
    kind_path(traffic.get("kind"))
    limits = _json(os.path.join(HERE, "limits", f"{name}.json"))["numbers"]

    def reported(metric):
        return name in metric.get("workloads", [name])
    return {"name": name, "chips": entry["chips"], "config": config, "traffic": traffic,
            "limits": limits,
            "end_to_end": [m for m in manifest["end_to_end"] if reported(m)],
            "per_layer": [m for m in manifest["per_layer"] if reported(m)]}


def metric_reader(name: str):
    """The module of per-layer metric `name` (benchmark/metrics/<name>.py):
    UNIT, LAYER, MOVES, SOURCE and read(ctx) -> number or None."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise CellError(f"no reader benchmark/metrics/{name}.py")
    return _load(f"benchmark_metric_{name.replace('.', '_')}", path)


def kind_path(kind) -> str:
    """The file of traffic kind `kind`'s driver; a kind whose name is not a
    plain name (as a manifest name, with no "..") or that has no file is
    refused."""
    path = os.path.join(HERE, "kinds", f"{kind}.py")
    if not (isinstance(kind, str) and NAME.match(kind) and ".." not in kind
            and os.path.isfile(path)):
        raise CellError(f"traffic kind {kind!r} has no driver")
    return path


def kind_module(kind: str):
    """The driver module of traffic kind `kind` (benchmark/kinds/<kind>.py):
    Run, MODES and tiny(cell)."""
    return _load(f"benchmark_kind_{kind.replace('.', '_')}", kind_path(kind))


def _load(module: str, path: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time, to
    10 ms), or since this module was imported where /proc is not there."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORTED


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark may not
    load, compared whole (`neuralplane_tpu_torch` is not `neuralplane_tpu`)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(count: int, peak_bytes: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def judge_line(numbers: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """Each compared number beside its limit; a number that is not finite
    or has no limit fails."""
    out = {}
    for k, v in numbers.items():
        lim = limits.get(k, {}).get("limit")
        ok = lim is not None and math.isfinite(v) and v <= lim
        out[k] = {"value": v, "limit": lim, "ok": ok}
    return out


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output, its checks under the last key."""
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr, flush=True)
    result = dict(result)
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
