"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`. The cell's
traffic kind names its driver, `benchmark/kinds/<kind>.py` (see
`harness`); a cell whose files or driver are missing exits 2 before any
device work. It needs CUDA and the cell's number of cards; without them
it exits non-zero and prints no result. Set-up (process start to the
window's start: imports, the kernels' build or load, the env, the policy,
the warm-up) is `setup_s`.
With `--trace 0` the line holds the cell's end-to-end metrics; with
`--trace 1` its per-layer metrics, read from torch.profiler and the
benchmark's own spans, and the device's busy and window seconds. After
the window: the peak memory is read, the program's state is freed, the
reference judges what the timed path kept (`correct`), and the process
must hold no JAX module. The compared numbers and their limits are the
last lines of standard error and the last key of the line.
"""
from __future__ import annotations

import argparse
import gc
import os
import sys

from . import harness


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_env(root: str) -> None:
    """Fixed cache directories inside the checkout for anything that
    builds kernels (the program's own build directory is its package's
    `_build/`); the backend override of the program's aero selection is
    dropped, since each configuration names its backend."""
    cache = os.path.join(root, "benchmark", "_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.pop("NEURALPLANE_AERO_BACKEND", None)


def driver(cell: dict, seed: int, device: str = "cuda"):
    """The cell's run, by its traffic kind's module (`benchmark/kinds/`)."""
    return harness.kind_module(cell["traffic"]["kind"]).Run(cell, seed, device)


def per_layer(cell: dict, ctx: dict) -> dict:
    out = {}
    for m in cell["per_layer"]:
        value = harness.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(cell: dict, seed: int, seconds: float, trace_on: bool, device: str = "cuda"):
    """Set-up, window, metrics, release, comparison. Returns (result line
    without checks, {number: {value, limit, ok}})."""
    import torch

    from .trace import Trace
    cuda = device == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False   # the networks are float32
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    run = driver(cell, seed, device)
    run.setup()
    setup_s = harness.process_age_s()
    tracer = Trace() if trace_on else None
    w = run.window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = {}
    device_line = harness.device_info(cell["chips"], peak) if cuda else {}
    if trace_on:
        metrics = per_layer(cell, run.context(w, tracer))
        device_line.update(busy_s=tracer.busy_s(), window_s=tracer.window_s)
        breakdown = {"device_ops": tracer.top_ops(), "idle_gaps": tracer.idle_gaps()}
    else:
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        values = dict(run.end_to_end(w), setup_s=setup_s, peak_mem_mib=peak / 2 ** 20)
        metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items() if k in units}
    run.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = run.numbers("program")
    checks = harness.judge_line(numbers, cell["limits"])
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": w["steps"] if "steps" in w else w["iterations"],
              "failed": sum(not c["ok"] for c in checks.values()),
              "metrics": metrics, "device": device_line}
    if trace_on:
        result["breakdown"] = breakdown
    return result, checks


def main(argv=None) -> int:
    args = parse(argv)
    root = os.getcwd()
    cache_env(root)
    try:
        cell = harness.cell(harness.load_manifest(root), root, args.workload)
    except harness.CellError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = execute(cell, args.seed, args.seconds, bool(args.trace))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: modules that may not be loaded are: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
