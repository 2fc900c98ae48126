"""The readings that the limits of `benchmark/limits/` are set from, at a
cell's own size on the card, several seeds in one process:

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 --seconds 3 [--modes ...]

For each seed it runs the cell's set-up and a short window, frees the
program's state, and prints one JSON line per mode with the compared
numbers: "program" (the lower readings), "control" (the reference in the
program's place one precision step below what the configuration states:
float8 surrogate operands, TF32 network products) and the faults a cell
can have ("fault:unchanged", "fault:altered", and for training
"fault:half"), planted in the reference put in the program's place. The
modes are the cell's traffic kind's (`MODES` of `benchmark/kinds/<kind>.py`).
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import torch

from . import harness, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--modes", default="", help="comma-separated; default all of the cell's")
    args = p.parse_args(argv)
    root = os.getcwd()
    run.cache_env(root)
    cell = harness.cell(harness.load_manifest(root), root, args.workload)
    if not torch.cuda.is_available():
        print("benchmark.control: needs CUDA", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    modes = args.modes.split(",") if args.modes else \
        harness.kind_module(cell["traffic"]["kind"]).MODES
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run.driver(cell, seed)
        r.setup()
        r.window(args.seconds)
        r.release()
        gc.collect()
        torch.cuda.empty_cache()
        for mode in modes:
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                              "numbers": r.numbers(mode)}), flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
