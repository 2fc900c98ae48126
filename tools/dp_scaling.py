#!/usr/bin/env python3
"""Data-parallel scaling of the port's train CLI on the cards of one host.

Runs `python -m torch.distributed.run --standalone --nproc-per-node R -m
neuralplane_tpu_torch.scripts.train --use-mesh` at the heading run's
configuration (phase 15 of chip_smoke.py: buffer 1000, chunks of 8, 5
minibatches, 16 epochs, distilled backend) once per RANKSxENVS spec (ENVS
is the global count), the whole list `--repeat` times in turn, so that
specs alternate on the host. Each run prints its wall time, the backends
its ranks chose and, for every episode but the first (start-up and
warm-up), its seconds (from the metrics records' `wall_s`) and its global
agent-steps per second. The last line is one JSON object: per spec, every
such episode time and their median, and the scaling efficiency of each
multi-rank spec against the one-rank spec with as many envs per rank
(median episode time alone / with peers; 1 is perfect weak scaling):

    python3 tools/dp_scaling.py --out runs/dp_scaling --repeat 3 1x3000 4x12000
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

BUFFER = 1000
HEADING = ["--env-name", "Control", "--scenario-name", "heading", "--buffer-size", str(BUFFER),
           "--num-mini-batch", "5", "--ppo-epoch", "16", "--lr", "3e-4", "--gamma", "0.99",
           "--entropy-coef", "1e-3", "--max-grad-norm", "2", "--data-chunk-length", "8",
           "--log-interval", "1", "--save-interval", "100", "--aero-backend", "distilled"]


def episode_times(run_dir: str):
    """Seconds of each logged episode after the first."""
    with open(os.path.join(run_dir, "metrics.jsonl"), encoding="utf-8") as f:
        walls = [json.loads(line)["wall_s"] for line in f]
    return [round(b - a, 2) for a, b in zip(walls, walls[1:])]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("specs", nargs="+", help="RANKSxENVS, e.g. 4x12000")
    p.add_argument("--out", default="runs/dp_scaling")
    p.add_argument("--episodes", type=int, default=3)
    p.add_argument("--repeat", type=int, default=1)
    args = p.parse_args(argv)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    times = {spec: [] for spec in args.specs}
    for rep in range(args.repeat):
        for spec in args.specs:
            ranks, envs = (int(x) for x in spec.split("x"))
            run_dir = os.path.abspath(os.path.join(args.out, f"{spec}_rep{rep}"))
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc-per-node", str(ranks), "-m", "neuralplane_tpu_torch.scripts.train",
                   *HEADING, "--use-mesh", "--n-rollout-threads", str(envs),
                   "--num-env-steps", str(args.episodes * BUFFER * envs), "--run-dir", run_dir]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            out = proc.stdout + proc.stderr
            backends = sorted(re.findall(r"backend (\w+)", out))
            print(f"{spec} repeat {rep}: exit {proc.returncode}, wall {wall:.1f} s, "
                  f"rank backends {backends}", flush=True)
            if proc.returncode != 0:
                print(out[-4000:])
                return proc.returncode
            eps = episode_times(run_dir)
            times[spec] += eps
            print("  episode s " + json.dumps(eps) + ", agent-steps/s "
                  + json.dumps([round(BUFFER * envs / t) for t in eps]), flush=True)
    summary = {spec: {"episode_s": ts, "median_s": statistics.median(ts)}
               for spec, ts in times.items()}
    for spec, row in summary.items():
        ranks, envs = (int(x) for x in spec.split("x"))
        alone = summary.get(f"1x{envs // ranks}")
        if ranks > 1 and alone:
            row["efficiency"] = alone["median_s"] / row["median_s"]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
