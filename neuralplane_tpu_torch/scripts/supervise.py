"""Elastic training supervisor: stall detection and checkpoint auto-resume
(counterpart of neuralplane_tpu/scripts/supervise.py).

  python -m neuralplane_tpu_torch.scripts.supervise \
      --run-dir runs/exp --stall-timeout 300 --max-restarts 10 -- \
      --env-name Control --scenario-name heading --num-env-steps 1.35e9 ...

It launches the port's train CLI (`--train-module`, default
`neuralplane_tpu_torch.scripts.train`) in its own process group with
`--run-dir <run>/leg_<k>`, watches that leg's `metrics.jsonl` for progress,
and on a stall kills the EXACT process group (never by name or pattern) and
relaunches from the leg's latest checkpoint (`checkpoints/state_latest.pt`,
or a trainer's `state_latest.pkl`) with `--model-dir <file>` and the
remaining step budget. When the budget is done it merges the legs' metrics
into `<run>/metrics.jsonl` with step/wall offsets so downstream tooling sees
one continuous run.

Stall detection is progress-based (metrics mtime), not liveness-based: a
wedged process is alive but silent, and so is a slow start, so the timeout
must exceed the worst-case time to the first logged episode (the 600 s
default covers the kernels' first build and a first episode).

Resume budgets are computed from the last LOGGED step of the killed leg,
so run supervised trainings with `--log-interval 1`; sparser logging makes
a resumed leg re-train up to log_interval-1 episodes.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional, Tuple


def _read_last_metrics(path: str) -> Optional[dict]:
    try:
        last = None
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    last = line
        return json.loads(last) if last else None
    except (OSError, json.JSONDecodeError):
        return None


def _strip_arg(args: List[str], name: str) -> Tuple[List[str], Optional[str]]:
    """Remove `name <value>` (or `name=<value>`) from an arg list."""
    out, val, i = [], None, 0
    while i < len(args):
        a = args[i]
        if a == name and i + 1 < len(args):
            val = args[i + 1]
            i += 2
        elif a.startswith(name + "="):
            val = a.split("=", 1)[1]
            i += 1
        else:
            out.append(a)
            i += 1
    return out, val


def merge_legs(run_dir: str, legs: List[str]) -> int:
    """Concatenate leg metrics with step/wall offsets -> run_dir/metrics.jsonl.

    Returns the total step count. Rows without a `step` key are dropped.
    """
    rows: List[dict] = []
    off_step, off_wall = 0, 0.0
    for leg in legs:
        path = os.path.join(leg, "metrics.jsonl")
        last_step, last_wall = 0, 0.0
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    r = json.loads(line)
                    if "step" not in r:
                        continue
                    r["step"] += off_step
                    r["wall_s"] = round(r.get("wall_s", 0.0) + off_wall, 2)
                    last_step, last_wall = r["step"], r["wall_s"]
                    rows.append(r)
        except OSError:
            continue
        off_step, off_wall = last_step, last_wall
    with open(os.path.join(run_dir, "metrics.jsonl"), "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return off_step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "neuralplane_tpu_torch.supervise",
        usage="supervise [supervisor flags] -- [train flags]")
    p.add_argument("--run-dir", required=True)
    p.add_argument("--stall-timeout", type=float, default=600.0,
                   help="seconds without metrics progress before the leg "
                   "is declared wedged (must exceed cold-compile latency)")
    p.add_argument("--poll-interval", type=float, default=15.0)
    p.add_argument("--max-restarts", type=int, default=10)
    p.add_argument("--train-module", default="neuralplane_tpu_torch.scripts.train",
                   help=argparse.SUPPRESS)  # test seam: stub trainer
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="train CLI args after `--`")
    args = p.parse_args(argv)
    train_args = args.train_args
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]

    # the supervisor owns run-dir/model-dir/step-budget bookkeeping
    train_args, _ = _strip_arg(train_args, "--run-dir")
    train_args, model_dir = _strip_arg(train_args, "--model-dir")
    train_args, budget_s = _strip_arg(train_args, "--num-env-steps")
    total_budget = int(float(budget_s)) if budget_s else int(1e7)

    os.makedirs(args.run_dir, exist_ok=True)
    legs: List[str] = []
    done_steps = 0

    for attempt in range(args.max_restarts + 1):
        remaining = total_budget - done_steps
        if remaining <= 0:
            break
        leg_dir = os.path.join(args.run_dir, f"leg_{attempt}")
        legs.append(leg_dir)
        cmd = [sys.executable, "-m", args.train_module,
               *train_args, "--run-dir", leg_dir,
               "--num-env-steps", str(remaining)]
        if model_dir:
            cmd += ["--model-dir", model_dir]
        print(f"[supervise] leg {attempt}: {remaining} steps "
              f"{'(resume ' + model_dir + ')' if model_dir else '(fresh)'}",
              flush=True)
        # own process group so a wedge is killable by EXACT pgid
        child = subprocess.Popen(cmd, start_new_session=True)
        metrics = os.path.join(leg_dir, "metrics.jsonl")
        last_progress = time.time()
        last_mtime = 0.0
        stalled = False
        while True:
            rc = child.poll()
            if rc is not None:
                break
            time.sleep(args.poll_interval)
            try:
                mtime = os.path.getmtime(metrics)
            except OSError:
                mtime = 0.0
            if mtime > last_mtime:
                last_mtime = mtime
                last_progress = time.time()
            elif time.time() - last_progress > args.stall_timeout:
                stalled = True
                print(f"[supervise] leg {attempt} wedged "
                      f"({args.stall_timeout:.0f}s without metrics "
                      f"progress); killing pgid {child.pid}", flush=True)
                os.killpg(os.getpgid(child.pid), signal.SIGKILL)
                child.wait()
                break

        last = _read_last_metrics(metrics)
        leg_steps = int(last["step"]) if last and "step" in last else 0
        done_steps += leg_steps
        for name in ("state_latest.pt", "state_latest.pkl"):
            ckpt = os.path.join(leg_dir, "checkpoints", name)
            if os.path.exists(ckpt):
                model_dir = ckpt
                break
        if not stalled and child.returncode == 0:
            break
        if not stalled and child.returncode != 0 and leg_steps == 0:
            # crashed before any progress: a config error, not a wedge -
            # restarting would loop forever on the same failure
            print(f"[supervise] leg {attempt} failed rc={child.returncode} "
                  "with zero progress; giving up", flush=True)
            merge_legs(args.run_dir, legs)
            return child.returncode or 1

    total = merge_legs(args.run_dir, legs)
    print(f"[supervise] done: {total} steps over {len(legs)} leg(s) "
          f"-> {os.path.join(args.run_dir, 'metrics.jsonl')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
