"""Learning-curve rows of training runs' `metrics.jsonl`, side by side.

  python tools/curve_table.py results/heading/metrics.jsonl \
      results/heading_torch/metrics.jsonl --labels JAX port

Prints a markdown table with one row per step of the heading report's rows
(3e6, 6.3e7, 1.23e8, ... 4.83e8 every 6e7, then 5.16e8 and every 6e7 after
it) up to `--upto` (default: the shortest run's last step, which is added
as the last row), and for each run the logged episode's targets reached and
episodes failed per rollout, the success share reached / (reached + failed)
and `average_episode_rewards`; "-" where a run logged no episode at that
step. Then, for each run, the first step at which the success share
reaches each of `--crossings`. Reads any `metrics.jsonl` whose lines carry
`step`, `episodes_reached_target`, `episodes_failed` and
`average_episode_rewards` (both packages' runners write them). Imports
neither JAX nor matplotlib.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

# results/heading/REPORT.md's rows, then every 6e7 after its last
REPORT_ROWS = [3_000_000 + 60_000_000 * k for k in range(9)] + [516_000_000]
ROW_STEP = 60_000_000


def read_metrics(path: str) -> Dict[int, dict]:
    """step -> record; a later line for the same step replaces an earlier."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                rec = json.loads(line)
                out[int(rec["step"])] = rec
    return out


def success(rec: dict) -> float:
    reached, failed = rec["episodes_reached_target"], rec["episodes_failed"]
    return reached / (reached + failed) if reached + failed else 0.0


def row_steps(upto: int) -> List[int]:
    steps = [s for s in REPORT_ROWS if s <= upto]
    s = REPORT_ROWS[-1] + ROW_STEP
    while s <= upto:
        steps.append(s)
        s += ROW_STEP
    if not steps or steps[-1] != upto:
        steps.append(upto)
    return steps


def cells(rec: Optional[dict]) -> List[str]:
    if rec is None:
        return ["-"] * 4
    return [f"{rec['episodes_reached_target']:.0f}", f"{rec['episodes_failed']:.0f}",
            f"{100 * success(rec):.1f}%", f"{rec['average_episode_rewards']:.1f}"]


def table(runs: Sequence[Dict[int, dict]], labels: Sequence[str],
          upto: Optional[int] = None) -> List[str]:
    """The markdown lines of the side-by-side table."""
    upto = upto if upto is not None else min(max(r) for r in runs)
    head = ["env steps"]
    for lab in labels:
        head += [f"{lab} reached", f"{lab} failed", f"{lab} success", f"{lab} avg reward"]
    lines = ["| " + " | ".join(head) + " |", "|" + "---|" * len(head)]
    for s in row_steps(upto):
        row = [f"{s:,}"]
        for r in runs:
            row += cells(r.get(s))
        lines.append("| " + " | ".join(row) + " |")
    return lines


def first_crossing(run: Dict[int, dict], share: float) -> Optional[int]:
    for s in sorted(run):
        if success(run[s]) >= share:
            return s
    return None


def crossing_lines(runs: Sequence[Dict[int, dict]], labels: Sequence[str],
                   shares: Sequence[float]) -> List[str]:
    out = []
    for run, lab in zip(runs, labels):
        parts = []
        for share in shares:
            s = first_crossing(run, share)
            parts.append(f">= {100 * share:g}% at {s:,}" if s is not None
                         else f">= {100 * share:g}% not reached")
        out.append(f"{lab}: first logged success share " + ", ".join(parts)
                   + f" (last step {max(run):,})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("metrics", nargs="+", help="metrics.jsonl files")
    ap.add_argument("--labels", nargs="+", default=None)
    ap.add_argument("--upto", type=float, default=None)
    ap.add_argument("--crossings", type=float, nargs="*", default=[0.05, 0.4, 0.9, 0.99])
    args = ap.parse_args(argv)
    labels = args.labels or [f"run {i}" for i in range(len(args.metrics))]
    if len(labels) != len(args.metrics):
        raise SystemExit("curve_table: one label per metrics file")
    runs = [read_metrics(p) for p in args.metrics]
    upto = int(args.upto) if args.upto is not None else None
    print("\n".join(table(runs, labels, upto)))
    if args.crossings:
        print()
        print("\n".join(crossing_lines(runs, labels, args.crossings)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
