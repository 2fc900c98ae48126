"""Learning-curve rows of training runs' `metrics.jsonl`, side by side.

  python tools/curve_table.py results/heading/metrics.jsonl \
      results/heading_torch/metrics.jsonl --labels JAX port

Prints a markdown table with one row per step of the heading report's rows
(3e6, 6.3e7, 1.23e8, ... 4.83e8 every 6e7, then 5.16e8 and every 6e7 after
it), or of `--rows` (steps, or `start:stop:step` ranges with the stop
included, e.g. `--rows 1e6:6.1e7:1e7` for the tracking run's), up to
`--upto` (default: the shortest run's last step, which is added as the
last row), and for each run the logged episode's targets reached and
episodes failed per rollout, the success share reached / (reached + failed)
and `average_episode_rewards`; "-" where a run logged no episode at that
step. Then, for each run, the first step at which the success share
reaches each of `--crossings`: the logged episode's share, or with
`--window K` the mean share of the last K logged episodes. `--spans
start:stop ...` then prints, for each run and span, the mean and standard
deviation of the success share and of `average_episode_rewards` over the
logged episodes with start <= step <= stop.

`--episode-rows START:STOP ...` (one range per metrics file, 1-based
line numbers of its episode lines, the stop included) aligns the runs by
episode instead of by step: each run's lines START..STOP become episodes
1, 2, ... in file order, and `--rows`, `--upto`, the crossings and
`--spans` then count episodes. A run whose step axis restarts on a
resume (the JAX control run's rows 267 and 352 both log 809,000,000) or
carries another offset cannot be aligned by step:

  python tools/curve_table.py results/control/metrics.jsonl \
      results/control_torch_stepstart/metrics.jsonl --labels JAX port \
      --episode-rows 267:347 4:84 --rows 1:81:10 --window 10

`--terms` adds the shaped term of the reward per episode end beside each
run's average: a control or heading episode's reward is the shaped
(posture or heading) term plus the event term, +200 per target reached and
-200 per episode failed, and the episode ends are reached + failed, so
the shaped term per end is `average_episode_rewards` - 200 x (2 s - 1)
(`tools/heading_collect_compare.py --reward-terms` checks this identity
on a collect of each package). The spans then give its mean and sd too,
the episode ends per rollout, and with `--rollout N` (agent-steps per
logged episode, e.g. 9e6 for 3000 envs x 3000 steps) the shaped term per
agent-step, the shaped sum over the rollout's steps: shaped/end x ends / N.

Reads any `metrics.jsonl` whose lines carry
`step`, `episodes_reached_target`, `episodes_failed` and
`average_episode_rewards` (both packages' runners write them). Imports
neither JAX nor matplotlib.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Dict, List, Optional, Sequence

# results/heading/REPORT.md's rows, then every 6e7 after its last
REPORT_ROWS = [3_000_000 + 60_000_000 * k for k in range(9)] + [516_000_000]
ROW_STEP = 60_000_000
EVENT_REWARD = 200.0   # rewards.event_driven_reward's size


def read_metrics(path: str) -> Dict[int, dict]:
    """step -> record; a later line for the same step replaces an earlier."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                rec = json.loads(line)
                out[int(rec["step"])] = rec
    return out


def read_episode_rows(path: str, start: int, stop: int) -> Dict[int, dict]:
    """Episode k (from 1) -> the file's episode line start - 1 + k, for the
    1-based episode lines start..stop in file order (eval lines skipped)."""
    with open(path, encoding="utf-8") as f:
        recs = [rec for rec in map(json.loads, filter(str.strip, f))
                if "average_episode_rewards" in rec]
    if not 1 <= start <= stop <= len(recs):
        raise SystemExit(f"curve_table: {path} has {len(recs)} episode lines, "
                         f"not {start}:{stop}")
    return {k: rec for k, rec in enumerate(recs[start - 1:stop], 1)}


def success(rec: dict) -> float:
    reached, failed = rec["episodes_reached_target"], rec["episodes_failed"]
    return reached / (reached + failed) if reached + failed else 0.0


def shaped_per_end(rec: dict) -> float:
    """The shaped term of the reward per episode end: the average episode
    reward less the event term's 200 x (reached - failed) / (reached + failed)."""
    reached, failed = rec["episodes_reached_target"], rec["episodes_failed"]
    return rec["average_episode_rewards"] - EVENT_REWARD * (2 * success(rec) - 1) \
        if reached + failed else rec["average_episode_rewards"]


def parse_rows(tokens: Sequence[str]) -> List[int]:
    """`--rows` tokens: a step, or start:stop:step with the stop included."""
    steps = []
    for tok in tokens:
        parts = [int(float(x)) for x in tok.split(":")]
        if len(parts) == 1:
            steps.append(parts[0])
        elif len(parts) == 3 and parts[2] > 0:
            steps.extend(range(parts[0], parts[1] + 1, parts[2]))
        else:
            raise SystemExit(f"curve_table: bad --rows entry {tok!r}")
    return sorted(set(steps))


def row_steps(upto: int, rows: Optional[Sequence[int]] = None) -> List[int]:
    if rows is not None:
        steps = [s for s in rows if s <= upto]
    else:
        steps = [s for s in REPORT_ROWS if s <= upto]
        s = REPORT_ROWS[-1] + ROW_STEP
        while s <= upto:
            steps.append(s)
            s += ROW_STEP
    if not steps or steps[-1] != upto:
        steps.append(upto)
    return steps


def cells(rec: Optional[dict], terms: bool = False) -> List[str]:
    if rec is None:
        return ["-"] * (5 if terms else 4)
    out = [f"{rec['episodes_reached_target']:.0f}", f"{rec['episodes_failed']:.0f}",
           f"{100 * success(rec):.1f}%", f"{rec['average_episode_rewards']:.1f}"]
    return out + [f"{shaped_per_end(rec):.1f}"] if terms else out


def table(runs: Sequence[Dict[int, dict]], labels: Sequence[str],
          upto: Optional[int] = None, rows: Optional[Sequence[int]] = None,
          unit: str = "env steps", terms: bool = False) -> List[str]:
    """The markdown lines of the side-by-side table."""
    upto = upto if upto is not None else min(max(r) for r in runs)
    head = [unit]
    for lab in labels:
        head += [f"{lab} reached", f"{lab} failed", f"{lab} success", f"{lab} avg reward"]
        head += [f"{lab} shaped/end"] if terms else []
    lines = ["| " + " | ".join(head) + " |", "|" + "---|" * len(head)]
    for s in row_steps(upto, rows):
        row = [f"{s:,}"]
        for r in runs:
            row += cells(r.get(s), terms)
        lines.append("| " + " | ".join(row) + " |")
    return lines


def first_crossing(run: Dict[int, dict], share: float) -> Optional[int]:
    return first_window_crossing(run, share, 1)


def first_window_crossing(run: Dict[int, dict], share: float, window: int) -> Optional[int]:
    """The step of the first logged episode at which the mean success share
    of it and the window - 1 logged episodes before it reaches `share`."""
    steps = sorted(run)
    shares = [success(run[s]) for s in steps]
    for i in range(window - 1, len(steps)):
        if sum(shares[i - window + 1:i + 1]) / window >= share:
            return steps[i]
    return None


def crossing_lines(runs: Sequence[Dict[int, dict]], labels: Sequence[str],
                   shares: Sequence[float], window: int = 1,
                   unit: str = "step") -> List[str]:
    what = ("first logged success share" if window == 1
            else f"first rolling {window}-episode success share")
    out = []
    for run, lab in zip(runs, labels):
        parts = []
        for share in shares:
            s = first_window_crossing(run, share, window)
            parts.append(f">= {100 * share:g}% at {'' if unit == 'step' else unit + ' '}{s:,}"
                         if s is not None else f">= {100 * share:g}% not reached")
        out.append(f"{lab}: {what} " + ", ".join(parts) + f" (last {unit} {max(run):,})")
    return out


def span_stats(run: Dict[int, dict], start: int, stop: int) -> Optional[dict]:
    """Mean and sample standard deviation of the success share and the
    reward over the logged episodes with start <= step <= stop."""
    recs = [run[s] for s in sorted(run) if start <= s <= stop]
    if not recs:
        return None
    shares = [success(r) for r in recs]
    rewards = [r["average_episode_rewards"] for r in recs]
    shaped = [shaped_per_end(r) for r in recs]
    ends = [r["episodes_reached_target"] + r["episodes_failed"] for r in recs]

    def sd(xs):
        return statistics.stdev(xs) if len(xs) > 1 else 0.0
    return {"episodes": len(recs), "success": statistics.fmean(shares),
            "success_sd": sd(shares), "reward": statistics.fmean(rewards),
            "reward_sd": sd(rewards), "shaped": statistics.fmean(shaped),
            "shaped_sd": sd(shaped), "ends": statistics.fmean(ends),
            "shaped_sum": statistics.fmean(s * e for s, e in zip(shaped, ends))}


def span_lines(runs: Sequence[Dict[int, dict]], labels: Sequence[str],
               spans: Sequence[str], terms: bool = False,
               rollout: Optional[float] = None) -> List[str]:
    out = []
    for tok in spans:
        start, stop = (int(float(x)) for x in tok.split(":"))
        for run, lab in zip(runs, labels):
            st = span_stats(run, start, stop)
            head = f"{lab} {start:,}-{stop:,}:"
            out.append(f"{head} no logged episode" if st is None else
                       f"{head} {st['episodes']} episodes, success {st['success']:.4f} "
                       f"(sd {st['success_sd']:.4f}), reward {st['reward']:.2f} "
                       f"(sd {st['reward_sd']:.2f})"
                       + (f", shaped/end {st['shaped']:.2f} (sd {st['shaped_sd']:.2f}), "
                          f"ends {st['ends']:.1f}" if terms else "")
                       + (f", shaped/step {st['shaped_sum'] / rollout:.4f}"
                          if terms and rollout else ""))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("metrics", nargs="+", help="metrics.jsonl files")
    ap.add_argument("--labels", nargs="+", default=None)
    ap.add_argument("--upto", type=float, default=None)
    ap.add_argument("--rows", nargs="+", default=None,
                    help="steps or start:stop:step ranges instead of the heading report's")
    ap.add_argument("--crossings", type=float, nargs="*", default=[0.05, 0.4, 0.9, 0.99])
    ap.add_argument("--window", type=int, default=1,
                    help="crossings of the mean share over this many logged episodes")
    ap.add_argument("--spans", nargs="+", default=None, metavar="START:STOP",
                    help="mean and sd of the success share and reward over these steps")
    ap.add_argument("--terms", action="store_true",
                    help="add the reward's shaped term per episode end")
    ap.add_argument("--rollout", type=float, default=None,
                    help="with --terms: agent-steps per logged episode, for the "
                    "spans' shaped term per agent-step")
    ap.add_argument("--episode-rows", nargs="+", default=None, metavar="START:STOP",
                    help="one per file: align the runs by episode, lines START..STOP")
    args = ap.parse_args(argv)
    labels = args.labels or [f"run {i}" for i in range(len(args.metrics))]
    if len(labels) != len(args.metrics):
        raise SystemExit("curve_table: one label per metrics file")
    if args.episode_rows is None:
        runs, unit = [read_metrics(p) for p in args.metrics], "step"
    elif len(args.episode_rows) != len(args.metrics):
        raise SystemExit("curve_table: one --episode-rows range per metrics file")
    else:
        runs = [read_episode_rows(p, *(int(x) for x in tok.split(":")))
                for p, tok in zip(args.metrics, args.episode_rows)]
        unit = "episode"
    upto = int(args.upto) if args.upto is not None else None
    rows = parse_rows(args.rows) if args.rows else None
    print("\n".join(table(runs, labels, upto, rows,
                          "env steps" if unit == "step" else unit, args.terms)))
    if args.crossings:
        print()
        print("\n".join(crossing_lines(runs, labels, args.crossings, args.window, unit)))
    if args.spans:
        print()
        print("\n".join(span_lines(runs, labels, args.spans, args.terms, args.rollout)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
