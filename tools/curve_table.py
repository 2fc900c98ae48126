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
logged episodes with start <= step <= stop (with `--counts` also the mean
targets reached and episodes failed per logged episode).

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

`--first-episode N` numbers the aligned episodes from N instead of 1 (a
run resumed at its episode 62 aligned with the JAX run's rows 62..300:
`--episode-rows 62:300 1:239 --first-episode 62`). `--reward-crossings
LEVEL ...` prints, for each run, the first step or episode at which the
mean `average_episode_rewards` of the last `--window` logged episodes
reaches each level (the tracking runs' rule).

A metrics argument may join several files with commas, read in order (a
run and its continuation: `results/tracking_torch/metrics.jsonl,
results/tracking_torch_final/metrics.jsonl`). `--continuity K ...`
applies the tracking runs' resume rule after each K, the last run against
the first (`continuity_lines`; `--window` episodes before the resume, the
third after it judged).

`--keys KEY ...` adds a column per run for each logged key (e.g.
`policy_entropy_loss`, the entropy term).

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


def read_lines(path: str) -> List[dict]:
    """The records of `path`, or of several files joined by commas, in order."""
    recs = []
    for part in path.split(","):
        with open(part, encoding="utf-8") as f:
            recs += [json.loads(line) for line in f if line.strip()]
    return recs


def read_metrics(path: str) -> Dict[int, dict]:
    """step -> record; a later line for the same step replaces an earlier."""
    return {int(rec["step"]): rec for rec in read_lines(path)}


def read_episode_rows(path: str, start: int, stop: int, first: int = 1) -> Dict[int, dict]:
    """Episode first - 1 + k -> the file's episode line start - 1 + k, for
    the 1-based episode lines start..stop in file order (eval lines skipped)."""
    recs = [rec for rec in read_lines(path) if "average_episode_rewards" in rec]
    if not 1 <= start <= stop <= len(recs):
        raise SystemExit(f"curve_table: {path} has {len(recs)} episode lines, "
                         f"not {start}:{stop}")
    return {k: rec for k, rec in enumerate(recs[start - 1:stop], first)}


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


def cells(rec: Optional[dict], terms: bool = False, keys: Sequence[str] = ()) -> List[str]:
    if rec is None:
        return ["-"] * ((5 if terms else 4) + len(keys))
    out = [f"{rec['episodes_reached_target']:.0f}", f"{rec['episodes_failed']:.0f}",
           f"{100 * success(rec):.1f}%", f"{rec['average_episode_rewards']:.1f}"]
    out += [f"{shaped_per_end(rec):.1f}"] if terms else []
    return out + [f"{rec[k]:.4g}" for k in keys]


def table(runs: Sequence[Dict[int, dict]], labels: Sequence[str],
          upto: Optional[int] = None, rows: Optional[Sequence[int]] = None,
          unit: str = "env steps", terms: bool = False, keys: Sequence[str] = ()) -> List[str]:
    """The markdown lines of the side-by-side table; `keys` adds a column
    per run for each of these logged keys."""
    upto = upto if upto is not None else min(max(r) for r in runs)
    head = [unit]
    for lab in labels:
        head += [f"{lab} reached", f"{lab} failed", f"{lab} success", f"{lab} avg reward"]
        head += [f"{lab} shaped/end"] if terms else []
        head += [f"{lab} {k}" for k in keys]
    lines = ["| " + " | ".join(head) + " |", "|" + "---|" * len(head)]
    for s in row_steps(upto, rows):
        row = [f"{s:,}"]
        for r in runs:
            row += cells(r.get(s), terms, keys)
        lines.append("| " + " | ".join(row) + " |")
    return lines


def reward(rec: dict) -> float:
    return rec["average_episode_rewards"]


def first_crossing(run: Dict[int, dict], share: float) -> Optional[int]:
    return first_window_crossing(run, share, 1)


def first_window_crossing(run: Dict[int, dict], level: float, window: int,
                          value=success) -> Optional[int]:
    """The step of the first logged episode at which the mean `value` (the
    success share, or `reward`) of it and the window - 1 logged episodes
    before it reaches `level`."""
    steps = sorted(run)
    values = [value(run[s]) for s in steps]
    for i in range(window - 1, len(steps)):
        if sum(values[i - window + 1:i + 1]) / window >= level:
            return steps[i]
    return None


def crossing_lines(runs: Sequence[Dict[int, dict]], labels: Sequence[str],
                   levels: Sequence[float], window: int = 1,
                   unit: str = "step", value=success) -> List[str]:
    name, mean = (("success share", "success share") if value is success
                  else ("reward", "mean reward"))
    what = f"first logged {name}" if window == 1 else f"first rolling {window}-episode {mean}"
    out = []
    for run, lab in zip(runs, labels):
        parts = []
        for level in levels:
            s = first_window_crossing(run, level, window, value)
            tag = f"{100 * level:g}%" if value is success else f"{level:g}"
            parts.append(f">= {tag} at {'' if unit == 'step' else unit + ' '}{s:,}"
                         if s is not None else f">= {tag} not reached")
        out.append(f"{lab}: {what} " + ", ".join(parts) + f" (last {unit} {max(run):,})")
    return out


def continuity_lines(ref: Dict[int, dict], run: Dict[int, dict], resumes: Sequence[int],
                     window: int = 10, after: int = 3, labels: Sequence[str] = ("ref", "run"),
                     unit: str = "step") -> List[str]:
    """The resume rule of the tracking runs: with K a resume's last logged
    episode (or step), m and sd the mean and population standard deviation
    of `run`'s rewards over the `window` logged episodes up to K, and d
    `ref`'s own rise from its mean over the same episodes to its reward
    `after` episodes past K, `run`'s reward there within m + d +- 3 sd, and
    its targets reached within a factor of 1.5 of its mean over the window;
    the first episode past K beside it."""
    out = []
    keys, rkeys = sorted(run), sorted(ref)
    for k in resumes:
        i, j = keys.index(k), rkeys.index(k)
        span = [run[s] for s in keys[i - window + 1:i + 1]]
        rew = [reward(r) for r in span]
        m, sd = statistics.fmean(rew), statistics.pstdev(rew)
        d = reward(ref[rkeys[j + after]]) - statistics.fmean(
            reward(ref[s]) for s in rkeys[j - window + 1:j + 1])
        reached = statistics.fmean(r["episodes_reached_target"] for r in span)
        got, first = run[keys[i + after]], run[keys[i + 1]]
        lo, hi = m + d - 3 * sd, m + d + 3 * sd
        ok_r = lo <= got["average_episode_rewards"] <= hi
        ok_n = reached / 1.5 <= got["episodes_reached_target"] <= reached * 1.5
        out.append(
            f"resume after {unit} {k:,}: {labels[1]} {keys[i - window + 1]:,}-{k:,} reward "
            f"{m:.2f} (sd {sd:.2f}), reached {reached:.1f}; {labels[0]} rise to {unit} "
            f"{keys[i + after]:,} {d:+.2f}; {labels[1]} {unit} {keys[i + after]:,} reward "
            f"{got['average_episode_rewards']:.2f} in {lo:.2f} to {hi:.2f} "
            f"({'holds' if ok_r else 'fails'}), reached {got['episodes_reached_target']:.0f} "
            f"in {reached / 1.5:.1f} to {reached * 1.5:.1f} ({'holds' if ok_n else 'fails'}); "
            f"first {unit} {keys[i + 1]:,}: reward {first['average_episode_rewards']:.2f}, "
            f"reached {first['episodes_reached_target']:.0f}")
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
            "reached": statistics.fmean(r["episodes_reached_target"] for r in recs),
            "failed": statistics.fmean(r["episodes_failed"] for r in recs),
            "shaped_sum": statistics.fmean(s * e for s, e in zip(shaped, ends))}


def span_lines(runs: Sequence[Dict[int, dict]], labels: Sequence[str],
               spans: Sequence[str], terms: bool = False,
               rollout: Optional[float] = None, counts: bool = False) -> List[str]:
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
                          if terms and rollout else "")
                       + (f", reached {st['reached']:.1f}, failed {st['failed']:.1f}"
                          if counts else ""))
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
    ap.add_argument("--first-episode", type=int, default=1,
                    help="with --episode-rows: the number of the first aligned episode")
    ap.add_argument("--reward-crossings", type=float, nargs="+", default=None,
                    help="crossings of the mean reward over --window logged episodes")
    ap.add_argument("--keys", nargs="+", default=(), metavar="KEY",
                    help="add a column per run for each of these logged keys")
    ap.add_argument("--counts", action="store_true",
                    help="the spans also give the mean targets reached and episodes failed")
    ap.add_argument("--continuity", type=float, nargs="+", default=None, metavar="K",
                    help="the resume rule after each K, the last run against the first")
    args = ap.parse_args(argv)
    labels = args.labels or [f"run {i}" for i in range(len(args.metrics))]
    if len(labels) != len(args.metrics):
        raise SystemExit("curve_table: one label per metrics file")
    if args.episode_rows is None:
        runs, unit = [read_metrics(p) for p in args.metrics], "step"
    elif len(args.episode_rows) != len(args.metrics):
        raise SystemExit("curve_table: one --episode-rows range per metrics file")
    else:
        runs = [read_episode_rows(p, *(int(x) for x in tok.split(":")), args.first_episode)
                for p, tok in zip(args.metrics, args.episode_rows)]
        unit = "episode"
    upto = int(args.upto) if args.upto is not None else None
    rows = parse_rows(args.rows) if args.rows else None
    print("\n".join(table(runs, labels, upto, rows,
                          "env steps" if unit == "step" else unit, args.terms, args.keys)))
    if args.crossings:
        print()
        print("\n".join(crossing_lines(runs, labels, args.crossings, args.window, unit)))
    if args.reward_crossings:
        print()
        print("\n".join(crossing_lines(runs, labels, args.reward_crossings, args.window,
                                      unit, reward)))
    if args.continuity:
        print()
        print("\n".join(continuity_lines(runs[0], runs[-1], [int(k) for k in args.continuity],
                                        args.window, labels=(labels[0], labels[-1]),
                                        unit=unit)))
    if args.spans:
        print()
        print("\n".join(span_lines(runs, labels, args.spans, args.terms, args.rollout,
                                   args.counts)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
