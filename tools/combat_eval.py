"""The port's combat evaluation rows against the JAX package's committed
ones (results/combat_eval_torch/REPORT.md).

  python tools/combat_eval.py run --out runs/combat_eval [--rows A1 A3 ...]
      [--seeds 4 5 6] [--pool runs/selfplay_torch --pool-final 61]
  python tools/combat_eval.py compare --out results/combat_eval_torch
  python tools/combat_eval.py curve results/selfplay/metrics.jsonl \
      results/selfplay_torch/metrics.jsonl --labels JAX port
  python tools/combat_eval.py jax-random --to results/combat_eval_torch/jax_random_actor_team.pkl

`run` flies each row with the port's probes (scripts/pk_probe.py,
scripts/ladder_probe.py) in this process at the JAX row's protocol, on the
card unless `--device cpu`, and writes `<out>/<row>.json`: the probe's
argv and last line per seed, the wall seconds of each call, and the card's
`nvidia-smi` name and power limit. The committed checkpoints are named as
pool entries through a directory of links (`<out>/links`). Row B is the
ladder of a self-play run's pool (`--pool`, its final entry `--pool-final`)
against its entries 1 and 10. `--seeds` flies the rows at those seeds
instead of each row's own (`ROWS`), into `<out>/<row>_seeds<first>-<last>.json`;
`compare` pools every file of a row (`<row>.json` and `<row>_seeds*.json`).

`compare` prints the markdown table of every row written, beside its JAX
row and the agreement test (a pk row's tallies summed over its seeds):
- a per-shot Pk p over s shots agrees when |p_port - p_jax| <= 4 sqrt(q (1 -
  q) (1 / s_port + 1 / s_jax)), q the pooled Pk; a win share likewise over
  decisive episodes;
- a ladder diff agrees when its verdict at the JAX row's tie band is the
  same and |diff_port - diff_jax| <= max(0.25 |diff_jax|, 4 spread), the
  spread the sample standard deviation of the port's diff over its seeds
  (row B: the verdict only, the JAX ladder being of a longer run).

`jax-random` writes the random actor the JAX pk probe draws (row A5j flies
it; the port's own `random` is another draw). `jax-probe pk|ladder
[--to FILE] -- <flags>` runs the JAX package's probe on the CPU, its env
on "distilled" (the Pallas kernel in interpret mode), and prints its last
line. `curve` prints two self-play
runs' training records (the first episode
and every 10th after it) and ELO evals side by side, up to the shorter
run's last step, and each run's seconds per episode; `curve --verdict`
prints the missile runs' 10-episode windows (launches and hits per
rollout, hits per launch, entropy term) and the verdict rule of
`results/shoot_evadable_torch/REPORT.md`, the last run against the first
(`--resumes K ...`: the last episode before each of its resumes).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LINKS = {
    "final": "shoot_evadable/policy_checkpoint_2e9.pkl",
    "coda": "shoot_evadable/policy_checkpoint_2p3e9.pkl",
    "start13": "evadable_pfsp_ab/fsp_final_checkpoint.pkl",
    "team": "mappo_2v2_evadable/policy_checkpoint_2p5e9.pkl",
    "jaxrandom": "combat_eval_torch/jax_random_actor_team.pkl",
}
EVADABLE = ["--scenario", "selfplay_shoot_evadable", "--use-prior", "--stochastic", "both"]
LADDER_1V1 = ["--env", "SingleCombatShoot", *EVADABLE, "--both-sides", "--tie-band", "50",
              "--num-envs", "200", "--steps", "2000"]
PK_1V1 = ["--env", "SingleCombatShoot", *EVADABLE, "--num-envs", "256", "--steps", "3000"]
PK_TEAM = ["--env", "MultipleCombatShoot", "--scenario", "multiple_selfplay_shoot_evadable",
           "--use-prior", "--stochastic", "both", "--num-envs", "128", "--steps", "3000"]

# row -> (tool, argv without --ckpt-dir and --seed, seeds)
ROWS = {
    "A1": ("pk", PK_1V1 + ["--ego", "final", "--opponent", "random"], [0]),
    "A2": ("pk", PK_1V1 + ["--ego", "final", "--opponent", "start13"], [0]),
    "A3": ("ladder", LADDER_1V1 + ["--final", "final", "--opponents", "start13"], [0, 7]),
    "A4": ("ladder", LADDER_1V1 + ["--final", "coda", "--opponents", "final"], [0, 7, 1]),
    "A5": ("pk", PK_TEAM + ["--ego", "team", "--opponent", "random"], [0, 1, 2, 3]),
    "A5m": ("pk", PK_TEAM + ["--ego", "team", "--opponent", "team"], [0, 1, 2, 3]),
    # A5 against the JAX probe's own random actor (`jax-random`)
    "A5j": ("pk", PK_TEAM + ["--ego", "team", "--opponent", "jaxrandom"], [0, 1, 2, 3]),
}

# the JAX rows: (file, what), each statistic as (value, sample size)
JAX = {
    "A1": {"src": "results/shoot_evadable/pk_r5.json, final_2e9 vs random",
           "pk_against_opp": (0.3152, 3252), "pk_against_ego": (0.0923, 1571),
           "win_share": (1149 / 1258, 1258), "episodes": 1671},
    "A2": {"src": "results/shoot_evadable/pk_r5.json, final_2e9 vs start_1p3e9",
           "pk_against_opp": (0.0611, 3547), "pk_against_ego": (0.0625, 5792),
           "episodes": 3441},
    "A3": {"src": "results/shoot_evadable/ladder_r5.jsonl, start13 (seeds 0, 7)",
           "diff": {0: 94.575, 7: 99.139}, "verdict": "WIN", "tie_band": 50.0,
           "episodes": {0: 6549.0, 7: 6571.0}},
    "A4": {"src": "results/shoot_evadable/REPORT.md '+3e8 coda' (one seed)",
           "diff": {0: 8.7}, "verdict": "tie", "tie_band": 50.0, "episodes": {0: 1530.0},
           "win_share": (539 / 1050, 1050)},
    "A5": {"src": "results/mappo_2v2_evadable/pk_r5.json, latest vs random",
           "pk_against_opp": (0.15504, 811), "pk_against_ego": (0.13988, 696),
           "win_share": (74 / 116, 116), "episodes": 173},
    "A5j": {"src": "results/mappo_2v2_evadable/pk_r5.json, latest vs random",
            "pk_against_opp": (0.15504, 811), "pk_against_ego": (0.13988, 696),
            "win_share": (74 / 116, 116), "episodes": 173},
    "A5m": {"src": "results/mappo_2v2_evadable/pk_r5.json, latest vs latest",
            "pk_against_opp": (0.14066, 832), "pk_against_ego": (0.14562, 716),
            "win_share": (72 / 118, 118), "episodes": 177},
    # the JAX run's ladder is its 2e8-step final's, the port's run stops at
    # 6.1e7: the verdict is compared, the diff shown beside it
    "B": {"src": "results/selfplay/REPORT.md ladder (2e8 steps)",
          "diff": {"1": 3.02, "10": 4.05}, "verdict": "WIN", "tie_band": 1.0,
          "verdict_only": True},
}


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def call(main_fn, argv):
    """A probe's main in-process: (its last stdout line, wall seconds)."""
    import torch
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main_fn(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return json.loads(buf.getvalue().strip().splitlines()[-1]), time.perf_counter() - t0


def make_links(out: str) -> str:
    d = os.path.join(out, "links")
    os.makedirs(d, exist_ok=True)
    for name, path in LINKS.items():
        link = os.path.join(d, f"actor_{name}.pkl")
        if not os.path.lexists(link):
            os.symlink(os.path.join(REPO, "results", path), link)
    return d


def run(args) -> None:
    from neuralplane_tpu_torch.scripts import ladder_probe, pk_probe
    os.makedirs(args.out, exist_ok=True)
    links = make_links(args.out)
    card = card_line()
    rows = dict(ROWS)
    if args.pool:
        rows["B"] = ("ladder", ["--env", "SingleCombat", "--scenario", "selfplay",
                                "--final", args.pool_final, "--opponents", "1", "10",
                                "--tie-band", "1.0", "--num-envs", "200", "--steps", "2000"],
                     [0])
    for name in args.rows or list(rows):
        tool, argv, seeds = rows[name]
        fname = name
        if args.seeds:
            seeds = args.seeds
            fname = f"{name}_seeds{seeds[0]}-{seeds[-1]}"
        ckpt = args.pool if name == "B" else links
        rec = {"row": name, "card": card, "runs": []}
        for seed in seeds:
            full = ["--ckpt-dir", ckpt, "--seed", str(seed), "--device", args.device, *argv]
            last, wall = call(pk_probe.main if tool == "pk" else ladder_probe.main, full)
            rec["runs"].append({"argv": full, "seed": seed, "last_line": last,
                                "wall_s": round(wall, 2)})
            print(f"[combat_eval] {name} seed {seed}: {wall:.1f} s {json.dumps(last)}",
                  flush=True)
        with open(os.path.join(args.out, f"{fname}.json"), "w", encoding="utf-8") as f:
            json.dump(rec, f, indent=1)


def pk_agrees(p, s, p_jax, s_jax):
    q = (p * s + p_jax * s_jax) / (s + s_jax)
    limit = 4.0 * math.sqrt(q * (1 - q) * (1 / max(s, 1) + 1 / s_jax))
    return abs(p - p_jax), limit, abs(p - p_jax) <= limit


def compare_pk(name, rec, jax_row):
    """The row's tallies summed over its seeds against the JAX row."""
    keys = ("ego_fired", "opp_fired", "pk_by_ego", "pk_by_opp", "ego_wins", "opp_wins",
            "episodes")
    t = {k: sum(r["last_line"][k] for r in rec["runs"]) for k in keys}
    t["pk_against_opp"] = t["pk_by_ego"] / max(t["ego_fired"], 1.0)
    t["pk_against_ego"] = t["pk_by_opp"] / max(t["opp_fired"], 1.0)
    lines = []
    stats = [("Pk against the opponent", t["pk_against_opp"], t["ego_fired"],
              jax_row["pk_against_opp"]),
             ("Pk against the ego", t["pk_against_ego"], t["opp_fired"],
              jax_row["pk_against_ego"])]
    if "win_share" in jax_row:
        dec = t["ego_wins"] + t["opp_wins"]
        stats.append(("ego share of decisive episodes", t["ego_wins"] / max(dec, 1), dec,
                      jax_row["win_share"]))
    for what, p, s, (p_jax, s_jax) in stats:
        d, limit, ok = pk_agrees(p, s, p_jax, s_jax)
        lines.append(f"| {name} | {what} | {p:.4f} over {s:g} | {p_jax:.4f} over {s_jax:g} | "
                     f"{d:.4f} <= {limit:.4f} | {'agrees' if ok else 'DISAGREES'} |")
    # the JAX tool's own rows at more seeds on the CPU, where written
    # (`jax_cpu_<row>.jsonl`, one `tools/pk_probe.py` last line per seed;
    # A5j flies A5's opponent)
    jax_cpu = os.path.join(os.path.dirname(rec["path"]),
                           f"jax_cpu_{ {'A5j': 'A5'}.get(name, name)}.jsonl")
    if os.path.exists(jax_cpu) and "win_share" in jax_row:
        rows = read_jsonl(jax_cpu)
        w = [sum(r[k] for r in rows) for k in ("ego_wins", "opp_wins")]
        dec = t["ego_wins"] + t["opp_wins"]
        p_cpu = w[0] / max(sum(w), 1)
        d, limit, ok = pk_agrees(t["ego_wins"] / max(dec, 1), dec, p_cpu, sum(w))
        lines.append(f"| {name} | ego share of decisive episodes, against the JAX tool on the "
                     f"CPU ({len(rows)} seeds, `{os.path.basename(jax_cpu)}`) | "
                     f"{t['ego_wins'] / max(dec, 1):.4f} over {dec:g} | {p_cpu:.4f} over "
                     f"{sum(w):g} | {d:.4f} <= {limit:.4f} | {'agrees' if ok else 'DISAGREES'} |")
    seeds = ", ".join(str(r["seed"]) for r in rec["runs"])
    lines.append(f"| {name} | episodes (seeds {seeds}) | {t['episodes']:g} | "
                 f"{jax_row['episodes']} | | |")
    return lines


def compare_ladder(name, rec, jax_row):
    lines, by_opp = [], {}
    for run_ in rec["runs"]:
        for r in run_["last_line"]["ladder"]:
            by_opp.setdefault(r["opponent"], []).append((run_["seed"], r))
    for opp, seeded in by_opp.items():
        diffs = [r["diff"] for _, r in seeded]
        spread = (math.sqrt(sum((d - sum(diffs) / len(diffs)) ** 2 for d in diffs)
                            / (len(diffs) - 1)) if len(diffs) > 1 else 0.0)
        for seed, r in seeded:
            key = opp if name == "B" else seed
            want = jax_row["diff"].get(key, next(iter(jax_row["diff"].values())))
            limit = max(0.25 * abs(want), 4.0 * spread)
            ok = r["verdict"] == jax_row["verdict"] and (
                jax_row.get("verdict_only") or abs(r["diff"] - want) <= limit)
            test = ("verdict only" if jax_row.get("verdict_only") else
                    f"{abs(r['diff'] - want):.3f} <= {limit:.3f}, spread {spread:.3f}")
            lines.append(
                f"| {name} | diff vs {opp}, seed {seed} | {r['diff']:+.3f} ({r['verdict']}, "
                f"{r['episodes']:g} episodes, wins {r['ego_wins']:g}:{r['opp_wins']:g}) | "
                f"{want:+.3f} ({jax_row['verdict']}) | {test} | "
                f"{'agrees' if ok else 'DISAGREES'} |")
            if "win_share" in jax_row:
                dec = r["ego_wins"] + r["opp_wins"]
                p_jax, s_jax = jax_row["win_share"]
                d, lim, ok = pk_agrees(r["ego_wins"] / max(dec, 1), dec, p_jax, s_jax)
                lines.append(f"| {name} | ego share of decisive episodes, seed {seed} | "
                             f"{r['ego_wins'] / max(dec, 1):.4f} over {dec:g} | {p_jax:.4f} "
                             f"over {s_jax:g} | {d:.4f} <= {lim:.4f} | "
                             f"{'agrees' if ok else 'DISAGREES'} |")
    return lines


def read_row(out: str, name: str):
    """A row's record with the runs of every file written for it in `out`
    (`<row>.json`, then `<row>_seeds*.json` in name order), or None."""
    paths = [os.path.join(out, f"{name}.json")] + sorted(
        os.path.join(out, f) for f in os.listdir(out)
        if f.startswith(f"{name}_seeds") and f.endswith(".json"))
    rec = None
    for path in filter(os.path.exists, paths):
        with open(path, encoding="utf-8") as f:
            part = json.load(f)
        if rec is None:
            rec = dict(part, path=path, runs=[])
        rec["runs"] += part["runs"]
    return rec


def compare(args) -> None:
    print("| Row | Statistic | Port | JAX | Test | Verdict |")
    print("| --- | --- | --- | --- | --- | --- |")
    for name in list(ROWS) + ["B"]:
        rec = read_row(args.out, name)
        if rec is None:
            continue
        fn = compare_pk if "pk_against_opp" in JAX[name] else compare_ladder
        for line in fn(name, rec, JAX[name]):
            print(line)
        walls = ", ".join(f"{r['wall_s']}" for r in rec["runs"])
        print(f"| {name} | wall s per call ({rec['card']}) | {walls} | | | |")


CURVE_KEYS = ("average_episode_rewards", "policy_entropy_loss", "value_loss", "ratio")


def read_jsonl(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def curve(args) -> None:
    """Two self-play runs' metrics.jsonl side by side: the training records
    at the first episode and every 10th after it, and every ELO eval."""
    runs = [read_jsonl(p) for p in args.metrics]
    train = [{r["step"]: r for r in run if "average_episode_rewards" in r} for run in runs]
    evals = [{r["step"]: r for r in run if "eval_episodes_ended" in r} for run in runs]
    last = min(max(t) for t in train)
    first = min(min(t) for t in train)
    steps = [s for s in sorted(train[0]) if s <= last and (s == first or (s - first)
                                                          % (10 * first) == 0 or s == last)]
    head = " | ".join(f"{label} {k}" for k in CURVE_KEYS for label in args.labels)
    print(f"| step | {head} |")
    print("|" + " --- |" * (1 + len(CURVE_KEYS) * len(runs)))
    for step in steps:
        cells = [f"{t[step][k]:.4f}" if step in t else "-" for k in CURVE_KEYS for t in train]
        print(f"| {step:.3g} | " + " | ".join(cells) + " |")
    print()
    print("| step | " + " | ".join(f"{label} latest_elo | {label} eval episodes"
                                    for label in args.labels) + " |")
    print("|" + " --- |" * (1 + 2 * len(runs)))
    for step in sorted(set().union(*evals)):
        if step > last:
            continue
        cells = [f"{e[step]['latest_elo']:.4f} | {e[step]['eval_episodes_ended']:g}"
                 if step in e else "- | -" for e in evals]
        print(f"| {step:.3g} | " + " | ".join(cells) + " |")
    for label, t in zip(args.labels, train):
        recs = [t[k] for k in sorted(t) if k <= last]
        if len(recs) < 2:
            continue
        walls = [b["wall_s"] - a["wall_s"] for a, b in zip(recs, recs[1:])]
        print(f"\n{label}: {len(recs)} episodes to {last:.3g} steps, {recs[-1]['wall_s']} s "
              f"wall, seconds per episode (with its eval) {min(walls):.2f}-{max(walls):.2f}, "
              f"median {sorted(walls)[len(walls) // 2]:.2f}")


def shoot_windows(run: list, width: int = 10) -> list:
    """A missile self-play run's records by `width`-episode window (episodes
    1-based from `step`, one episode the first record's steps): the window's
    first episode, its mean launches and hits per rollout, hits per launch
    (its sums' ratio) and mean entropy term."""
    train = [r for r in run if "average_episode_rewards" in r]
    per = train[0]["step"]
    out = []
    for lo in range(1, train[-1]["step"] // per + 1, width):
        recs = [r for r in train if lo <= r["step"] // per < lo + width]
        if len(recs) < width:
            break
        launches = sum(r["shoot_launches"] for r in recs)
        out.append({"first": lo, "launches": launches / len(recs),
                    "hits": sum(r["shoot_hits"] for r in recs) / len(recs),
                    "hit_share": sum(r["shoot_hits"] for r in recs) / max(launches, 1),
                    "entropy": sum(r["policy_entropy_loss"] for r in recs) / len(recs)})
    return out


def shoot_evals(run: list) -> list:
    """(episode, latest_elo) of each ELO eval, the episode it followed."""
    per = next(r["step"] for r in run if "average_episode_rewards" in r)
    return [(r["step"] // per, r["latest_elo"]) for r in run if "eval_episodes_ended" in r]


# the verdict rule of results/shoot_evadable_torch/REPORT.md (Step 1(c)):
# the launch ramp's window, the launch level and hit share of two windows,
# the entropy term of the last, the ELO evals, and each resume's continuity
RAMP_LAUNCHES = 10_000
RAMP_FIRST = (61, 111)          # the port's ramp window starts in this range
LEVEL_WINDOWS = (101, 111)
LEVEL_FACTOR = (0.5, 1.5)       # launches per rollout, of the JAX window's
SHARE_BAND = 0.075              # hits per launch, +- the JAX window's
ENTROPY_BAND = 1.0              # the entropy term of window 111-120, +-
ELO_BAND = 60.0                 # the last eval, +- the JAX eval of the same count
ELO_DROP = 16.0                 # at most one drop after the first rise, this deep


def shoot_verdict(ref: list, run: list, resumes=(), after: int = 3) -> list:
    """The rule's parts for `run` (the port) against `ref` (the JAX run):
    rows (part, JAX value, port value, band, held), `ref` cut at `run`'s
    last step."""
    ref = [r for r in ref if r["step"] <= run[-1]["step"]]
    wr, wp = ({w["first"]: w for w in shoot_windows(x)} for x in (ref, run))
    rows = []

    def ramp(ws):
        return next((k for k in sorted(ws) if ws[k]["launches"] > RAMP_LAUNCHES), None)
    r_ref, r_run = ramp(wr), ramp(wp)
    rows.append(("launch ramp (first window above 10,000)", r_ref, r_run,
                 f"starts at {RAMP_FIRST[0]} to {RAMP_FIRST[1]}",
                 r_run is not None and RAMP_FIRST[0] <= r_run <= RAMP_FIRST[1]))
    for k in LEVEL_WINDOWS:
        a, b = wr[k], wp.get(k)
        lo, hi = (f * a["launches"] for f in LEVEL_FACTOR)
        rows.append((f"launches {k}-{k + 9}", round(a["launches"], 1),
                     b and round(b["launches"], 1), f"{lo:.1f} to {hi:.1f}",
                     b is not None and lo <= b["launches"] <= hi))
        lo, hi = a["hit_share"] - SHARE_BAND, a["hit_share"] + SHARE_BAND
        rows.append((f"hits per launch {k}-{k + 9}", round(a["hit_share"], 4),
                     b and round(b["hit_share"], 4), f"{lo:.4f} to {hi:.4f}",
                     b is not None and lo <= b["hit_share"] <= hi))
    k = LEVEL_WINDOWS[-1]
    a, b = wr[k]["entropy"], wp.get(k, {}).get("entropy")
    rows.append((f"entropy term {k}-{k + 9}", round(a, 4), b and round(b, 4),
                 f"{a - ENTROPY_BAND:.4f} to {a + ENTROPY_BAND:.4f}",
                 b is not None and abs(b - a) <= ENTROPY_BAND))
    er, ep = shoot_evals(ref), shoot_evals(run)
    rise = next((i for i, (_, e) in enumerate(ep) if e > 1000.0), None)
    drops = [ep[i - 1][1] - ep[i][1] for i in range(max(rise or 0, 1), len(ep))
             if ep[i][1] < ep[i - 1][1]] if rise is not None else []
    rows.append(("ELO monotone from its first rise (episode)",
                 next((n for n, e in er if e > 1000.0), None),
                 ep[rise][0] if rise is not None else None,
                 f"at most one drop, of at most {ELO_DROP:g}",
                 rise is not None and len(drops) <= 1 and all(d <= ELO_DROP for d in drops)))
    n_ev, last = len(ep), ep[-1][1] if ep else None
    ref_same = er[n_ev - 1][1] if 0 < n_ev <= len(er) else None
    rows.append((f"ELO at the last eval (eval {n_ev}: JAX episode "
                 f"{er[n_ev - 1][0] if ref_same else '-'}, port {ep[-1][0] if ep else '-'})",
                 ref_same and round(ref_same, 2), last and round(last, 2),
                 f"+-{ELO_BAND:g}", ref_same is not None and abs(last - ref_same) <= ELO_BAND))
    for k in resumes:
        rows.extend(resume_rows(ref, run, k, after))
    return rows


def resume_rows(ref: list, run: list, k: int, after: int = 3, window: int = 10) -> list:
    """A resume after episode `k`, judged at episode k + `after`: the entropy
    term within m + d +- max(3 sd, 0.05), m and sd the port's over the
    `window` episodes to k, d the JAX run's own move from its mean over them
    to its episode k + after; launches within a factor of 2 of the port's
    mean over the window; the first eval after the resume within 32 of the
    last before it."""
    import statistics

    def by_ep(x):
        per = next(r["step"] for r in x if "average_episode_rewards" in r)
        return {r["step"] // per: r for r in x if "average_episode_rewards" in r}
    er, ep = by_ep(ref), by_ep(run)
    span = [ep[e] for e in range(k - window + 1, k + 1)]
    ent = [r["policy_entropy_loss"] for r in span]
    m, sd = statistics.fmean(ent), statistics.pstdev(ent)
    d = er[k + after]["policy_entropy_loss"] - statistics.fmean(
        er[e]["policy_entropy_loss"] for e in range(k - window + 1, k + 1))
    got = ep[k + after]
    half = max(3 * sd, 0.05)
    launches = statistics.fmean(r["shoot_launches"] for r in span)
    evals = shoot_evals(run)
    before = [e for n, e in evals if n <= k]
    after_ev = [e for n, e in evals if n > k]
    return [
        (f"resume after {k}: entropy term at {k + after}", round(er[k + after]
                                                              ["policy_entropy_loss"], 4),
         round(got["policy_entropy_loss"], 4), f"{m + d - half:.4f} to {m + d + half:.4f}",
         abs(got["policy_entropy_loss"] - (m + d)) <= half),
        (f"resume after {k}: launches at {k + after}", er[k + after]["shoot_launches"],
         got["shoot_launches"], f"{launches / 2:.1f} to {launches * 2:.1f}",
         launches / 2 <= got["shoot_launches"] <= launches * 2),
        (f"resume after {k}: first ELO eval after it", None,
         after_ev and round(after_ev[0], 2),
         f"within 32 of {before[-1]:.2f}" if before else "-",
         bool(before and after_ev) and abs(after_ev[0] - before[-1]) <= 32.0),
    ]


def shoot_tables(args) -> None:
    """The windows of each run side by side, then the verdict rows."""
    runs = [read_jsonl(p) for p in args.metrics]
    ws = [{w["first"]: w for w in shoot_windows(r)} for r in runs]
    cols = ("launches", "hits", "hit_share", "entropy")
    print("| episodes | " + " | ".join(f"{label} {c}" for c in cols for label in args.labels)
          + " |")
    print("|" + " --- |" * (1 + len(cols) * len(runs)))
    for k in sorted(set(ws[0]) & set(ws[-1])):
        if k > max(ws[-1]):
            break
        print(f"| {k}-{k + 9} | " + " | ".join(
            f"{w[k][c]:.4f}" if c in ("hit_share", "entropy") else f"{w[k][c]:.1f}"
            for c in cols for w in ws) + " |")
    print()
    print("| part | JAX | port | band | held |")
    print("| --- | --- | --- | --- | --- |")
    for part, a, b, band, held in shoot_verdict(runs[0], runs[-1], args.resumes):
        print(f"| {part} | {a} | {b} | {band} | {'held' if held else 'failed'} |")


def jax_probe(args) -> None:
    """The JAX package's tools/{pk,ladder}_probe.py on the CPU with its
    flags, its env on "distilled" as the port's probes fly
    (NEURALPLANE_AERO_BACKEND; the Pallas kernel in interpret mode); prints
    the tool's last line and appends it, with the flags and seconds, to
    `--to`."""
    import importlib.util
    import jax
    from jax.experimental import pallas as pl
    jax.config.update("jax_platforms", "cpu")
    prev = os.environ.get("NEURALPLANE_AERO_BACKEND")
    os.environ["NEURALPLANE_AERO_BACKEND"] = "distilled"
    orig = pl.pallas_call
    pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    path = os.path.join(REPO, "tools", f"{args.tool}_probe.py")
    spec = importlib.util.spec_from_file_location(f"jax_{args.tool}_probe", path)
    mod = importlib.util.module_from_spec(spec)
    argv, sys.argv = sys.argv, [path, *args.flags]
    buf = io.StringIO()
    t0 = time.time()
    try:
        spec.loader.exec_module(mod)
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv, pl.pallas_call = argv, orig
        if prev is None:
            os.environ.pop("NEURALPLANE_AERO_BACKEND", None)
        else:
            os.environ["NEURALPLANE_AERO_BACKEND"] = prev
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(json.dumps(last))
    if args.to:
        with open(args.to, "a", encoding="utf-8") as f:
            f.write(json.dumps({"tool": f"tools/{args.tool}_probe.py", "argv": args.flags,
                                "backend": "distilled", "wall_s": round(time.time() - t0, 1),
                                "last": last}) + "\n")


def jax_random(args) -> None:
    """The random actor the JAX pk probe draws for `--opponent random`
    (`init_actor_params(PRNGKey(seed + 99))` of its policy on the env),
    written as the JAX package's actor-only pickle: the port flies the
    same weights as a pool entry. Needs JAX (the CPU will do)."""
    import jax
    from neuralplane_tpu.algorithms.ppo import PPOPolicy
    from neuralplane_tpu.algorithms.rl_config import RLConfig
    from neuralplane_tpu.envs import MultipleCombatShootEnv, SingleCombatShootEnv
    from neuralplane_tpu.utils.checkpoint import save_pytree
    env_cls = (MultipleCombatShootEnv if args.env == "MultipleCombatShoot"
               else SingleCombatShootEnv)
    env = env_cls(num_envs=1, config=args.scenario)
    policy = PPOPolicy(RLConfig(use_prior=True), env.num_observation, env.num_actions,
                       act_space=env.action_space, prior_slots=env.shoot_prior_slots)
    save_pytree(args.to, policy.init_actor_params(jax.random.PRNGKey(args.seed + 99)))
    print(f"[combat_eval] wrote {args.to}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--out", required=True)
    r.add_argument("--rows", nargs="*", default=None)
    r.add_argument("--pool", default=None, help="a self-play run's pool directory (row B)")
    r.add_argument("--pool-final", default="latest")
    r.add_argument("--seeds", type=int, nargs="*", default=None,
                   help="these seeds instead of each row's own")
    r.add_argument("--device", default="cuda")
    c = sub.add_parser("compare")
    c.add_argument("--out", required=True)
    k = sub.add_parser("curve", help="self-play runs' metrics.jsonl side by side")
    k.add_argument("metrics", nargs="+")
    k.add_argument("--labels", nargs="+", required=True)
    k.add_argument("--verdict", action="store_true",
                   help="the missile runs' 10-episode windows and the verdict rule of "
                   "results/shoot_evadable_torch/REPORT.md, the last run against the first")
    k.add_argument("--resumes", type=int, nargs="*", default=[],
                   help="--verdict: the last episode before each resume of the last run")
    j = sub.add_parser("jax-random", help="the JAX pk probe's random actor as a pickle")
    j.add_argument("--to", required=True)
    j.add_argument("--env", default="MultipleCombatShoot")
    j.add_argument("--scenario", default="multiple_selfplay_shoot_evadable")
    j.add_argument("--seed", type=int, default=0)
    q = sub.add_parser("jax-probe", help="the JAX package's probe on the CPU")
    q.add_argument("tool", choices=["pk", "ladder"])
    q.add_argument("--to", default=None, help="append the line to this file")
    q.add_argument("flags", nargs="*", help="the probe's flags, after --")
    args = ap.parse_args(argv)
    if args.cmd == "jax-probe":
        return jax_probe(args)
    if args.cmd == "curve" and args.verdict:
        return shoot_tables(args)
    {"run": run, "compare": compare, "curve": curve, "jax-random": jax_random}[args.cmd](args)


if __name__ == "__main__":
    main()
