"""One leg of a long training run of the port's train CLI, stopped at a
success share or at a wall-clock budget, always on a checkpointed episode.

  python tools/train_legs.py --out runs/heading_torch/leg_0 --budget-s 3300 \
      --stop-success 0.99 -- --env-name Control --scenario-name heading \
      --n-rollout-threads 3000 ... --log-interval 1 --num-env-steps 7.5e8

  python tools/train_legs.py --out runs/heading_torch/leg_1 \
      --resume runs/heading_torch/leg_0 --budget-s 3300 --stop-success 0.99 \
      -- <the same flags>

The child is the port's train CLI (`neuralplane_tpu_torch.scripts.train
<flags> --run-dir <out>/run`), started from the current directory (the repo
root), in its own process group, with its runner's `collect` and `train`
timed between synchronizations of the device: one line per episode in
`<out>/phases.jsonl` with `collect_s`, `update_s`, the device's peak MiB
and the kernel wrappers' launch counts so far in the child (on the CPU no
synchronization and a peak of 0). It logs one `metrics.jsonl` line per episode
(`--log-interval 1` is required), an eval line after it on an eval
episode, and on a save episode (every `--save-interval`, default 1, from
the leg's episode 0, and its last) then saves `state_ep<k>.pt`. For each
save the tool waits for its checkpoint, copies it to
`<out>/state_latest.pt`, appends the lines of the episodes up to it to
`<out>/metrics.jsonl` and deletes the child's per-episode copies (a
7.5e8-step heading run would leave 250 of them). So `<out>` never holds a
line whose checkpoint is missing, and the next leg resumes exactly after
the last line. A self-play run's pool entries (`actor_<n>.pt`, one per
save, written before the save's checkpoint) are copied to `<out>` as well,
those that the checkpoint names in its pool and no later one (the child may
already have written the next save's): the next leg's runner imports its
pool from the directory of `--model-dir`.

Stop rules, checked on each save only: the saved episode's success share
`episodes_reached_target / (episodes_reached_target + episodes_failed)` is
at least `--stop-success`; `--budget-s` seconds have passed since the tool
started; or the next save would come after them, by the median episode's
seconds (between two episode lines, less any eval) times the episodes to it
plus the median eval's times the evals on the way (the combat envs log no
success counts: only the budget stops them). The child is then killed (its
process group). Otherwise the leg ends when the child does, at its
`--num-env-steps`. A resumed leg numbers its episodes from 0 again, as the
JAX runner does, so its evals (every `--eval-interval`) and its saves (and
with them a self-play run's pool entries) count from the leg's start.
`<out>/leg.json` records the run's episode numbers (1-based) of the leg's
first episode, of each save and of each eval, and the medians it used.

`--resume PREV` continues from a previous leg's `<PREV>/state_latest.pt`
(or a finished run's merged directory, which has no `leg.json`: its
`metrics.jsonl`'s last episode line gives the steps and wall seconds)
(`--model-dir`; policy, Adam, update count and generator) with the step
budget reduced by the steps done, and shifts this leg's `step` and `wall_s`
by the previous legs' totals, so the legs' `metrics.jsonl` files
concatenate into one run. `<out>/leg.json` records the leg: episodes, the
cumulative steps and wall seconds, and why it stopped.

  python tools/train_legs.py --export-actor runs/heading_torch/leg_1/state_latest.pt \
      --to results/heading_torch/policy_checkpoint.pkl -- <the same flags>

writes the checkpoint's actor as the JAX package's actor-only pickle
(`params_to_jax`, `save_actor_pickle`), the policy built from the flags'
env and network sizes on the CPU. Imports no JAX.

  python tools/train_legs.py --profile runs/heading_torch/leg_1/state_latest.pt \
      -- <the same flags>

restores the checkpoint into the flags' runner on the card, runs one
collect, and profiles 20 collect steps and one epoch of the update on its
batch (`chip_smoke.profile_training`: device busy, idle share and device
launches per call, from torch.profiler).

  python tools/train_legs.py --summary runs/heading_torch/leg_0 runs/heading_torch/leg_1

prints one JSON line per finished leg (`summarize_leg`): its seconds per
episode, collect ms per step and update seconds (min, median, max),
agent-steps/s, the collect's and update's shares, peak MiB and launches.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from neuralplane_tpu_torch.scripts.supervise import _strip_arg  # noqa: E402


def success_share(rec: dict) -> float:
    """The heading task's share of episodes that reached the target; 0 for
    a record without those counts (the combat envs log none)."""
    reached, failed = rec.get("episodes_reached_target", 0), rec.get("episodes_failed", 0)
    return reached / (reached + failed) if reached + failed else 0.0


def is_episode_line(rec: dict) -> bool:
    """A training episode's record; an eval record (ELO, eval rewards)
    follows its episode's, before that episode's checkpoint."""
    return "average_episode_rewards" in rec


def pool_entries(ckpt: str) -> list:
    """The `actor_<name>.pt` files of the self-play pool a checkpoint
    holds (none for the other runners)."""
    import torch
    pool = torch.load(ckpt, map_location="cpu", weights_only=True).get("selfplay", {})
    return [f"actor_{name}.pt" for name in sorted(pool.get("policy_pool", {}))]


def copy_atomic(src: str, dst: str) -> None:
    shutil.copyfile(src, dst + ".tmp")
    os.replace(dst + ".tmp", dst)


def resumed_totals(resume: str) -> tuple:
    """(steps, wall seconds) done before a leg that resumes from `resume`: a
    leg's directory (its `leg.json`), or a finished run's merged directory
    (`metrics.jsonl` and `state_latest.pt`, as results/control_torch), whose
    last episode line holds them."""
    leg_json = os.path.join(resume, "leg.json")
    if os.path.exists(leg_json):
        with open(leg_json, encoding="utf-8") as f:
            prev = json.load(f)
        return prev["steps"], prev["wall_s"]
    with open(os.path.join(resume, "metrics.jsonl"), encoding="utf-8") as f:
        last = [rec for rec in map(json.loads, filter(str.strip, f)) if is_episode_line(rec)][-1]
    return last["step"], last["wall_s"]


def median(xs: list):
    import statistics
    return statistics.median(xs) if xs else None


def episode_seconds(recs: list) -> tuple:
    """(seconds per episode, seconds per eval) of a leg's records so far:
    each episode's from the `wall_s` of the record before it, less the eval
    between them (an eval record's `wall_s` less its episode's); the first
    episode's from the leg's start."""
    eps, evals, prev, after_eval = [], [], 0.0, 0.0
    for rec in recs:
        if is_episode_line(rec):
            eps.append(rec["wall_s"] - prev - after_eval)
            prev, after_eval = rec["wall_s"], 0.0
        else:
            evals.append(rec["wall_s"] - prev)
            after_eval += evals[-1]
    return eps, evals


def budget_stop(elapsed: float, budget_s: float, taken: int, leg_episodes: int,
                save_every: int, eval_every, ep_s: list, eval_s: list):
    """Why a leg stops at a save after `taken` of its `leg_episodes`
    episodes, `elapsed` seconds in, or None: the budget is spent, or the
    next save would come after it by the median episode and eval."""
    if elapsed >= budget_s:
        return f"wall budget {budget_s:.0f} s"
    upcoming = range(taken, min(taken + save_every, leg_episodes))
    if not upcoming:
        return None
    evals = sum(1 for e in upcoming if eval_every and e % eval_every == 0 and e)
    predicted = elapsed + len(upcoming) * median(ep_s) + evals * (median(eval_s) or 0.0)
    if predicted > budget_s:
        return (f"wall budget {budget_s:.0f} s: the next save, leg episode "
                f"{upcoming[-1]}, predicted at {predicted:.1f} s")
    return None


def run_leg(out: str, train_argv: list, budget_s: float, stop_success: float,
            resume: str = None, poll_s: float = 1.0) -> dict:
    if _strip_arg(train_argv, "--log-interval")[1] != "1":
        raise SystemExit("train_legs: the train flags need --log-interval 1")
    save_every = int(_strip_arg(train_argv, "--save-interval")[1] or 1)
    eval_every = (int(_strip_arg(train_argv, "--eval-interval")[1] or 25)
                  if "--use-eval" in train_argv else None)
    t_start = time.time()
    argv, _ = _strip_arg(train_argv, "--run-dir")
    argv, total = _strip_arg(argv, "--num-env-steps")
    total = int(float(total))
    done_steps, done_wall = 0, 0.0
    if resume is not None:
        done_steps, done_wall = resumed_totals(resume)
        argv = _strip_arg(argv, "--model-dir")[0] + [
            "--model-dir", os.path.join(resume, "state_latest.pt")]
    if done_steps >= total:
        raise SystemExit(f"train_legs: {done_steps} of {total} steps already done")
    run_dir = os.path.join(out, "run")
    os.makedirs(out, exist_ok=True)
    if os.path.exists(os.path.join(out, "metrics.jsonl")):
        raise SystemExit(f"train_legs: {out} already holds a leg")
    cmd = [sys.executable, os.path.abspath(__file__), "--timed-child",
           os.path.join(out, "phases.jsonl"), "--", *argv,
           "--run-dir", run_dir, "--num-env-steps", str(total - done_steps)]
    print(f"[train_legs] {' '.join(cmd)}", flush=True)
    child = subprocess.Popen(cmd, start_new_session=True)
    child_metrics = os.path.join(run_dir, "metrics.jsonl")
    ckpts = os.path.join(run_dir, "checkpoints")
    taken, last, stopped, pos = 0, None, None, 0
    # the leg's episodes in the whole run (1-based) and its saves and evals
    cadence = {"save_interval": save_every, "eval_interval": eval_every,
               "first_episode": None, "save_episodes": [], "eval_episodes": []}
    per_episode = None   # steps of one episode, from the child's first line

    def next_save() -> int:
        """The leg episode (0-based) of the child's next checkpoint, if one
        is there."""
        ks = [int(n[len("state_ep"):-len(".pt")]) for n in os.listdir(ckpts)
              if n.startswith("state_ep") and n.endswith(".pt")] if os.path.isdir(ckpts) else []
        ks = [k for k in ks if k >= taken]
        return min(ks) if ks else None

    def take_ready_lines() -> bool:
        """Move the lines of every episode up to the child's next checkpoint
        to `out` (with the pool entries that checkpoint names); True if a
        stop rule fired, which it checks on a checkpoint only."""
        nonlocal taken, last, stopped, pos, per_episode
        while (k := next_save()) is not None:
            # the episode's checkpoint follows all of its lines and those before
            with open(child_metrics, encoding="utf-8") as f:
                lines = [json.loads(ln) for ln in f.read().split("\n")[:-1] if ln.strip()]
            end, seen = pos, 0
            while end < len(lines) and (seen < k + 1 - taken
                                        or not is_episode_line(lines[end])):
                seen += is_episode_line(lines[end])
                end += 1
            if per_episode is None:
                per_episode = lines[0]["step"]
                cadence["first_episode"] = done_steps // per_episode + 1
            ep_ckpt = os.path.join(ckpts, f"state_ep{k}.pt")
            copy_atomic(ep_ckpt, os.path.join(out, "state_latest.pt"))
            for name in pool_entries(ep_ckpt):
                if not os.path.exists(os.path.join(out, name)):
                    copy_atomic(os.path.join(ckpts, name), os.path.join(out, name))
            with open(os.path.join(out, "metrics.jsonl"), "a", encoding="utf-8") as f:
                for rec in lines[pos:end]:
                    if not is_episode_line(rec):
                        cadence["eval_episodes"].append(rec["step"] // per_episode
                                                        + cadence["first_episode"] - 1)
                    out_rec = dict(rec, step=rec["step"] + done_steps,
                                   wall_s=round(rec["wall_s"] + done_wall, 2))
                    f.write(json.dumps(out_rec) + "\n")
            for name in os.listdir(ckpts):
                if name.startswith("state_ep") and name.endswith(".pt"):
                    if int(name[len("state_ep"):-len(".pt")]) <= k:
                        os.remove(os.path.join(ckpts, name))
            cadence["save_episodes"].append(cadence["first_episode"] + k)
            eps = [rec for rec in lines[:end] if is_episode_line(rec)]
            rec, elo = eps[-1], lines[end - 1].get("latest_elo")
            taken, pos = k + 1, end
            last = dict(lines[end - 1], step=lines[end - 1]["step"] + done_steps,
                        wall_s=round(lines[end - 1]["wall_s"] + done_wall, 2))
            share = success_share(rec)
            elapsed = time.time() - t_start
            print(f"[train_legs] episode {taken} step {last['step']} success "
                  f"{share:.4f} reward {rec['average_episode_rewards']:.3f}"
                  + (f" elo {elo:.2f}" if elo is not None else "")
                  + f" wall {elapsed:.1f} s", flush=True)
            ep_s, eval_s = episode_seconds(lines[:end])
            cadence.update(median_episode_s=round(median(ep_s), 3),
                           median_eval_s=median(eval_s) and round(median(eval_s), 3))
            if share >= stop_success:
                stopped = f"success share {share:.4f} >= {stop_success}"
            else:
                stopped = budget_stop(elapsed, budget_s, taken,
                                      (total - done_steps) // per_episode, save_every,
                                      eval_every, ep_s, eval_s)
            if stopped:
                return True
        return False

    try:
        while True:
            rc = child.poll()
            if take_ready_lines():
                # the poll above may have reaped a child that already ended
                if child.returncode is None:
                    os.killpg(child.pid, signal.SIGKILL)
                child.wait()
                rc = 0
                break
            if rc is not None:
                take_ready_lines()
                stopped = stopped or f"child exited {rc}"
                break
            time.sleep(poll_s)
    finally:
        if child.poll() is None:
            os.killpg(child.pid, signal.SIGKILL)
            child.wait()
    leg = {"episodes": taken, "steps": last["step"] if last else done_steps,
           "wall_s": last["wall_s"] if last else done_wall,
           "leg_wall_s": round(time.time() - t_start, 2), "stopped": stopped,
           "rc": rc, "resumed_from": resume, "argv": cmd[1:], **cadence}
    if last is not None:
        leg["last_success_share"] = success_share(last)
    with open(os.path.join(out, "leg.json"), "w", encoding="utf-8") as f:
        json.dump(leg, f, indent=1)
    print(f"[train_legs] {json.dumps(leg)}", flush=True)
    return leg


def timed_child(path: str, train_argv: list) -> None:
    """The train CLI in this process, each runner's `collect` and `train`
    timed between device synchronizations, one `path` line per episode."""
    import torch
    from chip_smoke import kernel_counters
    from neuralplane_tpu_torch.runner import F16SimRunner, SelfplayRunner
    from neuralplane_tpu_torch.runner.base import Runner
    from neuralplane_tpu_torch.scripts import train
    cuda = torch.cuda.is_available()
    counters = kernel_counters()
    rec = {"episode": 0}

    def clock() -> float:
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def timed(cls, name, key):
        inner = getattr(cls, name)

        def call(self, *a, **k):
            t0 = clock()
            out = inner(self, *a, **k)
            rec[key] = round(clock() - t0, 4)
            if key == "update_s":   # the episode's last phase
                rec["peak_mib"] = (round(torch.cuda.max_memory_allocated() / 2 ** 20, 1)
                                   if cuda else 0.0)
                rec["launches"] = {n: c.launches for n, c in counters.items()}
                with open(path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(rec) + "\n")
                episode = rec["episode"]
                rec.clear()
                rec["episode"] = episode + 1
            return out
        setattr(cls, name, call)

    timed(F16SimRunner, "collect", "collect_s")
    timed(SelfplayRunner, "collect", "collect_s")
    timed(Runner, "train", "update_s")
    train.main(train_argv)


def export_actor(state_path: str, to: str, train_argv: list) -> None:
    """The actor of a port checkpoint as the JAX package's actor-only pickle."""
    from neuralplane_tpu_torch.algorithms.networks import params_to_jax
    from neuralplane_tpu_torch.algorithms.ppo import PPOPolicy
    from neuralplane_tpu_torch.scripts.train import args_to_config, get_parser, make_env
    from neuralplane_tpu_torch.utils.checkpoint import load_checkpoint, save_actor_pickle
    args = get_parser().parse_args(train_argv)
    args.device, args.n_rollout_threads = "cpu", 1
    env = make_env(args)
    # the policy as the runner builds it (a missile env's ShootTuple head)
    policy = PPOPolicy(args_to_config(args), env.num_observation, env.num_actions,
                       act_space=getattr(env, "action_space", None),
                       prior_slots=getattr(env, "shoot_prior_slots", (11, 13)), device="cpu")
    policy.load_state_dict(load_checkpoint(state_path)["policy"])
    save_actor_pickle(to, params_to_jax(policy.actor))
    print(f"[train_legs] wrote {to} ({os.path.getsize(to)} bytes) from {state_path}")


def profile_run(state_path: str, train_argv: list) -> None:
    """Where an episode of the flags' run spends the device's time, from a
    checkpoint of it: one collect, then 20 profiled collect steps and one
    profiled update epoch."""
    import tempfile
    import torch
    from chip_smoke import profile_training, timed_runner
    from neuralplane_tpu_torch.scripts.train import args_to_config, get_parser, make_env
    args = get_parser().parse_args(train_argv)
    env = make_env(args)
    with tempfile.TemporaryDirectory() as run_dir:
        runner = timed_runner()(env, args_to_config(args), run_dir=run_dir,
                                model_dir=state_path)
        try:
            runner.collect(runner.init_carry(runner.next_seed()))
            print(f"[train_legs] profile from {state_path}: one collect "
                  f"{runner.times['collect'][0]:.3f} s, launches "
                  f"{runner.collect_launches[0]}", flush=True)
            profile_training(runner, phase="profile")
            if torch.cuda.is_available():
                print(f"[train_legs] profile: peak device memory "
                      f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB", flush=True)
        finally:
            runner.close()


def summarize_leg(out: str) -> dict:
    """A finished leg's speed from its `leg.json`, `phases.jsonl` and
    `metrics.jsonl`: seconds per episode (differences of `wall_s`, the
    leg's first from the resumed total), collect ms per collected step,
    update seconds, agent-steps/s, the collect's and the update's shares of
    the episodes' time, peak MiB, the launch counts at the leg's end and
    how many episodes added each count; with evals, the seconds of each
    episode without them and of each eval."""
    import statistics
    with open(os.path.join(out, "leg.json"), encoding="utf-8") as f:
        leg = json.load(f)
    # the child may have finished episodes past the leg's last checkpoint
    phases = [json.loads(ln) for ln in open(os.path.join(out, "phases.jsonl"),
                                            encoding="utf-8") if ln.strip()][:leg["episodes"]]
    metrics = os.path.join(out, "metrics.jsonl")
    if not os.path.exists(metrics):   # a leg copied beside its run's merged lines
        metrics = os.path.join(os.path.dirname(out.rstrip("/")), "metrics.jsonl")
    with open(metrics, encoding="utf-8") as f:
        all_lines = [json.loads(ln) for ln in f if ln.strip()]
    recs = [rec for rec in all_lines if is_episode_line(rec)]
    argv = leg["argv"]
    n_envs = int(argv[argv.index("--n-rollout-threads") + 1])
    buffer = int(argv[argv.index("--buffer-size") + 1])
    end = [rec["step"] for rec in recs].index(leg["steps"]) + 1
    lines = recs[end - leg["episodes"]:end]
    if end > leg["episodes"]:
        before = recs[end - leg["episodes"] - 1]["wall_s"]
    elif leg["resumed_from"]:
        before = resumed_totals(leg["resumed_from"])[1]
    else:
        before = 0.0
    walls = [before] + [rec["wall_s"] for rec in lines]
    # this leg's lines, evals included, their wall from the leg's start
    first = all_lines.index(lines[0])
    last = all_lines.index(lines[-1]) + 1
    while last < len(all_lines) and not is_episode_line(all_lines[last]):
        last += 1
    leg_lines = [dict(r, wall_s=r["wall_s"] - before) for r in all_lines[first:last]]
    episode_s = [round(b - a, 2) for a, b in zip(walls, walls[1:])]
    collect = [ph["collect_s"] for ph in phases]
    update = [ph["update_s"] for ph in phases]
    # kernel launches between episode ends (an eval's ride with the next)
    totals = [0] + [sum(ph["launches"].values()) for ph in phases]
    steps = {}
    for a, b in zip(totals, totals[1:]):
        steps[str(b - a)] = steps.get(str(b - a), 0) + 1

    def spread(xs, scale=1.0):
        return [round(min(xs) * scale, 4), round(statistics.median(xs) * scale, 4),
                round(max(xs) * scale, 4)]
    evals = {}
    if any(not is_episode_line(r) for r in leg_lines):
        ep_s, eval_s = episode_seconds(leg_lines)
        evals = {"episode_s_less_evals": spread(ep_s), "eval_s": spread(eval_s)}
    return {"leg": os.path.basename(out.rstrip("/")), "episodes": leg["episodes"],
            "steps": [lines[0]["step"], lines[-1]["step"]], "leg_wall_s": leg["leg_wall_s"],
            "episode_s": spread(episode_s), "collect_ms_per_step": spread(collect, 1e3 / buffer),
            "update_s": spread(update),
            "agent_steps_per_s_at_median": round(n_envs * buffer / statistics.median(episode_s)),
            "fps_last_line": lines[-1].get("fps"),
            "collect_share": round(sum(collect) / sum(episode_s), 3),
            "update_share": round(sum(update) / sum(episode_s), 3),
            "collect_s": round(sum(collect), 2), "update_s_total": round(sum(update), 2),
            "peak_mib": max(ph["peak_mib"] for ph in phases),
            "launches": phases[-1]["launches"], "launches_between_episodes": steps, **evals}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="the leg's directory")
    ap.add_argument("--resume", default=None, help="the previous leg's directory")
    ap.add_argument("--budget-s", type=float, default=3300.0)
    ap.add_argument("--stop-success", type=float, default=0.99)
    ap.add_argument("--export-actor", default=None, metavar="STATE_PT")
    ap.add_argument("--to", default=None, help="the pickle --export-actor writes")
    ap.add_argument("--profile", default=None, metavar="STATE_PT",
                    help="profile a collect step and an update epoch from this checkpoint")
    ap.add_argument("--summary", nargs="+", default=None, metavar="LEG_DIR",
                    help="print each finished leg's speed as one JSON line")
    ap.add_argument("--timed-child", default=None, metavar="PHASES_JSONL",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv[:split])
    train_argv = argv[split + 1:]
    if args.timed_child:
        timed_child(args.timed_child, train_argv)
        return 0
    if args.export_actor:
        export_actor(args.export_actor, args.to, train_argv)
        return 0
    if args.profile:
        profile_run(args.profile, train_argv)
        return 0
    if args.summary:
        for out in args.summary:
            print(json.dumps(summarize_leg(out)))
        return 0
    leg = run_leg(args.out, train_argv, args.budget_s, args.stop_success, args.resume)
    return 0 if leg["rc"] == 0 and leg["episodes"] else 1


if __name__ == "__main__":
    sys.exit(main())
