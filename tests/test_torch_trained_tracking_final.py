"""The port's tracking run to 3e8 (results/tracking_torch_final) against the
JAX run's records (CPU; reads files and restores actors, runs no collect).

- The lineage: the final state's update count and Adam step equal the
  committed JAX tracking policy's Adam count (24,000 = 300 episodes of 16
  epochs x 5 minibatches), or 80 per logged episode if the run stopped
  short of 3e8.
- `metrics.jsonl`: one line per 1e6 high-level steps from 6.2e7, the JAX
  run's keys, continuing results/tracking_torch/metrics.jsonl in `step`
  and `wall_s`.
- The legs: each `leg.json` resumed from the one before it, the first from
  results/tracking_torch, at `scripts/train_tracking.sh`'s flags over the
  committed control policy; `nlplant_distilled` exactly 10,000 launches
  per episode and no other kernel.
- `tools/curve_table.py` reproduces the REPORT's table, crossings and
  spans; its `--first-episode`, `--reward-crossings`, comma-joined files
  and `--continuity` (the REPORT's resume rule) on small files.
- `tools/train_legs.py --summary` reads a leg's speed from its directory
  (results/tracking_torch's as its REPORT gives it).
- `tools/heading_eval.py` prints the same actor log std in both packages
  for the committed and the final tracking actor.

The graft of the final pickle into the JAX runner is a case of
tests/test_torch_trained_tracking.py's graft test.
"""
from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pytest

from neuralplane_tpu_torch.utils.checkpoint import load_checkpoint, load_jax_pickle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RUN = os.path.join(REPO, "results", "tracking")
FIRST = os.path.join(REPO, "results", "tracking_torch")
RUN = os.path.join(REPO, "results", "tracking_torch_final")
UPDATES_PER_EPISODE = 16 * 5   # ppo_epoch x num_mini_batch
ROLLOUT = 10_000 * 100         # n_rollout_threads x buffer_size
XDOT_PER_EPISODE = 2 * 50 * 100   # two xdot launches per inner step
# results/tracking_torch_final/REPORT.md's curve_table invocation
EPISODE_ROWS = ["62:300", "1:239"]
FIRST_EPISODE = 62
REPORT_ROWS = ["62:300:20", "64", "300"]
REWARD_CROSSINGS = [-240.0, -230.0, -220.0, -215.0, -210.0]
WINDOW = 10
SPANS = ["62:71", "91:100", "141:150", "191:200", "291:300"]


def load_tool(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_jsonl(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def test_the_run_ends_at_the_committed_policys_updates():
    rows = read_jsonl(os.path.join(RUN, "metrics.jsonl"))
    state = load_checkpoint(os.path.join(RUN, "state_latest.pt"))
    episodes = rows[-1]["step"] // ROLLOUT
    assert state["step"] == UPDATES_PER_EPISODE * episodes
    assert {int(v["step"]) for v in state["optimizer"]["state"].values()} == {state["step"]}
    ts = load_jax_pickle(os.path.join(JAX_RUN, "policy_checkpoint.pkl"))["train_state"]
    assert int(ts.step) == int(ts.opt_state[0].count) == 24_000
    if rows[-1]["step"] == 300_000_000:
        assert state["step"] == int(ts.opt_state[0].count)


def test_metrics_continue_the_first_run_with_the_jax_keys():
    want = set().union(*(r.keys() for r in read_jsonl(os.path.join(JAX_RUN, "metrics.jsonl"))))
    rows = read_jsonl(os.path.join(RUN, "metrics.jsonl"))
    before = read_jsonl(os.path.join(FIRST, "metrics.jsonl"))
    assert before[-1]["step"] == 61_000_000
    assert 1 <= len(rows) <= 239
    for r in rows:
        assert want <= set(r), sorted(want - set(r))
        assert all(np.isfinite(float(v)) for v in r.values())
    assert [r["step"] for r in rows] == [62_000_000 + ROLLOUT * k for k in range(len(rows))]
    walls = [before[-1]["wall_s"]] + [r["wall_s"] for r in rows]
    assert all(a < b for a, b in zip(walls, walls[1:]))


def leg_dirs():
    return sorted(d for d in os.listdir(RUN) if d.startswith("leg_"))


def test_the_legs_chain_and_launch_only_nlplant_distilled():
    legs = leg_dirs()
    assert legs and legs[0] == "leg_1"
    rows = read_jsonl(os.path.join(RUN, "metrics.jsonl"))
    first = json.load(open(os.path.join(FIRST, "leg.json"), encoding="utf-8"))
    episodes, flags = 0, first["argv"][first["argv"].index("--") + 1:]
    for i, name in enumerate(legs):
        leg = json.load(open(os.path.join(RUN, name, "leg.json"), encoding="utf-8"))
        prev = "tracking_torch" if i == 0 else legs[i - 1]
        assert os.path.basename(leg["resumed_from"].rstrip("/")) == prev
        assert leg["rc"] == 0
        episodes += leg["episodes"]
        assert leg["steps"] == rows[episodes - 1]["step"]
        assert leg["wall_s"] == rows[episodes - 1]["wall_s"]
        phases = read_jsonl(os.path.join(RUN, name, "phases.jsonl"))
        assert len(phases) == leg["episodes"]
        for k, ph in enumerate(phases, 1):   # the child's counts so far
            assert ph["launches"] == {**{n: 0 for n in ph["launches"]},
                                      "nlplant_distilled": XDOT_PER_EPISODE * k}
        # the first run's flags, resumed from the leg before, to 3e8 in all
        argv = leg["argv"]
        for flag in ("--seed", "--low-level-ckpt", "--n-rollout-threads", "--buffer-size",
                     "--num-mini-batch", "--ppo-epoch", "--lr", "--entropy-coef",
                     "--data-chunk-length", "--scenario-name"):
            assert argv[argv.index(flag) + 1] == flags[flags.index(flag) + 1], flag
        assert "--aero-backend" not in argv
        assert argv[argv.index("--low-level-ckpt") + 1] == "results/control/policy_checkpoint.pkl"
        done = 61_000_000 + ROLLOUT * (episodes - leg["episodes"])
        assert int(argv[argv.index("--num-env-steps") + 1]) == 300_000_000 - done
    assert episodes == len(rows)


def test_curve_table_reproduces_the_report():
    ct = load_tool("curve_table")
    runs = [ct.read_episode_rows(os.path.join(d, "metrics.jsonl"), *map(int, tok.split(":")),
                                 FIRST_EPISODE)
            for d, tok in zip((JAX_RUN, RUN), EPISODE_ROWS)]
    labels = ["JAX", "port"]
    lines = (ct.table(runs, labels, None, ct.parse_rows(REPORT_ROWS), "episode", terms=True,
                      keys=["policy_entropy_loss"])
             + ct.crossing_lines(runs, labels, REWARD_CROSSINGS, WINDOW, "episode", ct.reward)
             + ct.span_lines(runs, labels, SPANS, terms=True, counts=True))
    # the resume rule over the whole run (results/tracking_torch, then this one)
    whole = [ct.read_episode_rows(path, 1, 300) for path in (
        os.path.join(JAX_RUN, "metrics.jsonl"),
        f"{os.path.join(FIRST, 'metrics.jsonl')},{os.path.join(RUN, 'metrics.jsonl')}")]
    resumes = [61 + sum(json.load(open(os.path.join(RUN, leg, "leg.json"),
                                       encoding="utf-8"))["episodes"]
                        for leg in leg_dirs()[:k]) for k in range(len(leg_dirs()))]
    lines += ct.continuity_lines(*whole, resumes, WINDOW, labels=labels, unit="episode")
    with open(os.path.join(RUN, "REPORT.md"), encoding="utf-8") as f:
        report = f.read().splitlines()
    assert len(lines) > 20
    for line in lines:
        assert line in report, line


def test_curve_table_first_episode_and_reward_crossings(tmp_path):
    ct = load_tool("curve_table")
    path = tmp_path / "m.jsonl"
    rewards = [-300.0, -260.0, -240.0, -250.0, -200.0]
    path.write_text("".join(json.dumps({"step": 7 * (k + 1), "episodes_reached_target": 1,
                                        "episodes_failed": 9, "average_episode_rewards": w})
                            + "\n" for k, w in enumerate(rewards)))
    run = ct.read_episode_rows(str(path), 2, 5, 62)
    assert sorted(run) == [62, 63, 64, 65]
    assert run[62]["average_episode_rewards"] == -260.0
    assert ct.first_window_crossing(run, -245.0, 2, ct.reward) == 64   # (-240 - 250) / 2
    assert ct.first_window_crossing(run, -240.0, 1, ct.reward) == 63
    assert ct.first_window_crossing(run, -100.0, 1, ct.reward) is None
    assert ct.crossing_lines([run], ["a"], [-245.0, -100.0], 2, "episode", ct.reward) == [
        "a: first rolling 2-episode mean reward >= -245 at episode 64, >= -100 not "
        "reached (last episode 65)"]
    with pytest.raises(SystemExit):
        ct.read_episode_rows(str(path), 2, 6)
    assert ct.main([str(path), "--episode-rows", "1:5", "--first-episode", "10",
                    "--rows", "10:14:2", "--crossings", "--reward-crossings", "-245",
                    "--window", "2"]) == 0


def test_curve_table_joined_files_and_continuity(tmp_path):
    ct = load_tool("curve_table")
    recs = [{"step": k, "episodes_reached_target": 100 + k, "episodes_failed": 900,
             "average_episode_rewards": -300.0 + 2 * k + (k % 2)} for k in range(1, 17)]
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    a.write_text("".join(json.dumps(r) + "\n" for r in recs[:12]))
    b.write_text("".join(json.dumps(r) + "\n" for r in recs[12:]))
    joined = ct.read_metrics(f"{a},{b}")
    assert sorted(joined) == list(range(1, 17))
    assert ct.read_episode_rows(f"{a},{b}", 12, 14, 12)[14] == recs[13]
    # the reference rises by 2 per episode with no noise; the run is the same
    ref = {k: {**r, "average_episode_rewards": -300.0 + 2 * k} for k, r in joined.items()}
    (line,) = ct.continuity_lines(ref, joined, [12], window=10, labels=("JAX", "port"),
                                  unit="episode")
    rew = [-300.0 + 2 * k + (k % 2) for k in range(3, 13)]
    m, sd = np.mean(rew), np.std(rew)
    d = (-300.0 + 2 * 15) - np.mean([-300.0 + 2 * k for k in range(3, 13)])
    assert f"port 3-12 reward {m:.2f} (sd {sd:.2f}), reached 107.5" in line
    assert f"JAX rise to episode 15 {d:+.2f}" in line
    assert f"reward {recs[14]['average_episode_rewards']:.2f} in {m + d - 3 * sd:.2f} to " \
           f"{m + d + 3 * sd:.2f} (holds)" in line
    assert "reached 115 in 71.7 to 161.2 (holds)" in line
    assert line.endswith("first episode 13: reward -273.00, reached 113")
    # a reward outside m + d +- 3 sd fails its part
    joined[15] = {**joined[15], "average_episode_rewards": -400.0}
    assert "(fails)" in ct.continuity_lines(ref, joined, [12])[0]


@pytest.mark.parametrize("leg", ["tracking_torch", "tracking_torch_final/leg_1"])
def test_leg_summary_reads_the_run_directory(leg):
    tl = load_tool("train_legs")
    out = os.path.join(REPO, "results", leg)
    got = tl.summarize_leg(out)
    meta = json.load(open(os.path.join(out, "leg.json"), encoding="utf-8"))
    assert got["episodes"] == meta["episodes"]
    assert got["steps"][1] == meta["steps"]
    assert got["steps"][1] - got["steps"][0] == ROLLOUT * (meta["episodes"] - 1)
    assert got["launches"]["nlplant_distilled"] == XDOT_PER_EPISODE * meta["episodes"]
    assert all(a <= b <= c for a, b, c in (got["episode_s"], got["collect_ms_per_step"],
                                          got["update_s"]))
    assert 0.0 < got["collect_share"] + got["update_share"] <= 1.0
    if leg == "tracking_torch":   # results/tracking_torch/REPORT.md's speed table
        assert got["collect_ms_per_step"] == [131.837, 162.869, 216.462]
        assert got["update_s"] == [2.7865, 2.8005, 3.4779]
        assert got["episode_s"][0] == 16.03 and got["episode_s"][2] == 24.5
        assert (got["collect_s"], got["update_s_total"], got["peak_mib"]) == \
            (999.08, 172.03, 4311.8)


@pytest.mark.parametrize("run", ["tracking", "tracking_torch_final"])
def test_heading_eval_prints_the_same_log_std_in_both_packages(run, capsys):
    """`tools/heading_eval.py`'s `log_std` (the REPORT's per-action log
    std of the committed and the final actor), one 1-step eval of 2 envs
    in each package."""
    tool = load_tool("heading_eval")
    ckpt = os.path.join(REPO, "results", run, "policy_checkpoint.pkl")
    got = {}
    for package in ("jax", "port"):
        tool.main(["--package", package, "--env-name", "Planning", "--scenario", "tracking",
                   "--checkpoint", ckpt, "--n", "2", "--steps", "1", "--repeats", "1",
                   "--backend", "stacked"])
        got[package] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["log_std"]
    assert len(got["jax"]) == 3
    np.testing.assert_allclose(got["port"], got["jax"], rtol=0, atol=1e-7)
