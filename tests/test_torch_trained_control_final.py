"""The port's last control leg (results/control_torch_final) against the JAX
package and the JAX run's records (CPU).

- The run directory: 161 episode lines with the JAX run's keys on one step
  axis (1.536e9 to 2.976e9 by 9e6: the JAX run's rows 352-512 after the
  port's 1.527e9 of results/control_torch_stepstart); each leg's launch
  counts (3,000 `env_step` per episode, no other kernel), each leg resumed
  from the one before it.
- The lineage: the final state's Adam count is 40,640, the committed JAX
  policy's (508 episodes of 16 epochs x 5 minibatches).
- The exported actor grafts into the JAX runner, its actions and GRU
  states within 1e-5 of the port's.
- `tools/curve_table.py --episode-rows ... --terms` reproduces the REPORT's
  table, crossings and spans.
- The reward by term: one collect of each package from the final actor
  (`tools/heading_collect_compare.py --reward-terms`), its reward sum split
  into the event term (each package's own `event_driven_reward` on each
  step's done and bad flags) and the shaped term; the two sum to the
  logged reward, the event term is what the logged counters imply, and
  `curve_table.shaped_per_end` reads the same shaped term from the logged
  line alone.
- The final actor as the frozen low level of both packages'
  PlanningEnv("tracking"): the JAX-trained tracking policy's action on the
  reset observations within 1e-5 in both packages, then one high-level
  step (5 inner steps) at tests/test_torch_planning.py's tolerances.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
from neuralplane_tpu.envs import ControlEnv as JaxControlEnv
from neuralplane_tpu.envs import PlanningEnv as JaxPlanningEnv
from neuralplane_tpu.runner import F16SimRunner as JF16SimRunner
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.envs import ControlEnv, PlanningEnv
from neuralplane_tpu_torch.runner import F16SimRunner
from neuralplane_tpu_torch.utils.checkpoint import load_checkpoint, load_jax_pickle

from test_torch_planning import N, make_envs, side_by_side, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RUN = os.path.join(REPO, "results", "control")
RUN = os.path.join(REPO, "results", "control_torch_final")
FINAL = os.path.join(RUN, "policy_checkpoint.pkl")
TRACKING = os.path.join(REPO, "results", "tracking", "policy_checkpoint.pkl")
ACT_TOL = 1e-5   # tests/test_torch_trained_tracking.py's
UPDATES_PER_EPISODE = 16 * 5   # ppo_epoch x num_mini_batch
STEPS = list(range(1_536_000_000, 2_976_000_000 + 1, 9_000_000))   # 161 x 3000 x 3000
# results/control_torch_final/REPORT.md's curve_table invocation
EPISODE_ROWS = ["352:512", "1:161"]
REPORT_ROWS = ["1:161:20", "2", "3", "161"]
CROSSINGS = [0.8, 0.82, 0.85]
WINDOW = 10
SPANS = ["1:1", "1:10", "81:90", "152:161"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's small tensors (the suite runs six
    workers on the host's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def load_tool(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_jsonl(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def test_the_run_directory_carries_the_jax_keys_on_one_axis():
    want = set().union(*(r.keys() for r in read_jsonl(os.path.join(JAX_RUN, "metrics.jsonl"))))
    rows = read_jsonl(os.path.join(RUN, "metrics.jsonl"))
    assert len(rows) == 161
    for r in rows:
        assert want <= set(r), sorted(want - set(r))
        assert all(np.isfinite(float(v)) for v in r.values())
    assert [r["step"] for r in rows] == STEPS
    before = read_jsonl(os.path.join(REPO, "results", "control_torch_stepstart",
                                     "metrics.jsonl"))[-1]
    assert before["step"] + 9_000_000 == STEPS[0]
    walls = [before["wall_s"]] + [r["wall_s"] for r in rows]
    assert all(a < b for a, b in zip(walls, walls[1:]))


def test_the_port_run_ends_at_the_committed_policys_508_updates():
    state = load_checkpoint(os.path.join(RUN, "state_latest.pt"))
    assert state["step"] == 40_640 == 508 * UPDATES_PER_EPISODE
    assert {int(v["step"]) for v in state["optimizer"]["state"].values()} == {40_640}
    ts = load_jax_pickle(os.path.join(JAX_RUN, "policy_checkpoint.pkl"))["train_state"]
    assert ts.step == ts.opt_state[0].count == state["step"]
    with open(os.path.join(JAX_RUN, "policy_checkpoint.pkl"), "rb") as f:
        assert int(pickle.load(f)["train_state"].step) == state["step"]


def leg_dirs():
    return sorted(d for d in os.listdir(RUN) if d.startswith("leg_"))


def test_the_legs_launch_only_env_step():
    legs = leg_dirs()
    assert legs[:2] == ["leg_F", "leg_G"] and len(legs) <= 3
    rows = read_jsonl(os.path.join(RUN, "metrics.jsonl"))
    episodes = 0
    for i, name in enumerate(legs):
        leg = json.load(open(os.path.join(RUN, name, "leg.json"), encoding="utf-8"))
        prev = "control_torch_stepstart" if i == 0 else legs[i - 1]
        assert os.path.basename(leg["resumed_from"].rstrip("/")) == prev
        episodes += leg["episodes"]
        assert leg["steps"] == rows[episodes - 1]["step"]
        phases = read_jsonl(os.path.join(RUN, name, "phases.jsonl"))
        assert len(phases) == leg["episodes"]
        for k, ph in enumerate(phases, 1):   # the child's counts so far
            assert ph["launches"] == {**{n: 0 for n in ph["launches"]}, "env_step": 3000 * k}
        argv = leg["argv"]
        for flag, value in (("--scenario-name", "control"), ("--aero-backend", "distilled"),
                            ("--buffer-size", "3000"), ("--n-rollout-threads", "3000"),
                            ("--ppo-epoch", "16"), ("--num-mini-batch", "5")):
            assert argv[argv.index(flag) + 1] == value, flag
    assert episodes == 161


def test_exported_actor_grafts_into_the_jax_runner(tmp_path):
    env = ControlEnv(num_envs=2, config="control", device="cpu")
    run = F16SimRunner(env, RLConfig(), run_dir=str(tmp_path / "port"), model_dir=FINAL)
    run.close()
    actor = run.policy.actor
    # the pickle is the final state's actor
    final = load_checkpoint(os.path.join(RUN, "state_latest.pt"))["policy"]
    for k, v in actor.state_dict().items():
        assert torch.equal(v, final[f"actor.{k}"]), k

    jenv = JaxControlEnv(num_envs=64, config="control", aero_backend="stacked")
    jrun = JF16SimRunner(jenv, JRLConfig(), run_dir=str(tmp_path / "jax"), model_dir=FINAL)
    jrun.close()
    grafted = jrun.train_state.params["actor"]
    init = jrun.policy.init_params(jax.random.PRNGKey(0))["actor"]
    assert jax.tree_util.tree_structure(grafted) == jax.tree_util.tree_structure(init)
    jh = np.zeros((jenv.n, 1, 128), np.float32)
    h = torch.from_numpy(jh)
    masks = np.ones((jenv.n, 1), np.float32)
    for seed in range(3):
        _, obs = jenv.reset(jax.random.PRNGKey(seed))
        obs = np.array(obs)
        ja, jh = jrun.policy.act(jrun.train_state.params, obs, jh, masks, deterministic=True)
        with torch.no_grad():
            mean, _, h = actor.step(torch.from_numpy(obs), h, torch.from_numpy(masks))
        np.testing.assert_allclose(mean.numpy(), np.asarray(ja), rtol=ACT_TOL, atol=ACT_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=ACT_TOL, atol=ACT_TOL)


def test_curve_table_reproduces_the_report():
    ct = load_tool("curve_table")
    runs = [ct.read_episode_rows(os.path.join(d, "metrics.jsonl"), *map(int, tok.split(":")))
            for d, tok in zip((JAX_RUN, RUN), EPISODE_ROWS)]
    labels = ["JAX", "port"]
    lines = (ct.table(runs, labels, None, ct.parse_rows(REPORT_ROWS), "episode", terms=True)
             + ct.crossing_lines(runs, labels, CROSSINGS, WINDOW, "episode")
             + ct.span_lines(runs, labels, SPANS, terms=True))
    with open(os.path.join(RUN, "REPORT.md"), encoding="utf-8") as f:
        report = f.read().splitlines()
    assert len(lines) > 20
    for line in lines:
        assert line in report, line


def test_reward_split_sums_to_the_logged_reward(tmp_path):
    """One collect of each package from the final actor, 64 envs x 480
    steps on the fused distilled step (the JAX kernel in interpret mode, its
    draws outside the kernel), a target timing out after 300 steps instead
    of 2500 so that a short collect holds both kinds of event: event +
    shaped is the reward sum, which is
    the logged average times the episode ends; the event sum is 200 x
    (reached - failed); no step's shaped share is positive; and the shaped
    term per end read from the logged line alone is the collect's."""
    cc, ct = load_tool("heading_collect_compare"), load_tool("curve_table")
    args = argparse.Namespace(scenario="control", n=64, steps=480, seed=1, backend="distilled",
                              tmp=str(tmp_path), set={"max_check_interval": 300}, update=False,
                              checkpoint=FINAL,
                              reward_terms=True)
    cfg_kw = cc.collect_config(args)
    jrun, jout, _, _ = cc.run_jax(args, cfg_kw)
    jrun.close()
    pout, _, _ = cc.run_port(args, cfg_kw, args.jax_params)
    for name, out in (("jax", jout), ("port", pout)):
        rt = out["reward_terms"]
        reached, failed = out["episodes_reached_target"], out["episodes_failed"]
        assert reached > 10 and failed > 0, (name, out)
        assert rt["identity"], (name, rt)
        assert rt["ends"] == reached + failed
        assert rt["event_sum"] == cc.EVENT_REWARD * (reached - failed)
        assert rt["event_sum"] + rt["shaped_sum"] == pytest.approx(rt["reward_sum"], rel=1e-12)
        # the logged average sums the rewards in float32, the split in float64
        assert rt["reward_sum"] == pytest.approx(out["average_episode_rewards"] * rt["ends"],
                                                 rel=1e-6)
        assert rt["shaped_max"] <= 0.0 and rt["shaped_sum"] < 0.0
        assert ct.shaped_per_end(out) == pytest.approx(rt["shaped_per_end"], rel=1e-6)
        assert rt["shaped_per_step"] == pytest.approx(rt["shaped_sum"] / (64 * 480), rel=1e-12)


def test_curve_table_terms_column(tmp_path):
    ct = load_tool("curve_table")
    rec = {"step": 9, "episodes_reached_target": 75, "episodes_failed": 25,
           "average_episode_rewards": -40.0}
    # event term per end 200 x (75 - 25) / 100 = 100
    assert ct.shaped_per_end(rec) == pytest.approx(-140.0)
    assert ct.table([{9: rec}], ["a"], rows=[9], terms=True)[2] == \
        "| 9 | 75 | 25 | 75.0% | -40.0 | -140.0 |"
    assert ct.table([{9: rec}, {}], ["a", "b"], upto=9, rows=[9], terms=True)[0].endswith(
        "| b avg reward | b shaped/end |")
    assert ct.span_lines([{9: rec}], ["a"], ["0:9"], terms=True, rollout=1000) == [
        "a 0-9: 1 episodes, success 0.7500 (sd 0.0000), reward -40.00 (sd 0.00), "
        "shaped/end -140.00 (sd 0.00), ends 100.0, shaped/step -14.0000"]


def test_final_actor_as_the_low_level_of_both_planning_envs(monkeypatch, interpret_pallas,
                                                            tmp_path):
    with open(FINAL, "rb") as f:   # the JAX package's own reader: an actor-only pickle
        low = to_np(pickle.load(f))
    jenv, env = make_envs(low, monkeypatch, "distilled")
    # the JAX-trained high level on both sides, on the same reset observations
    jrun = JF16SimRunner(JaxPlanningEnv(num_envs=N, config="tracking",
                                        low_level_params=jax.tree.map(jnp.asarray, low)),
                         JRLConfig(), run_dir=str(tmp_path / "jax"), model_dir=TRACKING)
    jrun.close()
    prun = F16SimRunner(PlanningEnv(num_envs=2, device="cpu"), RLConfig(),
                        run_dir=str(tmp_path / "port"), model_dir=TRACKING)
    prun.close()
    _, obs = jenv.reset(jax.random.PRNGKey(5))
    obs = np.array(obs)
    jh = np.zeros((N, 1, 128), np.float32)
    masks = np.ones((N, 1), np.float32)
    ja, _ = jrun.policy.act(jrun.train_state.params, obs, jh, masks, deterministic=True)
    with torch.no_grad():
        mean, _, _ = prun.policy.actor.step(torch.from_numpy(obs), torch.from_numpy(jh),
                                            torch.from_numpy(masks))
    np.testing.assert_allclose(mean.numpy(), np.asarray(ja), rtol=ACT_TOL, atol=ACT_TOL)
    # one high-level step of both envs over the final actor
    side_by_side(jenv, env, steps=1)
