"""The port's control run (results/control_torch) against the JAX package (CPU).

- The first episode of the control run from one untrained actor and critic
  (500 envs, 320 steps, "pallas", the JAX side in interpret mode, the
  overload check at the post-step state as the JAX run's first leg had it:
  `reuse_step_xdot: false`): each `termination/*` count, the targets
  reached, the episodes failed and the average episode reward of the port's
  collect against the JAX package's. The packages draw from different
  generators, so a count c is held within 4 sqrt(c + c') + 1 of the
  other's, and the reward within 0.5% (at 1000 envs x 1000 steps they
  differ by 0.29%, results/control_torch/REPORT.md).
- What a resume carries: `tools/train_legs.py` on the control scenario at
  tiny widths, a leg stopped after its first episode and a second leg
  resumed from it, against one unbroken run of the train CLI to the same
  step. Leg A's `state_latest.pt` holds the unbroken run's policy, Adam
  moments and count, update count and generator state after its first
  episode bit for bit; the legs' steps continue (16, 32, 48); and the
  first episode after the resume starts from fresh resets (as the JAX
  runner's restore, which carries no env state either): it equals one
  episode of a runner restored from leg A's checkpoint, and differs from
  the unbroken run's second episode, which flies on from its env state.
- The committed artifacts: the port-trained actor-only pickle grafts into
  the JAX package's F16SimRunner on ControlEnv("control") with the
  structure and leaf shapes of its init params, and its deterministic
  actions and hidden states on three steps of seeded observations agree
  with the port's within 1e-5; `results/control_torch/metrics.jsonl`
  carries every key of the JAX run's lines with steps every 3e6 from
  3,000,000 to 789,000,000; `tools/curve_table.py` reproduces the REPORT's
  table, crossings and spans from both runs' files.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
from neuralplane_tpu.envs import ControlEnv as JaxControlEnv
from neuralplane_tpu.runner import F16SimRunner as JF16SimRunner
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.envs import ControlEnv
from neuralplane_tpu_torch.runner import F16SimRunner
from neuralplane_tpu_torch.scripts import train
from neuralplane_tpu_torch.utils.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RUN = os.path.join(REPO, "results", "control")
PORT_RUN = os.path.join(REPO, "results", "control_torch")
PORT_CKPT = os.path.join(PORT_RUN, "policy_checkpoint.pkl")
SCENARIO = os.path.join(PORT_RUN, "control_post_step_xdot.yaml")
ACT_TOL = 1e-5
# the JAX leg's rows (results/control/metrics.jsonl rows 1-263)
LAST_STEP = 789_000_000
EPISODE_STEPS = 3_000_000
# results/control_torch/REPORT.md's curve_table invocation
REPORT_ROWS = ["3e6:7.89e8:6e7"]
CROSSINGS = [0.25, 0.5, 0.55, 0.6]
WINDOW = 10
SPANS = ["3e6:3e6", "3.75e8:4.02e8", "4.05e8:4.05e8", "4.14e8:4.41e8", "7.62e8:7.89e8"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's small tensors (the suite runs six
    workers on the host's cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def load_tool(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_jsonl(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def test_first_collect_tracks_the_jax_package(tmp_path):
    tool = load_tool("heading_collect_compare")
    args = argparse.Namespace(scenario="control", n=500, steps=320, seed=1, backend="pallas",
                              tmp=str(tmp_path), set={"reuse_step_xdot": False},
                              update=False)
    cfg_kw = dict(n_rollout_threads=args.n, buffer_size=args.steps, data_chunk_length=8, seed=1)
    jrun, jout, jstats, _ = tool.run_jax(args, cfg_kw)
    pout, pstats, _ = tool.run_port(args, cfg_kw, jax.tree.map(np.asarray, jrun.train_state.params))
    jrun.close()
    assert set(pout) == set(jout)
    assert set(jstats) == set(pstats) == {"altitude_ft", "vt", "target_pitch",
                                          "target_heading", "target_vt"}
    assert jout["episodes_failed"] > 1000
    assert jout["termination/overload"] >= 0.95 * jout["episodes_failed"]
    for k, want in jout.items():
        if k == "average_episode_rewards":
            assert abs(pout[k] - want) <= 0.005 * abs(want), (k, pout[k], want)
        else:
            assert abs(pout[k] - want) <= 4 * np.sqrt(pout[k] + want) + 1, (k, pout[k], want)


TINY = ["--env-name", "Control", "--scenario-name", SCENARIO, "--aero-backend", "pallas",
        "--seed", "3", "--n-rollout-threads", "2", "--buffer-size", "8",
        "--data-chunk-length", "4", "--num-mini-batch", "1", "--ppo-epoch", "2",
        "--hidden-size", "16", "--act-hidden-size", "8", "--recurrent-hidden-size", "8",
        "--log-interval", "1", "--save-interval", "1", "--device", "cpu"]


def assert_states_equal(got, want, path="state"):
    """Nested dicts, lists and tensors equal bit for bit."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_states_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_states_equal(g, w, f"{path}/{i}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path
    else:
        assert got == want, path


def test_resume_carries_the_whole_state(tmp_path):
    unbroken, replica = tmp_path / "unbroken", tmp_path / "replica"
    leg_a, leg_b = tmp_path / "leg_A", tmp_path / "leg_B"
    cli = [sys.executable, "-m", "neuralplane_tpu_torch.scripts.train", *TINY]
    tool = [sys.executable, os.path.join(REPO, "tools", "train_legs.py")]
    # one thread in every process, so that all of them sum alike
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for cmd in (cli + ["--num-env-steps", "48", "--run-dir", str(unbroken)],
                tool + ["--out", str(leg_a), "--budget-s", "0", "--", *TINY,
                        "--num-env-steps", "48"],
                tool + ["--out", str(leg_b), "--resume", str(leg_a), "--budget-s", "600",
                        "--", *TINY, "--num-env-steps", "48"],
                cli + ["--num-env-steps", "16", "--run-dir", str(replica),
                       "--model-dir", str(leg_a / "state_latest.pt")]):
        subprocess.run(cmd, cwd=REPO, env=env, check=True, capture_output=True, timeout=600)
    legs = [json.loads((d / "leg.json").read_text()) for d in (leg_a, leg_b)]
    assert [leg["episodes"] for leg in legs] == [1, 2]

    # leg A's checkpoint is the unbroken run's after its first episode
    state_a = load_checkpoint(str(leg_a / "state_latest.pt"))
    state_0 = load_checkpoint(str(unbroken / "checkpoints" / "state_ep0.pt"))
    assert set(state_a) == set(state_0) >= {"policy", "optimizer", "step", "generator"}
    assert state_a["step"] == state_0["step"] > 0
    assert_states_equal(state_a["policy"], state_0["policy"], "policy")
    adam = state_0["optimizer"]["state"]
    assert adam and all({"exp_avg", "exp_avg_sq", "step"} <= set(v) for v in adam.values())
    assert_states_equal(state_a["optimizer"], state_0["optimizer"], "optimizer")
    assert torch.equal(state_a["generator"], state_0["generator"])

    rows_b = read_jsonl(leg_b / "metrics.jsonl")
    steps = [r["step"] for d in (leg_a, leg_b) for r in read_jsonl(d / "metrics.jsonl")]
    assert steps == [16, 32, 48]

    # the first episode after the resume is one episode of a fresh run from
    # leg A's checkpoint (the train CLI with --model-dir, whose runner
    # starts from env.reset: every step count 0, the memory zeroed) ...
    args = train.get_parser().parse_args(TINY + ["--num-env-steps", "16"])
    run = F16SimRunner(train.make_env(args), train.args_to_config(args),
                       run_dir=str(tmp_path / "probe"), model_dir=str(leg_a / "state_latest.pt"))
    run.close()
    carry = run.init_carry(run.next_seed())
    assert not carry.env_state.step_count.any() and not carry.h_actor.any()
    assert bool((carry.masks == 1).all())
    skip = {"step", "wall_s", "fps"}
    fresh = read_jsonl(replica / "metrics.jsonl")[0]
    assert {k: v for k, v in rows_b[0].items() if k not in skip} == \
        {k: v for k, v in fresh.items() if k not in skip}
    # ... and not the unbroken run's second episode, which flew on from its
    # env state with the same policy, Adam and generator
    unbroken_1 = read_jsonl(unbroken / "metrics.jsonl")[1]
    assert rows_b[0]["average_episode_rewards"] != unbroken_1["average_episode_rewards"]


def test_curve_table_windows_and_spans(tmp_path):
    """The rolling crossings and the spans on a small synthetic file."""
    ct = load_tool("curve_table")
    shares = [0.0, 0.2, 0.4, 0.6, 0.8, 0.5]
    recs = [{"step": 10 * (i + 1), "episodes_reached_target": 100 * s,
             "episodes_failed": 100 * (1 - s), "average_episode_rewards": -10.0 + i}
            for i, s in enumerate(shares)]
    path = tmp_path / "m.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    run = ct.read_metrics(str(path))
    assert ct.first_window_crossing(run, 0.35, 3) == 40    # (0.2 + 0.4 + 0.6) / 3
    assert ct.first_window_crossing(run, 0.6, 3) == 50
    assert ct.first_window_crossing(run, 0.65, 3) is None
    assert ct.first_window_crossing(run, 0.8, 1) == ct.first_crossing(run, 0.8) == 50
    assert ct.crossing_lines([run], ["a"], [0.35], 3) == [
        "a: first rolling 3-episode success share >= 35% at 40 (last step 60)"]
    st = ct.span_stats(run, 20, 40)
    assert st["episodes"] == 3
    assert st["success"] == pytest.approx(0.4) and st["success_sd"] == pytest.approx(0.2)
    assert st["reward"] == pytest.approx(-8.0) and st["reward_sd"] == pytest.approx(1.0)
    assert ct.span_lines([run], ["a"], ["20:40", "70:80"]) == [
        "a 20-40: 3 episodes, success 0.4000 (sd 0.2000), reward -8.00 (sd 1.00)",
        "a 70-80: no logged episode"]


def test_port_trained_actor_grafts_into_the_jax_runner(tmp_path):
    env = ControlEnv(num_envs=2, config="control", device="cpu")
    run = F16SimRunner(env, RLConfig(), run_dir=str(tmp_path / "port"), model_dir=PORT_CKPT)
    run.close()
    actor = run.policy.actor

    jenv = JaxControlEnv(num_envs=64, config="control", aero_backend="stacked")
    jrun = JF16SimRunner(jenv, JRLConfig(), run_dir=str(tmp_path / "jax"), model_dir=PORT_CKPT)
    jrun.close()
    grafted = jrun.train_state.params["actor"]
    init = jrun.policy.init_params(jax.random.PRNGKey(0))["actor"]
    assert jax.tree_util.tree_structure(grafted) == jax.tree_util.tree_structure(init)
    shapes = jax.tree.map(lambda a, b: (np.shape(a), np.shape(b)), grafted, init)
    for got, want in jax.tree.leaves(shapes, is_leaf=lambda x: isinstance(x, tuple)):
        assert got == want

    # three reset observations of the JAX env, the memory carried across them
    jh = np.zeros((jenv.n, 1, 128), np.float32)
    h = torch.from_numpy(jh)
    masks = np.ones((jenv.n, 1), np.float32)
    for seed in range(3):
        _, obs = jenv.reset(jax.random.PRNGKey(seed))
        obs = np.array(obs)   # a writable copy for torch.from_numpy
        ja, jh = jrun.policy.act(jrun.train_state.params, obs, jh, masks, deterministic=True)
        with torch.no_grad():
            mean, _, h = actor.step(torch.from_numpy(obs), h, torch.from_numpy(masks))
        np.testing.assert_allclose(mean.numpy(), np.asarray(ja), rtol=ACT_TOL, atol=ACT_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=ACT_TOL, atol=ACT_TOL)


def test_port_metrics_carry_the_jax_keys_and_cross_the_resume():
    want = set().union(*(r.keys() for r in read_jsonl(os.path.join(JAX_RUN, "metrics.jsonl"))))
    rows = read_jsonl(os.path.join(PORT_RUN, "metrics.jsonl"))
    for r in rows:
        assert want <= set(r), sorted(want - set(r))
        assert all(np.isfinite(float(v)) for v in r.values())
    assert [r["step"] for r in rows] == list(range(EPISODE_STEPS, LAST_STEP + 1, EPISODE_STEPS))
    legs = {name: json.load(open(os.path.join(PORT_RUN, name, "leg.json"), encoding="utf-8"))
            for name in ("leg_A", "leg_B")}
    assert legs["leg_A"]["resumed_from"] is None
    assert os.path.basename(legs["leg_B"]["resumed_from"].rstrip("/")) == "leg_A"
    assert legs["leg_A"]["steps"] == rows[legs["leg_A"]["episodes"] - 1]["step"]
    assert legs["leg_B"]["steps"] == LAST_STEP
    assert legs["leg_A"]["episodes"] + legs["leg_B"]["episodes"] == len(rows)
    for name, leg in legs.items():
        phases = read_jsonl(os.path.join(PORT_RUN, name, "phases.jsonl"))
        assert len(phases) == leg["episodes"]
        # the child's counts so far: two nlplant_grouped per collected step
        assert phases[-1]["launches"] == {**{k: 0 for k in phases[-1]["launches"]},
                                          "nlplant_grouped": 2 * 1000 * leg["episodes"]}


def test_curve_table_reproduces_the_report():
    ct = load_tool("curve_table")
    runs = [ct.read_metrics(os.path.join(d, "metrics.jsonl")) for d in (JAX_RUN, PORT_RUN)]
    labels = ["JAX", "port"]
    lines = (ct.table(runs, labels, LAST_STEP, ct.parse_rows(REPORT_ROWS))
             + ct.crossing_lines(runs, labels, CROSSINGS, WINDOW)
             + ct.span_lines(runs, labels, SPANS))
    with open(os.path.join(PORT_RUN, "REPORT.md"), encoding="utf-8") as f:
        report = f.read().splitlines()
    assert len(lines) > 20
    for line in lines:
        assert line in report, line
