"""The port's control run in the step-start regime (results/control_torch_stepstart)
against the JAX package and the JAX run's records (CPU).

- The in-step reset: one step of the distilled fused step from the
  all-done state, every row reset inside it; the moments of the altitude,
  speed and targets of the port's in-step draws against the JAX package's
  reset, within 4 standard errors (spreads within 5%).
- A resume across a change of semantics: a port state trained for one tiny
  episode on the post-step portable step (`control_post_step_xdot.yaml`,
  "pallas") is resumed by `tools/train_legs.py` on `control`/"distilled"
  (the fused step, its reset draws and noise inside the step) at another
  buffer size and env count. The runner restored on the new configuration
  holds the policy, the Adam moments and count, the update count and the
  generator of the checkpoint bit for bit; the step axis continues; the
  first collect's `termination/*` counts, targets reached and episodes
  failed agree with the JAX package's collect of the same carried actor on
  its fused path (interpret mode, its draws outside the kernel) within
  4 sqrt(c + c') + 1, as `test_torch_trained_control.py` holds its first
  collect.
- The lineage: the committed JAX policy's Adam count is 40,640 = 80 x 508
  (266 + 81 + 161 episodes of 16 epochs x 5 minibatches), and the JAX
  run's rows 267 and 352 log the same step (the axis restarts on a
  resume); the port's final state has the count of 347 episodes, 27,760.
- The run directory: 84 lines with the JAX run's keys on one step axis
  (7.92e8 to 7.98e8 by 3e6, then 8.07e8 to 1.527e9 by 9e6); each leg's
  launch counts (6,000 `nlplant_grouped` in the bridge, 3,000 `env_step`
  per switch episode, no other kernel); the exported actor grafting into
  the JAX runner with the port's actions within 1e-5; `curve_table.py
  --episode-rows` reproducing the REPORT's table, and aligning by line
  where a step axis restarts.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pickle
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
from neuralplane_tpu_torch.utils.checkpoint import load_checkpoint, load_jax_pickle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RUN = os.path.join(REPO, "results", "control")
RUN = os.path.join(REPO, "results", "control_torch_stepstart")
POST_STEP = os.path.join(REPO, "results", "control_torch", "control_post_step_xdot.yaml")
ACT_TOL = 1e-5
UPDATES_PER_EPISODE = 16 * 5   # ppo_epoch x num_mini_batch
BRIDGE_STEPS = [792_000_000, 795_000_000, 798_000_000]   # rows 264-266, 3000 x 1000
SWITCH_STEPS = list(range(807_000_000, 1_527_000_000 + 1, 9_000_000))   # 81 x 3000 x 3000
# results/control_torch_stepstart/REPORT.md's curve_table invocation
EPISODE_ROWS = ["267:347", "4:84"]
REPORT_ROWS = ["1:81:10", "2", "3", "81"]
CROSSINGS = [0.5, 0.6, 0.7]
WINDOW = 10
SPANS = ["1:1", "1:10", "31:40", "41:41", "43:52", "72:81"]


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


NETS = ["--hidden-size", "16", "--act-hidden-size", "8", "--recurrent-hidden-size", "8"]
COMMON = ["--env-name", "Control", "--seed", "3", "--data-chunk-length", "8",
          "--num-mini-batch", "1", "--ppo-epoch", "2", *NETS, "--log-interval", "1",
          "--save-interval", "1", "--device", "cpu"]
POST = COMMON + ["--scenario-name", POST_STEP, "--aero-backend", "pallas",
                 "--n-rollout-threads", "2", "--buffer-size", "8"]
N, T = 200, 96
STEP_START = COMMON + ["--scenario-name", "control", "--aero-backend", "distilled",
                       "--n-rollout-threads", str(N), "--buffer-size", str(T)]


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


def test_resume_across_a_change_of_semantics(tmp_path):
    leg_a, leg_b = tmp_path / "leg_post", tmp_path / "leg_start"
    tool = [sys.executable, os.path.join(REPO, "tools", "train_legs.py")]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for cmd in (tool + ["--out", str(leg_a), "--", *POST, "--num-env-steps", "16"],
                tool + ["--out", str(leg_b), "--resume", str(leg_a), "--stop-success", "2",
                        "--", *STEP_START, "--num-env-steps", str(16 + N * T)]):
        subprocess.run(cmd, cwd=REPO, env=env, check=True, capture_output=True, timeout=600)
    ckpt = str(leg_a / "state_latest.pt")
    state_a = load_checkpoint(ckpt)
    assert state_a["step"] == 2

    # the runner of the new semantics restores the whole state bit for bit
    args = train.get_parser().parse_args(STEP_START + ["--num-env-steps", str(N * T)])
    penv = train.make_env(args)
    assert penv.fused and penv.config.kernel_reset_draws and penv.config.kernel_obs_noise
    run = F16SimRunner(penv, train.args_to_config(args), run_dir=str(tmp_path / "probe"),
                       model_dir=ckpt)
    run.close()
    assert run.trainer.step == state_a["step"]
    assert_states_equal(run.policy.state_dict(), state_a["policy"], "policy")
    assert_states_equal(run.trainer.optimizer.state_dict(), state_a["optimizer"], "optimizer")
    assert torch.equal(run.generator.get_state(), state_a["generator"])

    # the step axis continues, and so do the update and Adam counts
    rows = [r["step"] for d in (leg_a, leg_b) for r in read_jsonl(d / "metrics.jsonl")]
    assert rows == [16, 16 + N * T]
    state_b = load_checkpoint(str(leg_b / "state_latest.pt"))
    assert state_b["step"] == 4
    assert {int(v["step"]) for v in state_b["optimizer"]["state"].values()} == {4}
    assert len(read_jsonl(leg_b / "phases.jsonl")) == 1

    # the first collect after the resume against the JAX package's collect
    # of the same actor on its fused path
    pkl = str(tmp_path / "actor.pkl")
    load_tool("train_legs").export_actor(ckpt, pkl, STEP_START + ["--num-env-steps", "1"])
    cc = load_tool("heading_collect_compare")
    cargs = argparse.Namespace(scenario="control", n=N, steps=T, seed=1, backend="distilled",
                               tmp=str(tmp_path), set={}, update=False, checkpoint=pkl)
    cfg_kw = dict(n_rollout_threads=N, buffer_size=T, data_chunk_length=8, seed=1,
                  hidden_sizes=(16,), act_hidden_sizes=(8,), recurrent_hidden_size=8)
    jrun, jout, _, _ = cc.run_jax(cargs, cfg_kw)
    assert jrun.env._task_kernel
    jrun.close()
    first = read_jsonl(leg_b / "metrics.jsonl")[0]
    counts = [k for k in jout if k.startswith("termination/")]
    assert len(counts) == 6
    assert jout["episodes_failed"] > 100
    for k in counts + ["episodes_reached_target", "episodes_failed"]:
        assert abs(first[k] - jout[k]) <= 4 * np.sqrt(first[k] + jout[k]) + 1, \
            (k, first[k], jout[k])


def test_in_step_resets_follow_the_jax_package():
    """One step from the all-done state on the distilled fused step: the
    port's in-step reset draws (its plain path's) against the JAX package's
    reset (its draws outside the kernel in interpret mode); each moment of
    the altitude, speed and targets within 4 standard errors of the
    difference, each spread within 5%."""
    from jax.experimental import pallas as pl
    cc = load_tool("heading_collect_compare")
    n = 4000
    jenv = JaxControlEnv(num_envs=n, config="control", aero_backend="distilled")
    jenv.config = jenv.config.replace(kernel_obs_noise=False, kernel_reset_draws=False)
    assert jenv._task_kernel
    orig = pl.pallas_call
    pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        want = cc.jax_step_reset("control", jenv, 5)
    finally:
        pl.pallas_call = orig
    penv = ControlEnv(num_envs=n, config="control", aero_backend="distilled", device="cpu")
    penv.reset(5)
    assert penv.fused and penv.config.kernel_reset_draws
    got = cc.port_step_reset("control", penv)
    assert set(got) == set(want) == {"altitude_ft", "vt", "target_pitch", "target_heading",
                                     "target_vt"}
    for k, w in want.items():
        g = got[k]
        se = np.sqrt((g["std"] ** 2 + w["std"] ** 2) / n)
        assert abs(g["mean"] - w["mean"]) <= 4 * se, (k, g, w)
        assert abs(g["std"] / w["std"] - 1) <= 0.05, (k, g, w)


def test_the_committed_policy_took_508_updates():
    blob = load_jax_pickle(os.path.join(JAX_RUN, "policy_checkpoint.pkl"))
    ts = blob["train_state"]
    assert ts.step == ts.opt_state[0].count == 40_640 == UPDATES_PER_EPISODE * 508
    # the JAX package's own reader agrees
    with open(os.path.join(JAX_RUN, "policy_checkpoint.pkl"), "rb") as f:
        assert int(pickle.load(f)["train_state"].step) == 40_640
    rows = read_jsonl(os.path.join(JAX_RUN, "metrics.jsonl"))
    assert len(rows) == 266 + 85 + 161
    steps = [r["step"] for r in rows]
    assert steps[265] == 798_000_000 and steps[266] == steps[351] == 809_000_000
    assert steps[346] == 1_529_000_000
    # 266 first-leg episodes, the attempt's 81 before its last checkpoint
    # in the lineage, the last leg's 161
    assert (266 + 81 + 161) * UPDATES_PER_EPISODE == ts.step


def test_the_port_run_ends_at_347_episodes():
    state = load_checkpoint(os.path.join(RUN, "state_latest.pt"))
    assert state["step"] == 27_760 == 347 * UPDATES_PER_EPISODE
    assert {int(v["step"]) for v in state["optimizer"]["state"].values()} == {27_760}
    assert state["generator_device"] == "cuda"


def test_the_run_directory_carries_the_jax_keys_on_one_axis():
    want = set().union(*(r.keys() for r in read_jsonl(os.path.join(JAX_RUN, "metrics.jsonl"))))
    rows = read_jsonl(os.path.join(RUN, "metrics.jsonl"))
    assert len(rows) == 84
    for r in rows:
        assert want <= set(r), sorted(want - set(r))
        assert all(np.isfinite(float(v)) for v in r.values())
    assert [r["step"] for r in rows] == BRIDGE_STEPS + SWITCH_STEPS
    assert all(a["wall_s"] < b["wall_s"] for a, b in zip(rows, rows[1:]))


def leg_dirs():
    return sorted(d for d in os.listdir(RUN) if d.startswith("leg_"))


def test_the_legs_launch_only_their_kernel():
    legs = leg_dirs()
    assert legs[:3] == ["leg_C", "leg_D", "leg_E"] and len(legs) <= 4
    rows = read_jsonl(os.path.join(RUN, "metrics.jsonl"))
    episodes = 0
    for i, name in enumerate(legs):
        leg = json.load(open(os.path.join(RUN, name, "leg.json"), encoding="utf-8"))
        prev = "control_torch" if i == 0 else legs[i - 1]
        assert os.path.basename(leg["resumed_from"].rstrip("/")) == prev
        episodes += leg["episodes"]
        assert leg["steps"] == rows[episodes - 1]["step"]
        phases = read_jsonl(os.path.join(RUN, name, "phases.jsonl"))
        assert len(phases) == leg["episodes"]
        # the child's counts so far
        kernel, per = ("nlplant_grouped", 2 * 1000) if name == "leg_C" else ("env_step", 3000)
        assert phases[-1]["launches"] == {**{k: 0 for k in phases[-1]["launches"]},
                                          kernel: per * leg["episodes"]}
        argv = leg["argv"]
        assert argv[argv.index("--buffer-size") + 1] == ("1000" if name == "leg_C" else "3000")
    assert episodes == 84
    assert read_jsonl(os.path.join(RUN, "leg_C", "phases.jsonl"))[-1]["launches"][
        "nlplant_grouped"] == 6000


def test_exported_actor_grafts_into_the_jax_runner(tmp_path):
    ckpt = os.path.join(RUN, "policy_checkpoint.pkl")
    env = ControlEnv(num_envs=2, config="control", device="cpu")
    run = F16SimRunner(env, RLConfig(), run_dir=str(tmp_path / "port"), model_dir=ckpt)
    run.close()
    actor = run.policy.actor
    # the pickle is the final state's actor
    final = load_checkpoint(os.path.join(RUN, "state_latest.pt"))["policy"]
    for k, v in actor.state_dict().items():
        assert torch.equal(v, final[f"actor.{k}"]), k

    jenv = JaxControlEnv(num_envs=64, config="control", aero_backend="stacked")
    jrun = JF16SimRunner(jenv, JRLConfig(), run_dir=str(tmp_path / "jax"), model_dir=ckpt)
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
    lines = (ct.table(runs, labels, None, ct.parse_rows(REPORT_ROWS), "episode")
             + ct.crossing_lines(runs, labels, CROSSINGS, WINDOW, "episode")
             + ct.span_lines(runs, labels, SPANS))
    with open(os.path.join(RUN, "REPORT.md"), encoding="utf-8") as f:
        report = f.read().splitlines()
    assert len(lines) > 15
    for line in lines:
        assert line in report, line


def test_curve_table_aligns_by_episode_where_the_axis_restarts(tmp_path):
    """Two legs logged on restarted step axes, against a run on one axis:
    by step the second leg's lines would replace the first's; by episode
    each line keeps its place."""
    ct = load_tool("curve_table")
    shares = [0.1, 0.2, 0.3, 0.6, 0.7, 0.8]
    recs = [{"step": 10 * (i % 3 + 1), "episodes_reached_target": 100 * s,
             "episodes_failed": 100 * (1 - s), "average_episode_rewards": float(i)}
            for i, s in enumerate(shares)]
    restarted, straight = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    restarted.write_text("".join(json.dumps(r) + "\n" for r in recs)
                         + json.dumps({"step": 60, "eval_average_episode_rewards": 1.0}) + "\n")
    straight.write_text("".join(json.dumps({**r, "step": 5 + 7 * i}) + "\n"
                                for i, r in enumerate(recs)))
    assert len(ct.read_metrics(str(restarted))) == 4   # by step: lines lost
    a = ct.read_episode_rows(str(restarted), 4, 6)
    b = ct.read_episode_rows(str(straight), 4, 6)
    assert sorted(a) == sorted(b) == [1, 2, 3]
    assert [ct.success(a[k]) for k in (1, 2, 3)] == pytest.approx([0.6, 0.7, 0.8])
    assert a[2]["average_episode_rewards"] == b[2]["average_episode_rewards"] == 4.0
    assert ct.crossing_lines([a, b], ["a", "b"], [0.64], 2, "episode") == [
        "a: first rolling 2-episode success share >= 64% at episode 2 (last episode 3)",
        "b: first rolling 2-episode success share >= 64% at episode 2 (last episode 3)"]
    assert ct.table([a], ["a"], None, [1, 3], "episode")[2:] == [
        "| 1 | 60 | 40 | 60.0% | 3.0 |", "| 3 | 80 | 20 | 80.0% | 5.0 |"]
    with pytest.raises(SystemExit):
        ct.read_episode_rows(str(straight), 5, 7)
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "curve_table.py"),
                          str(restarted), str(straight), "--episode-rows", "4:6", "1:3",
                          "--rows", "1:3:1", "--crossings", "0.5"],
                         capture_output=True, text=True, check=True).stdout
    assert "| episode |" in out and "| 2 | 70 | 30 | 70.0% | 4.0 | 20 | 80 | 20.0% | 1.0 |" in out
