"""The port's hierarchical tracking run against the JAX package's (CPU).

- The first collect of the tracking run (`scripts/train_tracking.sh`) from
  one untrained actor and critic, over the committed control policy, at
  256 envs x 10 high-level steps of 50 inner steps, "distilled" (the JAX
  xdot kernel in interpret mode): the episodes failed and the targets
  reached of the port's collect within 4 sqrt(c + c') + 1 of the JAX
  package's, and the average episode reward within REWARD_TOL of it. The
  JAX package's own reward over five keys at this size (seeds 1-5 of
  `tools/heading_collect_compare.py --scenario tracking --n 256 --steps
  10`): -203.19, -184.09, -196.14, -189.90, -190.30, mean -192.73, the
  largest distance from the mean 10.46; REWARD_TOL is 2.5 times that.
- `results/tracking_torch/policy_checkpoint.pkl` (the port-trained high
  level at 6.1e7, written by `tools/train_legs.py --export-actor`),
  `results/tracking_torch_final/policy_checkpoint.pkl` (the same run
  trained on to 3e8) and a fresh port actor graft into the JAX
  F16SimRunner on PlanningEnv("tracking"): every
  leaf shape of the JAX init params, and the same deterministic actions
  and GRU states on seeded observations within 1e-5.
- `results/tracking_torch/metrics.jsonl` carries the JAX run's keys, one
  line per 1e6 steps, and `tools/curve_table.py --rows` reproduces the
  REPORT's table at the JAX run's steps.
- `tools/curve_table.py --rows` on a small metrics file: listed steps and
  ranges, a '-' where a run logged nothing, the last step added; the
  default rows unchanged.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
from neuralplane_tpu.envs import PlanningEnv as JaxPlanningEnv
from neuralplane_tpu.runner import F16SimRunner as JF16SimRunner
from neuralplane_tpu_torch.algorithms.networks import params_to_jax
from neuralplane_tpu_torch.algorithms.ppo import PPOPolicy
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.envs import PlanningEnv
from neuralplane_tpu_torch.runner import F16SimRunner
from neuralplane_tpu_torch.utils.checkpoint import save_actor_pickle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RUN = os.path.join(REPO, "results", "tracking")
PORT_RUN = os.path.join(REPO, "results", "tracking_torch")
PORT_CKPT = os.path.join(PORT_RUN, "policy_checkpoint.pkl")
FINAL_CKPT = os.path.join(REPO, "results", "tracking_torch_final", "policy_checkpoint.pkl")
ACT_TOL = 1e-5
REWARD_TOL = 2.5 * 10.46
JAX_ROWS = "1e6:6.1e7:1e7"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's small tensors: the suite runs six
    workers on the host's cores, and the port's collect with a thread per
    core spin-waits there (measured: 180 s instead of 9.5 s for this
    collect's port side beside six busy processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_first_collect_tracks_the_jax_package(tmp_path):
    tool = load_tool("heading_collect_compare")
    args = argparse.Namespace(scenario="tracking", n=256, steps=10, seed=1,
                              backend="distilled", tmp=str(tmp_path), set={},
                              low_level_ckpt=tool.CONTROL_CKPT, update=False)
    cfg_kw = tool.collect_config(args)
    assert cfg_kw["data_chunk_length"] == 10
    jrun, jout, jstats, _ = tool.run_jax(args, cfg_kw)
    pout, pstats, _ = tool.run_port(args, cfg_kw, args.jax_params)
    jrun.close()
    assert set(pout) == set(jout) == {"episodes_failed", "episodes_reached_target",
                                      "average_episode_rewards"}
    assert jout["episodes_failed"] > 30
    for k in ("episodes_failed", "episodes_reached_target"):
        assert abs(pout[k] - jout[k]) <= 4 * np.sqrt(pout[k] + jout[k]) + 1, (k, pout, jout)
    gap = abs(pout["average_episode_rewards"] - jout["average_episode_rewards"])
    assert gap <= REWARD_TOL, (pout, jout)
    # the reset's altitude and speed draws agree in distribution
    for k in ("altitude_ft", "vt"):
        se = jstats[k]["std"] * np.sqrt(2 / args.n)
        assert abs(pstats[k]["mean"] - jstats[k]["mean"]) <= 4 * se, (k, pstats[k], jstats[k])


def port_actor(source: str, tmp_path) -> torch.nn.Module:
    """A fresh port actor, or a port-trained high level read back from its
    committed pickle by the port's runner."""
    env = PlanningEnv(num_envs=2, device="cpu")
    if source == "fresh":
        return PPOPolicy(RLConfig(seed=7), env.num_observation, env.num_actions,
                         device="cpu").actor
    ckpt = {"port_run": PORT_CKPT, "final_run": FINAL_CKPT}[source]
    run = F16SimRunner(env, RLConfig(), run_dir=str(tmp_path / "port"), model_dir=ckpt)
    run.close()
    return run.policy.actor


@pytest.mark.parametrize("source", ["fresh", "port_run", "final_run"])
def test_port_actor_grafts_into_the_jax_planning_runner(tmp_path, source):
    actor = port_actor(source, tmp_path)
    path = str(tmp_path / "actor.pkl")
    save_actor_pickle(path, params_to_jax(actor))
    jenv = JaxPlanningEnv(num_envs=2, config="tracking")
    jrun = JF16SimRunner(jenv, JRLConfig(), run_dir=str(tmp_path / "jax"), model_dir=path)
    jrun.close()
    grafted = jrun.train_state.params["actor"]
    init = jrun.policy.init_params(jax.random.PRNGKey(0))["actor"]
    assert jax.tree_util.tree_structure(grafted) == jax.tree_util.tree_structure(init)
    for g, w in zip(jax.tree.leaves(grafted), jax.tree.leaves(init)):
        assert np.shape(g) == np.shape(w)

    rng = np.random.default_rng(14)
    obs = rng.normal(0.0, 1.0, (3, 64, jenv.num_observation)).astype(np.float32)
    masks = np.ones((3, 64, 1), np.float32)
    masks[1, :8] = 0.0
    jh = np.zeros((64, 1, 128), np.float32)
    h = torch.from_numpy(jh)
    for k in range(3):
        ja, jh = jrun.policy.act(jrun.train_state.params, obs[k], jh, masks[k],
                                 deterministic=True)
        with torch.no_grad():
            mean, _, h = actor.step(torch.from_numpy(obs[k]), h, torch.from_numpy(masks[k]))
        assert mean.shape == (64, 3)
        np.testing.assert_allclose(mean.numpy(), np.asarray(ja), rtol=ACT_TOL, atol=ACT_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=ACT_TOL, atol=ACT_TOL)


def read_jsonl(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def test_port_metrics_carry_the_jax_keys():
    want = set().union(*(r.keys() for r in read_jsonl(os.path.join(JAX_RUN, "metrics.jsonl"))))
    rows = read_jsonl(os.path.join(PORT_RUN, "metrics.jsonl"))
    assert rows
    for r in rows:
        assert want <= set(r), sorted(want - set(r))
        assert all(np.isfinite(float(v)) for v in r.values())
    assert [r["step"] for r in rows] == [1_000_000 * (k + 1) for k in range(len(rows))]


def test_curve_table_reproduces_the_report():
    ct = load_tool("curve_table")
    runs = [ct.read_metrics(os.path.join(d, "metrics.jsonl")) for d in (JAX_RUN, PORT_RUN)]
    lines = ct.table(runs, ["JAX", "port"], rows=ct.parse_rows([JAX_ROWS]))
    with open(os.path.join(PORT_RUN, "REPORT.md"), encoding="utf-8") as f:
        report = f.read().splitlines()
    assert len(lines) > 3
    for line in lines:
        assert line in report, line


def test_curve_table_rows_option(tmp_path):
    ct = load_tool("curve_table")
    assert ct.parse_rows(["1e6:3.1e6:1e6", "5e5", "2e6"]) == [500_000, 1_000_000,
                                                               2_000_000, 3_000_000]
    with pytest.raises(SystemExit):
        ct.parse_rows(["1:2"])
    path = tmp_path / "m.jsonl"
    recs = [{"step": s, "episodes_reached_target": r, "episodes_failed": f,
             "average_episode_rewards": w}
            for s, r, f, w in ((1_000_000, 4, 396, -300.0), (2_000_000, 1, 99, -420.5),
                               (11_000_000, 3, 97, -250.25), (12_000_000, 5, 95, -240.0))]
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    run = ct.read_metrics(str(path))
    lines = ct.table([run], ["a"], rows=ct.parse_rows(["1e6:2.1e7:1e7"]))
    assert lines[2:] == ["| 1,000,000 | 4 | 396 | 1.0% | -300.0 |",
                         "| 11,000,000 | 3 | 97 | 3.0% | -250.2 |",
                         "| 12,000,000 | 5 | 95 | 5.0% | -240.0 |"]
    assert ct.table([run, {1_000_000: recs[0]}], ["a", "b"], upto=11_000_000,
                    rows=[1_000_000, 11_000_000])[3].endswith("| - | - | - | - |")
    # without rows: the heading report's steps, the last step added
    assert [ln.split(" | ")[0] for ln in ct.table([run], ["a"])[2:]] == ["| 3,000,000",
                                                                        "| 12,000,000"]
