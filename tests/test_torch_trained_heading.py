"""The port's heading run carried back into the JAX package (CPU).

- `params_to_jax` inverts `params_from_jax` bit for bit, tree structure
  included, on the JAX run's committed actor and on the port's.
- A port actor (a fresh one, and the committed port-trained one) goes
  through `params_to_jax` and `save_actor_pickle` into the JAX
  F16SimRunner's actor-only graft (`model_dir=`): the grafted tree has the
  structure and every leaf shape of the JAX init params (the JAX graft
  checks the structure only), and deterministic actions on seeded
  observations over three steps agree with the port's within 1e-5.
- The first episode of the heading run from one untrained actor and
  critic (500 envs, 320 steps, "pallas", the JAX side in interpret mode):
  each `termination/*` count, the episodes failed and the average episode
  reward of the port's collect against the JAX package's, with the
  overload check at the step's start (the default) and at the post-step
  state (`reuse_step_xdot: false`, the JAX package before its commit
  77ade88). The packages draw from different generators, so a count c is
  held within 4 sqrt(c + c') + 1 of the other's, and the reward within
  0.5%: at this size the two packages' rewards differ by 0.03-0.2%, the
  two settings' by 0.9% (-228.19 and -226.11 in the JAX package).
- `tools/train_legs.py` at a tiny size: a leg stopped by its wall budget
  after its first checkpointed episode, a second leg resumed from it to
  the end with steps counted over both, and the last checkpoint's actor
  exported as a pickle the port reads back unchanged.
- `results/heading_torch/metrics.jsonl` carries every key of the JAX run's
  lines, with steps strictly increasing, and `tools/curve_table.py`
  reproduces the rows of `results/heading_torch/REPORT.md` from both runs'
  files.
"""
from __future__ import annotations

import importlib.util
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
from neuralplane_tpu.envs import ControlEnv as JaxControlEnv
from neuralplane_tpu.runner import F16SimRunner as JF16SimRunner
from neuralplane_tpu_torch.algorithms.networks import params_from_jax, params_to_jax
from neuralplane_tpu_torch.algorithms.ppo import PPOPolicy
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.envs import ControlEnv
from neuralplane_tpu_torch.runner import F16SimRunner
from neuralplane_tpu_torch.utils.checkpoint import load_jax_pickle, save_actor_pickle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RUN = os.path.join(REPO, "results", "heading")
PORT_RUN = os.path.join(REPO, "results", "heading_torch")
PORT_CKPT = os.path.join(PORT_RUN, "policy_checkpoint.pkl")
ACT_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's small tensors: the suite runs six
    workers on the host's cores, where a thread per core spin-waits (the
    tracking collect's port side in test_torch_trained_tracking.py: 180 s
    instead of 9.5 s beside six busy processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def curve_table():
    spec = importlib.util.spec_from_file_location(
        "curve_table", os.path.join(REPO, "tools", "curve_table.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_trees_identical(got, want, path="actor"):
    """Same containers (dict keys in the same order, list lengths), and
    every leaf a float32 array equal bit for bit."""
    assert type(got) is type(want), f"{path}: {type(got)} vs {type(want)}"
    if isinstance(want, dict):
        assert list(got) == list(want), f"{path}: keys {list(got)} vs {list(want)}"
        for k in want:
            assert_trees_identical(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), f"{path}: length {len(got)} vs {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_identical(g, w, f"{path}/{i}")
    else:
        want = np.asarray(want)
        assert got.dtype == np.float32 and got.shape == want.shape, path
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                      err_msg=path)


def jax_heading_actor():
    with open(os.path.join(JAX_RUN, "policy_checkpoint.pkl"), "rb") as f:
        return pickle.load(f)["train_state"].params["actor"]   # the JAX package's reader


@pytest.mark.parametrize("source", ["jax_run", "port_run"])
def test_params_to_jax_inverts_params_from_jax(source):
    tree = (jax_heading_actor() if source == "jax_run"
            else load_jax_pickle(PORT_CKPT))
    env = ControlEnv(num_envs=1, config="heading", device="cpu")
    policy = PPOPolicy(RLConfig(), env.num_observation, env.num_actions, device="cpu")
    policy.actor.load_state_dict(params_from_jax(tree))
    back = params_to_jax(policy.actor)
    assert_trees_identical(back, jax.tree.map(np.asarray, tree))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jax.tree.map(np.asarray, tree)))


def port_actor(source: str, tmp_path) -> torch.nn.Module:
    """A fresh port actor (the port's seeded init), or the port-trained
    actor read back from the committed pickle by the port's runner."""
    env = ControlEnv(num_envs=2, config="heading", device="cpu")
    if source == "fresh":
        policy = PPOPolicy(RLConfig(seed=7), env.num_observation, env.num_actions,
                           device="cpu")
        return policy.actor
    run = F16SimRunner(env, RLConfig(), run_dir=str(tmp_path / "port"), model_dir=PORT_CKPT)
    run.close()
    return run.policy.actor


@pytest.mark.parametrize("source", ["fresh", "port_run"])
def test_port_actor_grafts_into_the_jax_runner(tmp_path, source):
    actor = port_actor(source, tmp_path)
    path = str(tmp_path / "actor.pkl")
    save_actor_pickle(path, params_to_jax(actor))

    jenv = JaxControlEnv(num_envs=2, config="heading", aero_backend="stacked")
    jrun = JF16SimRunner(jenv, JRLConfig(), run_dir=str(tmp_path / "jax"), model_dir=path)
    jrun.close()
    grafted = jrun.train_state.params["actor"]
    init = jrun.policy.init_params(jax.random.PRNGKey(0))["actor"]
    assert jax.tree_util.tree_structure(grafted) == jax.tree_util.tree_structure(init)
    shapes = jax.tree.map(lambda a, b: (np.shape(a), np.shape(b)), grafted, init)
    for got, want in jax.tree.leaves(shapes, is_leaf=lambda x: isinstance(x, tuple)):
        assert got == want
    assert int(jrun.train_state.step) == 0

    rng = np.random.default_rng(12)
    obs = rng.normal(0.0, 1.0, (3, 64, 22)).astype(np.float32)
    masks = np.ones((3, 64, 1), np.float32)
    masks[1, :8] = 0.0
    jh = np.zeros((64, 1, 128), np.float32)
    h = torch.from_numpy(jh)
    for k in range(3):
        ja, jh = jrun.policy.act(jrun.train_state.params, obs[k], jh, masks[k],
                                 deterministic=True)
        with torch.no_grad():
            mean, _, h = actor.step(torch.from_numpy(obs[k]), h, torch.from_numpy(masks[k]))
        np.testing.assert_allclose(mean.numpy(), np.asarray(ja), rtol=ACT_TOL, atol=ACT_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=ACT_TOL, atol=ACT_TOL)


@pytest.mark.parametrize("reuse_step_xdot", [True, False])
def test_first_collect_terminations_track_the_jax_package(tmp_path, reuse_step_xdot):
    import argparse
    spec = importlib.util.spec_from_file_location(
        "heading_collect_compare", os.path.join(REPO, "tools", "heading_collect_compare.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    args = argparse.Namespace(scenario="heading", n=500, steps=320, seed=1, backend="pallas",
                              tmp=str(tmp_path), set={"reuse_step_xdot": reuse_step_xdot},
                              update=False)
    cfg_kw = dict(n_rollout_threads=args.n, buffer_size=args.steps, data_chunk_length=8, seed=1)
    jrun, jout, _, _ = tool.run_jax(args, cfg_kw)
    pout, _, _ = tool.run_port(args, cfg_kw, jax.tree.map(np.asarray, jrun.train_state.params))
    jrun.close()
    assert set(pout) == set(jout)
    assert jout["episodes_failed"] > 1000
    for k, want in jout.items():
        if k == "average_episode_rewards":
            assert abs(pout[k] - want) <= 0.005 * abs(want), (k, pout[k], want)
        else:
            assert abs(pout[k] - want) <= 4 * np.sqrt(pout[k] + want) + 1, (k, pout[k], want)


def test_train_legs_stop_resume_and_export(tmp_path):
    import subprocess
    import sys
    flags = ["--", "--env-name", "Control", "--scenario-name", "heading",
             "--n-rollout-threads", "2", "--buffer-size", "8", "--data-chunk-length", "4",
             "--num-env-steps", "48", "--ppo-epoch", "1", "--hidden-size", "16",
             "--act-hidden-size", "8", "--recurrent-hidden-size", "8",
             "--log-interval", "1", "--device", "cpu"]
    tool = [sys.executable, os.path.join(REPO, "tools", "train_legs.py")]
    leg0, leg1 = tmp_path / "leg_0", tmp_path / "leg_1"
    for extra in (["--out", str(leg0), "--budget-s", "0"],
                  ["--out", str(leg1), "--resume", str(leg0), "--budget-s", "600"],
                  ["--export-actor", str(leg1 / "state_latest.pt"),
                   "--to", str(tmp_path / "actor.pkl")]):
        subprocess.run(tool + extra + flags, cwd=REPO, check=True, capture_output=True,
                       timeout=600)
    legs = [json.loads((d / "leg.json").read_text()) for d in (leg0, leg1)]
    assert legs[0]["episodes"] == 1 and legs[0]["stopped"].startswith("wall budget")
    assert legs[1]["episodes"] == 2 and legs[1]["steps"] == 48
    steps = [r["step"] for d in (leg0, leg1) for r in read_jsonl(d / "metrics.jsonl")]
    assert steps == [16, 32, 48]
    assert sorted(os.listdir(leg1 / "run" / "checkpoints")) == ["state_latest.pt"]
    state = torch.load(leg1 / "state_latest.pt", weights_only=True)
    actor = {k[len("actor."):]: v for k, v in state["policy"].items() if k.startswith("actor.")}
    back = params_from_jax(load_jax_pickle(str(tmp_path / "actor.pkl")))
    assert back.keys() == actor.keys()
    for k, v in actor.items():
        assert torch.equal(back[k], v), k


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
    steps = [r["step"] for r in rows]
    assert all(b > a for a, b in zip(steps, steps[1:]))
    assert steps[0] == 3_000_000


def test_curve_table_reproduces_the_report():
    ct = curve_table()
    runs = [ct.read_metrics(os.path.join(d, "metrics.jsonl")) for d in (JAX_RUN, PORT_RUN)]
    lines = ct.table(runs, ["JAX", "port"])
    with open(os.path.join(PORT_RUN, "REPORT.md"), encoding="utf-8") as f:
        report = f.read().splitlines()
    assert len(lines) > 3
    for line in lines + ct.crossing_lines(runs, ["JAX", "port"], [0.05, 0.4, 0.9, 0.99]):
        assert line in report, line


def test_curve_table_rows_and_crossings(tmp_path):
    """The table's rows on a small synthetic file: the heading report's
    steps, a '-' where a run logged nothing, the last step added, and the
    first crossings."""
    ct = curve_table()
    path = tmp_path / "m.jsonl"
    recs = [{"step": s, "episodes_reached_target": r, "episodes_failed": f,
             "average_episode_rewards": w}
            for s, r, f, w in ((3_000_000, 0, 10, -5.0), (63_000_000, 1, 3, -1.25),
                               (123_000_000, 99, 1, 2.0), (126_000_000, 5, 0, 3.0))]
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    run = ct.read_metrics(str(path))
    lines = ct.table([run], ["a"])
    assert lines[2:] == ["| 3,000,000 | 0 | 10 | 0.0% | -5.0 |",
                         "| 63,000,000 | 1 | 3 | 25.0% | -1.2 |",
                         "| 123,000,000 | 99 | 1 | 99.0% | 2.0 |",
                         "| 126,000,000 | 5 | 0 | 100.0% | 3.0 |"]
    assert ct.table([run, {3_000_000: recs[0]}], ["a", "b"], upto=63_000_000)[3].endswith(
        "| - | - | - | - |")
    assert ct.first_crossing(run, 0.2) == 63_000_000
    assert ct.first_crossing(run, 0.995) == 126_000_000
    assert ct.first_crossing(run, 1.5) is None
