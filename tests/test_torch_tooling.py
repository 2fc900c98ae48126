"""Serving export, profiling and the training supervisor of the PyTorch port
(neuralplane_tpu_torch.utils.export, scripts.export, utils.profiling,
scripts.supervise) against the JAX package on the CPU.

The exported actor (a `torch.export` artifact, symbolic batch) is held to
the JAX policy's deterministic act on the same parameters within 1e-5, at
several batch sizes and across two chained calls; a fresh process that
imports only torch loads and calls it. `time_fn` returns the JAX package's
keys; `trace` writes a Chrome trace. The supervisor runs the JAX package's
tests (tests/test_supervise.py, with tests/stub_trainer.py) and one leg of
the port's own train CLI.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralplane_tpu.algorithms.ppo.policy import PPOPolicy as JPolicy
from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
from neuralplane_tpu.algorithms.utils.spaces import ShootTuple as JShootTuple
from neuralplane_tpu.utils import profiling as jprof
from neuralplane_tpu.utils.checkpoint import load_pytree
from neuralplane_tpu_torch.algorithms.networks import params_from_jax
from neuralplane_tpu_torch.algorithms.ppo import PPOPolicy
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.algorithms.utils.spaces import ShootTuple
from neuralplane_tpu_torch.scripts import export as export_cli
from neuralplane_tpu_torch.scripts.supervise import _strip_arg, main as supervise, merge_legs
from neuralplane_tpu_torch.utils import profiling
from neuralplane_tpu_torch.utils.export import export_actor, load_actor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hidden_sizes=(16,), act_hidden_sizes=(8,), recurrent_hidden_size=8)


def T(a):
    return torch.from_numpy(np.array(a))


def policy_pair(shoot=False, seed=0):
    """A JAX policy with fresh parameters and the port's policy carrying them."""
    if shoot:
        jpol = JPolicy(JRLConfig(**SMALL, use_prior=True), obs_dim=18,
                       act_space=JShootTuple((30, 41, 41, 41)))
        pol = PPOPolicy(RLConfig(**SMALL, use_prior=True), 18,
                        act_space=ShootTuple((30, 41, 41, 41)), device="cpu")
    else:
        jpol = JPolicy(JRLConfig(**SMALL), obs_dim=22, act_dim=4)
        pol = PPOPolicy(RLConfig(**SMALL), 22, 4, device="cpu")
    params = jpol.init_params(jax.random.PRNGKey(seed))
    pol.actor.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params["actor"])))
    return jpol, params, pol


@pytest.mark.parametrize("shoot", [False, True])
def test_exported_actor_matches_jax(shoot):
    jpol, params, pol = policy_pair(shoot)
    blob = export_actor(pol)
    assert isinstance(blob, bytes) and len(blob) > 0
    infer = load_actor(blob)
    dim = 18 if shoot else 22
    for n in (1, 5, 64):             # one artifact, any fleet size
        obs = np.array(jax.random.normal(jax.random.PRNGKey(n), (n, dim)))
        if shoot:                    # the prior's attack angle and range slots
            obs[:, 11] = np.abs(obs[:, 11])
            obs[:, 13] = np.abs(obs[:, 13]) * 2.0
        h, _ = jpol.init_rnn_states(n)
        mask = jnp.ones((n, 1), jnp.float32)
        a_ref, h_ref = jpol.act(params, jnp.asarray(obs), h, mask, deterministic=True)
        a_exp, h_exp = infer(T(obs), T(np.asarray(h)), T(np.asarray(mask)))
        np.testing.assert_allclose(a_exp.numpy(), np.asarray(a_ref), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(h_exp.numpy(), np.asarray(h_ref), rtol=1e-5, atol=1e-5)
    # the recurrence carries: two chained calls == the policy's two chained calls
    n = 3
    obs1, obs2 = (np.asarray(jax.random.normal(jax.random.PRNGKey(k), (n, dim))) for k in (7, 8))
    h, _ = jpol.init_rnn_states(n)
    mask = jnp.ones((n, 1), jnp.float32)
    _, h1 = jpol.act(params, jnp.asarray(obs1), h, mask, deterministic=True)
    a2_ref, _ = jpol.act(params, jnp.asarray(obs2), h1, mask, deterministic=True)
    _, h1e = infer(T(obs1), T(np.asarray(h)), T(np.asarray(mask)))
    a2_exp, _ = infer(T(obs2), h1e, T(np.asarray(mask)))
    np.testing.assert_allclose(a2_exp.numpy(), np.asarray(a2_ref), rtol=1e-5, atol=1e-5)


def test_export_example_batch_must_exceed_one():
    _, _, pol = policy_pair()
    with pytest.raises(ValueError, match="example_batch"):
        export_actor(pol, example_batch=1)


FRESH = r"""
import sys, torch
m = torch.export.load(sys.argv[1]).module()
obs, h, mask = torch.load(sys.argv[2])
with torch.no_grad():
    a, h2 = m(obs, h, mask)
torch.save((a, h2), sys.argv[3])
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("neuralplane_tpu", "neuralplane_tpu_torch", "jax"))
assert not bad, bad
print(a.shape[0])
"""


def test_export_cli_and_a_torch_only_process(tmp_path):
    """The CLI exports the committed heading actor (a JAX pickle); a fresh
    process that imports only torch loads the artifact and reproduces the
    JAX policy's deterministic act."""
    ckpt = os.path.join(REPO, "results", "heading", "policy_checkpoint.pkl")
    out = str(tmp_path / "actor.pt2")
    export_cli.main(["--checkpoint", ckpt, "--obs-dim", "22", "--out", out, "--device", "cpu"])
    jpol = JPolicy(JRLConfig(), obs_dim=22, act_dim=4)
    params = jax.tree.map(jnp.asarray, load_pytree(ckpt)["train_state"].params)
    n = 33
    obs = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n, 22)))
    h, _ = jpol.init_rnn_states(n)
    mask = np.ones((n, 1), np.float32)
    a_ref, h_ref = jpol.act(params, jnp.asarray(obs), h, jnp.asarray(mask), deterministic=True)
    torch.save((T(obs), T(np.asarray(h)), T(mask)), tmp_path / "in.pt")
    r = subprocess.run([sys.executable, "-c", FRESH, out, str(tmp_path / "in.pt"),
                        str(tmp_path / "out.pt")], cwd=str(tmp_path), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == str(n), r.stdout + r.stderr
    a, h2 = torch.load(tmp_path / "out.pt")
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h_ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- profiling

def test_time_fn_keys_and_trace(tmp_path):
    x = torch.randn(64, 64)
    got = profiling.time_fn(torch.mm, x, x, iters=3)
    want = jprof.time_fn(jnp.matmul, jnp.ones((4, 4)), jnp.ones((4, 4)), iters=3)
    assert set(got) == set(want) == {"mean_s", "total_s", "iters"}
    assert got["iters"] == 3 and got["total_s"] >= got["mean_s"] > 0
    with profiling.trace(str(tmp_path / "tr")) as prof:
        for _ in range(3):
            torch.mm(x, x)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


# ---------------------------------------------------------------- supervise
# tests/test_supervise.py on the port's supervisor

def test_strip_arg():
    args = ["--a", "1", "--run-dir", "x", "--b", "--run-dir=y"]
    out, val = _strip_arg(args, "--run-dir")
    assert out == ["--a", "1", "--b"] and val == "y"
    out2, val2 = _strip_arg(out, "--missing")
    assert out2 == out and val2 is None


@pytest.mark.parametrize("legs_rows,total,steps", [
    ([[1000, 2000, 3000], [1000, 2000]], 5000, [1000, 2000, 3000, 4000, 5000]),
    ([[1000, 2000], [], [], [1000]], 3000, [1000, 2000, 3000])])
def test_merge_legs(tmp_path, legs_rows, total, steps):
    legs = []
    for k, rows in enumerate(legs_rows):
        leg = tmp_path / f"leg_{k}"
        os.makedirs(leg)
        if rows:
            with open(leg / "metrics.jsonl", "w") as f:
                for s in rows:
                    f.write(json.dumps({"step": s, "wall_s": s / 1000.0}) + "\n")
        legs.append(str(leg))
    assert merge_legs(str(tmp_path), legs) == total
    merged = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in merged] == steps


def test_supervisor_stall_resume(tmp_path):
    """Leg 0 of tests/stub_trainer.py wedges after 3000 steps; the supervisor
    kills it, resumes from its checkpoint with the remaining budget and
    merges the full 10000 steps."""
    run_dir = str(tmp_path / "run")
    rc = supervise(["--run-dir", run_dir, "--stall-timeout", "5", "--poll-interval", "0.2",
                    "--max-restarts", "3", "--train-module", "tests.stub_trainer", "--",
                    "--num-env-steps", "10000", "--extra", "marker"])
    assert rc == 0
    merged = [json.loads(l) for l in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert merged[-1]["step"] == 10000 and len(merged) == 10
    assert os.path.isdir(os.path.join(run_dir, "leg_1"))
    assert not os.path.isdir(os.path.join(run_dir, "leg_2"))


def test_supervisor_gives_up_on_config_error(tmp_path):
    run_dir = str(tmp_path / "run")
    rc = supervise(["--run-dir", run_dir, "--stall-timeout", "10", "--poll-interval", "0.2",
                    "--max-restarts", "3", "--train-module", "tests.no_such_module", "--",
                    "--num-env-steps", "10000"])
    assert rc != 0 and not os.path.isdir(os.path.join(run_dir, "leg_1"))


PT_STUB = textwrap.dedent("""
    import argparse, json, os, sys, time
    p = argparse.ArgumentParser()
    p.add_argument("--run-dir"); p.add_argument("--num-env-steps", type=float)
    p.add_argument("--model-dir", default=None)
    a, _ = p.parse_known_args()
    ck = os.path.join(a.run_dir, "checkpoints")
    os.makedirs(ck, exist_ok=True)
    for name in ("state_latest.pkl", "state_latest.pt"):
        open(os.path.join(ck, name), "w").write("x")
    with open(os.path.join(a.run_dir, "metrics.jsonl"), "w") as f:
        f.write(json.dumps({"step": 500, "wall_s": 0.1, "model_dir": a.model_dir}) + "\\n")
        f.flush()
        if a.model_dir is None:
            time.sleep(3600)
    """)


def test_supervisor_resumes_from_the_port_checkpoint(tmp_path, monkeypatch):
    """Where a leg wrote the port's state_latest.pt, the resumed leg gets it
    as --model-dir."""
    (tmp_path / "pt_stub.py").write_text(PT_STUB)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run_dir = str(tmp_path / "run")
    rc = supervise(["--run-dir", run_dir, "--stall-timeout", "3", "--poll-interval", "0.2",
                    "--max-restarts", "2", "--train-module", "pt_stub", "--",
                    "--num-env-steps", "1000"])
    assert rc == 0
    merged = [json.loads(l) for l in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert merged[-1]["model_dir"] == os.path.join(run_dir, "leg_0", "checkpoints",
                                                   "state_latest.pt")


def test_supervised_port_training_leg(tmp_path):
    """One leg of the port's own train CLI (the default --train-module) on
    the CPU: it accepts the supervisor's --run-dir and --num-env-steps,
    writes metrics with `step` and checkpoints/state_latest.pt; a second
    supervised run resumes from that file through --model-dir."""
    run_dir = str(tmp_path / "run")
    train = ["--env-name", "Control", "--scenario-name", "heading", "--n-rollout-threads", "2",
             "--buffer-size", "4", "--data-chunk-length", "2", "--ppo-epoch", "1",
             "--log-interval", "1", "--device", "cpu", "--aero-backend", "stacked"]
    rc = supervise(["--run-dir", run_dir, "--stall-timeout", "120", "--poll-interval", "0.2",
                    "--", *train, "--num-env-steps", "16"])
    assert rc == 0
    merged = [json.loads(l) for l in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [r["step"] for r in merged] == [8, 16]
    ckpt = os.path.join(run_dir, "leg_0", "checkpoints", "state_latest.pt")
    assert os.path.exists(ckpt)
    rc = supervise(["--run-dir", str(tmp_path / "resumed"), "--poll-interval", "0.2", "--",
                    *train, "--num-env-steps", "8", "--model-dir", ckpt])
    assert rc == 0
    assert os.path.exists(os.path.join(tmp_path, "resumed", "leg_0", "checkpoints",
                                       "state_latest.pt"))
