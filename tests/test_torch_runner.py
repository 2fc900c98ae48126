"""The port's training loop as a whole, on the CPU
(neuralplane_tpu_torch/runner, utils/checkpoint.py, scripts/train.py).

- A JAX F16SimRunner.collect on heading (n = 8, T = 8, chunks of 4, sensor
  noise off, aero_backend="stacked" on both sides) replayed through the
  port: the JAX carry comes across by Env.state_from_jax and the parameters
  by params_from_jax, and the port's sampler returns the JAX batch's
  actions. Compared on rows that never reset (the two packages draw resets
  from different generators) at the env tolerances of
  tests/test_torch_env.py (obs 2e-5, reward 1e-4, flags exact) and 1e-5 for
  log-probabilities, values and the chunk-start GRU states.
- The port's own collect + train + save/restore + eval at a tiny size.
- The committed heading checkpoint read without JAX: its actor against the
  JAX actor on fixed observations, its Adam state carried across.
- The actor-only graft: leaf shapes checked, the first difference named.
- A JAX run directory (checkpoints/state_latest.pkl, written by the JAX
  runner's own save) restored by the port.
- The CLI on the CPU writing metrics.jsonl and checkpoints: the Control env
  on the F-16, the UAV and the C172P, and the Planning env over the
  committed control policy, trained and resumed from its run directory;
  1v1 self-play with an ELO eval, resumed with its pool; the team env's
  self-play refused without MAPPO, as in the JAX CLI.
"""
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from neuralplane_tpu.algorithms import networks as jnets
from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
from neuralplane_tpu.envs import ControlEnv as JaxControlEnv
from neuralplane_tpu.runner import F16SimRunner as JF16SimRunner
from neuralplane_tpu.utils.config import load_config as j_load_config
from neuralplane_tpu_torch.algorithms.networks import params_from_jax
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.algorithms.utils.distributions import DiagGaussian
from neuralplane_tpu_torch.envs import ControlEnv
from neuralplane_tpu_torch.runner import F16SimRunner, RolloutCarry
from neuralplane_tpu_torch.scripts import train as train_cli
from neuralplane_tpu_torch.utils.checkpoint import load_checkpoint, load_jax_pickle
from neuralplane_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADING = os.path.join(REPO, "results", "heading", "policy_checkpoint.pkl")
CONTROL = os.path.join(REPO, "results", "control", "policy_checkpoint.pkl")
NET = dict(buffer_size=8, data_chunk_length=4, hidden_sizes=(16,),
           act_hidden_sizes=(8,), recurrent_hidden_size=8, n_rollout_threads=8)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def read_jsonl(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def test_collect_replays_jax_collect(tmp_path, monkeypatch):
    n = 8
    jenv = JaxControlEnv(num_envs=n, config=j_load_config("heading", noise_scale=0.0),
                         task="heading", aero_backend="stacked")
    jrun = JF16SimRunner(jenv, JRLConfig(**NET), run_dir=str(tmp_path / "jax"))
    c0 = to_np(jrun.init_carry(jax.random.PRNGKey(0)))
    _, jb, (_, jcounters) = jrun.collect(jrun.train_state.params, c0)
    jb = to_np(jb)

    env = ControlEnv(num_envs=n, config=load_config("heading", noise_scale=0.0),
                     task="heading", aero_backend="stacked", device="cpu")
    run = F16SimRunner(env, RLConfig(**NET), run_dir=str(tmp_path / "port"))
    run.policy.load_state_dict(params_from_jax(to_np(jrun.train_state.params)))
    env.reset(0)   # seeds the env's generator
    def t(a):
        return torch.from_numpy(np.array(a))
    carry = RolloutCarry(env_state=env.state_from_jax(c0.env_state), obs=t(c0.obs),
                         h_actor=t(c0.h_actor), h_critic=t(c0.h_critic),
                         masks=t(c0.masks), bad_masks=t(c0.bad_masks))
    actions = iter(t(jb.actions))
    monkeypatch.setattr(DiagGaussian, "sample", lambda self, g: next(actions))
    _, b, (_, counters) = run.collect(carry)

    T, L = 8, 4
    assert b.obs.shape == (T + 1, n, 22) and b.rnn_states_actor.shape == (T // L, n, 1, 8)
    same = jb.masks.all(axis=(0, 2)) & jb.bad_masks.all(axis=(0, 2))
    assert same.sum() >= n - 2, "too few rows without a reset to compare"
    for name, tol in (("obs", 2e-5), ("rewards", 1e-4), ("action_log_probs", 1e-5),
                      ("value_preds", 1e-5), ("rnn_states_actor", 1e-5),
                      ("rnn_states_critic", 1e-5)):
        np.testing.assert_allclose(getattr(b, name).numpy()[:, same],
                                   getattr(jb, name)[:, same], rtol=tol, atol=tol,
                                   err_msg=name)
    for name in ("masks", "bad_masks"):
        np.testing.assert_array_equal(getattr(b, name).numpy(), getattr(jb, name))
    assert {k: int(v) for k, v in counters.items()} == \
        {k: int(v) for k, v in jcounters.items()}


def tiny_runner(tmp_path, name="a", **over):
    cfg = RLConfig(**{**NET, "n_rollout_threads": 4, "ppo_epoch": 2,
                      "num_mini_batch": 2, "num_env_steps": 8 * 4 * 2,
                      "log_interval": 1, "save_interval": 10, **over})
    env = ControlEnv(num_envs=4, config="heading", device="cpu")
    return F16SimRunner(env, cfg, run_dir=str(tmp_path / name))


def test_collect_train_save_restore_eval(tmp_path):
    run = tiny_runner(tmp_path)
    carry = run.init_carry(run.next_seed())
    carry, batch, (ends, counters) = run.collect(carry)
    T, n = 8, 4
    assert batch.obs.shape == (T + 1, n, 22) and batch.actions.shape == (T, n, 4)
    assert batch.value_preds.shape == (T + 1, n, 1)
    assert batch.rnn_states_actor.shape == (T // 4, n, 1, 8)
    assert all(torch.isfinite(x).all() for x in (batch.obs, batch.rewards,
                                                 batch.value_preds, batch.action_log_probs))
    assert torch.all((batch.masks == 0) | (batch.masks == 1))
    assert any(k.startswith("termination/") for k in counters)
    assert all(isinstance(v, torch.Tensor) for v in counters.values())

    before = {k: v.clone() for k, v in run.policy.state_dict().items()}
    metrics = run.train(batch)
    assert set(metrics) == {"policy_loss", "value_loss", "policy_entropy_loss", "ratio",
                            "actor_grad_norm", "critic_grad_norm"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert run.trainer.step == 4
    assert not torch.equal(before["actor.mu.weight"], run.policy.state_dict()["actor.mu.weight"])

    path = run.save("latest")
    assert path.endswith("state_latest.pt") and load_checkpoint(path)["step"] == 4
    run2 = tiny_runner(tmp_path, "b", seed=7)
    run2.restore(str(tmp_path / "a"))   # a run directory: its latest checkpoint
    for k, v in run.policy.state_dict().items():
        assert torch.equal(v, run2.policy.state_dict()[k]), k
    s1, s2 = (r.trainer.optimizer.state_dict()["state"] for r in (run, run2))
    assert all(torch.equal(s1[i]["exp_avg_sq"], s2[i]["exp_avg_sq"]) for i in s1)
    assert run2.trainer.step == 4 and run2.next_seed() == run.next_seed()

    out = run.eval(num_steps=12)
    assert np.isfinite(out["eval_average_episode_rewards"])
    run.close(), run2.close()


def test_run_logs_and_saves(tmp_path):
    run = tiny_runner(tmp_path)
    infos = run.run()
    run.close()
    recs = read_jsonl(tmp_path / "a" / "metrics.jsonl")
    assert [r["step"] for r in recs] == [32, 64]
    for key in ("average_episode_rewards", "fps", "episodes_reached_target",
                "episodes_failed", "termination/overload", "value_loss"):
        assert key in recs[-1] and np.isfinite(recs[-1][key])
    assert recs[-1]["value_loss"] == infos["value_loss"]
    assert sorted(os.listdir(tmp_path / "a" / "checkpoints")) == [
        "state_ep0.pt", "state_ep1.pt", "state_latest.pt"]


@pytest.fixture(scope="module")
def heading_blob():
    with open(HEADING, "rb") as f:   # the JAX package's own reader
        return pickle.load(f)


def test_heading_checkpoint_actor_matches_jax(tmp_path, heading_blob):
    """results/heading/policy_checkpoint.pkl through the port's loader and
    Runner.restore: the actor's outputs over three steps on fixed
    observations agree with the JAX actor's at 1e-5, and Adam's state and
    the update count came across."""
    ts = heading_blob["train_state"]
    env = ControlEnv(num_envs=2, config="heading", device="cpu")
    run = F16SimRunner(env, RLConfig(), run_dir=str(tmp_path), model_dir=HEADING)
    run.close()
    spec = jnets.NetSpec.from_config(JRLConfig(), 22, 4)
    rng = np.random.default_rng(0)
    obs = rng.normal(0.0, 1.0, (3, 64, 22)).astype(np.float32)
    masks = np.ones((3, 64, 1), np.float32)
    masks[1, :8] = 0.0
    jh = np.zeros((64, 1, 128), np.float32)
    h = torch.from_numpy(jh)
    for k in range(3):
        jm, jls, jh = jnets.actor_step(ts.params["actor"], spec, obs[k], jh, masks[k])
        with torch.no_grad():
            m, ls, h = run.policy.actor.step(torch.from_numpy(obs[k]), h,
                                             torch.from_numpy(masks[k]))
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ls.numpy(), np.asarray(jls), rtol=0, atol=0)
    adam = ts.opt_state[0]
    opt = run.trainer.optimizer.state_dict()["state"]
    names = [n for n, _ in run.policy.named_parameters()]
    i = names.index("actor.mu.weight")
    np.testing.assert_array_equal(opt[i]["exp_avg"].numpy(),
                                  np.asarray(adam.mu["actor"]["mu"]["w"]).T)
    assert float(opt[i]["step"]) == int(adam.count) and run.trainer.step == int(ts.step)


def test_actor_only_graft_checks_leaf_shapes(tmp_path, heading_blob):
    """An actor-only pickle is grafted onto a fresh critic and Adam; one
    whose leaf shapes differ is refused, naming the first leaf that differs
    (the JAX runner compares the tree structure only)."""
    actor = to_np(heading_blob["train_state"].params["actor"])
    good = tmp_path / "actor.pkl"
    with open(good, "wb") as f:
        pickle.dump(actor, f)
    env = ControlEnv(num_envs=2, config="heading", device="cpu")
    run = F16SimRunner(env, RLConfig(), run_dir=str(tmp_path / "a"), model_dir=str(good))
    run.close()
    assert torch.equal(run.policy.actor.mu.weight.detach(),
                       torch.from_numpy(actor["mu"]["w"].T.copy()))
    assert run.trainer.step == 0 and not run.trainer.optimizer.state_dict()["state"]

    bad_actor = jax.tree.map(lambda x: x, actor)
    bad_actor["trunk"]["gru"]["layers"][0]["w_hh"] = np.zeros((128, 3 * 96), np.float32)
    bad = tmp_path / "actor_bad.pkl"
    with open(bad, "wb") as f:
        pickle.dump(bad_actor, f)
    with pytest.raises(ValueError, match=r"trunk\.gru\.layers\.0\.w_hh: shape \(288, 128\)"):
        F16SimRunner(env, RLConfig(), run_dir=str(tmp_path / "b"), model_dir=str(bad))
    del bad_actor["log_std"]
    with open(bad, "wb") as f:
        pickle.dump(bad_actor, f)
    with pytest.raises(ValueError, match="log_std: missing"):
        F16SimRunner(env, RLConfig(), run_dir=str(tmp_path / "c"), model_dir=str(bad))


def test_restore_reads_a_jax_run_directory(tmp_path):
    """--model-dir <JAX run dir>: with no state_latest.pt there, restore reads
    the JAX runner's checkpoints/state_latest.pkl (its own save): the
    parameters, Adam's moments and the update count come across."""
    jenv = JaxControlEnv(num_envs=2, config="heading", aero_backend="stacked")
    jrun = JF16SimRunner(jenv, JRLConfig(**NET), run_dir=str(tmp_path / "jax"))
    path = jrun.save("latest")
    assert path.endswith(os.path.join("checkpoints", "state_latest.pkl"))
    env = ControlEnv(num_envs=2, config="heading", device="cpu")
    run = F16SimRunner(env, RLConfig(**NET), run_dir=str(tmp_path / "port"),
                       model_dir=str(tmp_path / "jax"))
    run.close()
    want = params_from_jax(to_np(jrun.train_state.params))
    for name, value in run.policy.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[name].numpy(), err_msg=name)
    assert run.trainer.step == int(jrun.train_state.step)


def test_jax_loader_refuses_other_globals(tmp_path):
    path = tmp_path / "evil.pkl"
    with open(path, "wb") as f:
        pickle.dump({"x": os.getcwd, "y": np.zeros(2)}, f)
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd|os.getcwd"):
        load_jax_pickle(str(path))


CLI = ["--env-name", "Control", "--scenario-name", "heading", "--n-rollout-threads", "4",
       "--buffer-size", "8", "--data-chunk-length", "4", "--num-env-steps", "64",
       "--ppo-epoch", "1", "--num-mini-batch", "2", "--hidden-size", "16",
       "--act-hidden-size", "8", "--recurrent-hidden-size", "8", "--log-interval", "1",
       "--device", "cpu"]


def test_cli_trains_on_cpu(tmp_path):
    train_cli.main(CLI + ["--run-dir", str(tmp_path / "run")])
    recs = read_jsonl(tmp_path / "run" / "metrics.jsonl")
    assert len(recs) == 2 and all(np.isfinite(r["policy_loss"]) for r in recs)
    assert (tmp_path / "run" / "checkpoints" / "state_latest.pt").exists()
    # resume from the run directory
    train_cli.main(CLI + ["--run-dir", str(tmp_path / "run2"),
                          "--model-dir", str(tmp_path / "run")])
    assert (tmp_path / "run2" / "checkpoints" / "state_latest.pt").exists()


@pytest.mark.parametrize("model,scenario", [("UAV", "tracking"),
                                            ("C172P", "heading_c172p")])
def test_cli_trains_other_airframes_on_cpu(tmp_path, model, scenario):
    args = [a for a in CLI]
    args[args.index("--scenario-name") + 1] = scenario
    train_cli.main(args + ["--model-name", model, "--run-dir", str(tmp_path / "run")])
    recs = read_jsonl(tmp_path / "run" / "metrics.jsonl")
    assert len(recs) == 2 and all(np.isfinite(r["policy_loss"]) for r in recs)
    assert all(np.isfinite(r["average_episode_rewards"]) for r in recs)


def test_cli_trains_planning_on_cpu(tmp_path):
    """--env-name Planning over the committed control policy: 4 envs, buffer
    10, 2 inner steps per high-level step (a scenario file that cuts
    low_level_steps), one episode; then resumed from the run directory."""
    scenario = tmp_path / "tracking.yaml"
    with open(os.path.join(REPO, "neuralplane_tpu", "configs", "tracking.yaml"),
              encoding="utf-8") as f:
        scenario.write_text(f.read() + "\nlow_level_steps: 2\n")
    args = ["--env-name", "Planning", "--scenario-name", str(scenario),
            "--low-level-ckpt", CONTROL, "--n-rollout-threads", "4", "--buffer-size", "10",
            "--data-chunk-length", "5", "--num-env-steps", "40", "--ppo-epoch", "1",
            "--num-mini-batch", "2", "--hidden-size", "16", "--act-hidden-size", "8",
            "--recurrent-hidden-size", "8", "--log-interval", "1", "--device", "cpu"]
    train_cli.main(args + ["--run-dir", str(tmp_path / "run")])
    recs = read_jsonl(tmp_path / "run" / "metrics.jsonl")
    assert len(recs) == 1 and recs[0]["step"] == 40
    assert np.isfinite(recs[0]["policy_loss"]) and np.isfinite(recs[0]["value_loss"])
    train_cli.main(args + ["--run-dir", str(tmp_path / "run2"),
                           "--model-dir", str(tmp_path / "run")])
    first = load_checkpoint(str(tmp_path / "run" / "checkpoints" / "state_latest.pt"))
    second = load_checkpoint(str(tmp_path / "run2" / "checkpoints" / "state_latest.pt"))
    assert second["step"] == 2 * first["step"] > 0


# the missile and MAPPO branches
MISSILE_CLI = {
    "SingleCombatShoot": ["--env-name", "SingleCombatShoot", "--scenario-name",
                          "selfplay_shoot", "--n-rollout-threads", "2"],
    "MultipleCombatShoot": ["--env-name", "MultipleCombatShoot", "--scenario-name",
                            "multiple_selfplay_shoot", "--algorithm-name", "mappo",
                            "--n-rollout-threads", "1"],
    "mappo": ["--env-name", "MultipleCombat", "--scenario-name", "multiple_selfplay",
              "--algorithm-name", "mappo", "--n-rollout-threads", "1"],
}


@pytest.mark.parametrize("branch", list(MISSILE_CLI))
def test_cli_trains_the_missile_and_mappo_branches(tmp_path, branch):
    """Self-play with the Beta launch prior through each branch, two tiny
    episodes of 8 ego agent-steps on the CPU: finite records (with the
    shoot_* counters on the missile envs), the checkpoint and the pool."""
    args = MISSILE_CLI[branch] + [
        "--use-selfplay", "--use-prior", "--selfplay-algorithm", "fsp",
        "--n-choose-opponents", "1", "--elo-tie-band", "50", "--buffer-size", "4",
        "--data-chunk-length", "2", "--num-env-steps", "16", "--ppo-epoch", "1",
        "--num-mini-batch", "1", "--hidden-size", "16", "--act-hidden-size", "8",
        "--recurrent-hidden-size", "8", "--log-interval", "1", "--aero-backend", "stacked",
        "--device", "cpu", "--run-dir", str(tmp_path / "run")]
    train_cli.main(args)
    recs = read_jsonl(tmp_path / "run" / "metrics.jsonl")
    assert [r["step"] for r in recs] == [8, 16]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    assert ("shoot_launches" in recs[0]) == branch.endswith("Shoot")
    ckpt = tmp_path / "run" / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["actor_0.pt", "actor_1.pt", "actor_2.pt",
                                        "state_ep0.pt", "state_ep1.pt", "state_latest.pt"]
    blob = load_checkpoint(str(ckpt / "state_latest.pt"))
    critic_in = blob["policy"]["critic.trunk.base.layers.0.dense.weight"].shape[1]
    obs_dim = blob["policy"]["actor.trunk.base.layers.0.dense.weight"].shape[1]
    assert critic_in == (obs_dim if branch == "SingleCombatShoot" else 2 * obs_dim)
    assert ("actor.head.shoot.weight" in blob["policy"]) == branch.endswith("Shoot")


SELFPLAY_CLI = ["--env-name", "SingleCombat", "--scenario-name", "selfplay", "--use-selfplay",
                "--selfplay-algorithm", "fsp", "--n-choose-opponents", "1",
                "--elo-tie-band", "1.0", "--n-rollout-threads", "2", "--buffer-size", "4",
                "--data-chunk-length", "2", "--num-env-steps", "16", "--ppo-epoch", "1",
                "--num-mini-batch", "1", "--hidden-size", "16", "--act-hidden-size", "8",
                "--recurrent-hidden-size", "8", "--log-interval", "1", "--device", "cpu"]


def test_cli_trains_selfplay_on_cpu(tmp_path):
    """--env-name SingleCombat --use-selfplay: two episodes of a tiny run,
    one ELO eval on a dedicated 2-env eval env at a 6-step horizon (the
    scenario file cuts max_steps), the checkpoint with the pool's ratings
    and one pool entry per save; then resumed from the checkpoint, its pool
    imported."""
    scenario = tmp_path / "selfplay.yaml"
    with open(os.path.join(REPO, "neuralplane_tpu", "configs", "selfplay.yaml"),
              encoding="utf-8") as f:
        scenario.write_text(f.read().replace("max_steps: 2000", "max_steps: 6"))
    args = list(SELFPLAY_CLI)
    args[args.index("--scenario-name") + 1] = str(scenario)
    args += ["--use-eval", "--eval-interval", "1", "--n-eval-rollout-threads", "2"]
    train_cli.main(args + ["--run-dir", str(tmp_path / "run")])
    recs = read_jsonl(tmp_path / "run" / "metrics.jsonl")
    assert [r["step"] for r in recs] == [8, 16, 16]
    assert np.isfinite(recs[1]["policy_loss"]) and recs[2]["eval_episodes_ended"] >= 2
    ckpt = tmp_path / "run" / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["actor_0.pt", "actor_1.pt", "actor_2.pt",
                                        "state_ep0.pt", "state_ep1.pt", "state_latest.pt"]
    blob = load_checkpoint(str(ckpt / "state_latest.pt"))
    # the checkpoint is saved before the episode's pool entry, as in JAX
    assert sorted(blob["selfplay"]["policy_pool"]) == ["0", "1"]
    train_cli.main(args + ["--run-dir", str(tmp_path / "run2"),
                           "--model-dir", str(ckpt / "state_latest.pt")])
    assert sorted(os.listdir(tmp_path / "run2" / "checkpoints"))[-4:] == \
        ["actor_4.pt", "state_ep0.pt", "state_ep1.pt", "state_latest.pt"]


def test_cli_team_selfplay_needs_mappo(tmp_path):
    """MultipleCombat self-play without mappo exits, as in the JAX CLI; the
    team env itself builds."""
    args = list(SELFPLAY_CLI)
    args[args.index("SingleCombat")] = "MultipleCombat"
    args[args.index("selfplay")] = "multiple_selfplay"
    with pytest.raises(SystemExit, match="requires --algorithm-name mappo"):
        train_cli.main(args + ["--run-dir", str(tmp_path / "run")])
    env = train_cli.make_env(train_cli.get_parser().parse_args(args))
    assert env.num_observation == 30 and env.n == 8
