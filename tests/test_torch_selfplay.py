"""The port's self-play (algorithms/selfplay.py, runner/selfplay.py, the
Runner's checkpoint hooks) against the JAX package's on the CPU.

- Opponent sampling and ELO: the same numpy generator gives the same
  choices; ratings exactly equal.
- Team split, merge and pool slices: exactly equal.
- A tiny SelfplayRunner on SingleCombatEnv: collect, train, run.
- eval_elo on a deterministic stub env, whose rewards and episode ends do
  not depend on the actions, against the JAX runner on the same stub: the
  banded per-episode protocol, a dedicated eval env, event scoring; the
  ELO numbers agree within 1e-9 (float64 host arithmetic on float32 sums).
  Stochastic mode samples; event scoring runs on the real team env.
- The pool and the ELO across a resume, a JAX run's actor_*.pkl pool
  imported, and results/selfplay/policy_checkpoint.pkl restored.
- tools/train_legs.py over two legs of a self-play run with ELO evals.
"""
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralplane_tpu.algorithms import selfplay as jsp
from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
from neuralplane_tpu.envs import SingleCombatEnv as JaxSingle
from neuralplane_tpu.envs.types import StepOutput as JStepOutput
from neuralplane_tpu.runner import SelfplayRunner as JSelfplayRunner
from neuralplane_tpu.runner import selfplay as jrs
from neuralplane_tpu_torch.algorithms import selfplay as sp
from neuralplane_tpu_torch.algorithms.networks import params_from_jax
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.envs import MultipleCombatEnv, SingleCombatEnv
from neuralplane_tpu_torch.envs.types import StepOutput
from neuralplane_tpu_torch.runner import SelfplayRunner, pool_slices, team_merge, team_split
from neuralplane_tpu_torch.utils.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SELFPLAY = os.path.join(REPO, "results", "selfplay", "policy_checkpoint.pkl")
NET = dict(buffer_size=4, data_chunk_length=2, ppo_epoch=1, num_mini_batch=1,
           hidden_sizes=(16,), act_hidden_sizes=(8,), recurrent_hidden_size=8,
           n_choose_opponents=1, save_interval=100, log_interval=1)


@pytest.mark.parametrize("algo", ["sp", "fsp", "pfsp"])
def test_choose_opponent_same_sequence(algo):
    pool = {str(i): 1000.0 + 37.0 * ((i * 7) % 5) for i in range(6)}
    r_j, r_t = np.random.default_rng(11), np.random.default_rng(11)
    got = [sp.choose_opponent(algo, pool, r_t) for _ in range(40)]
    want = [jsp.choose_opponent(algo, pool, r_j) for _ in range(40)]
    assert got == want
    with pytest.raises(ValueError):
        sp.choose_opponent(algo, {}, r_t)
    with pytest.raises(NotImplementedError):
        sp.choose_opponent("nash", pool, r_t)


def test_elo_updates_exactly_equal():
    rng = np.random.default_rng(12)
    for _ in range(20):
        ego = float(rng.uniform(900, 1100))
        opp = rng.uniform(900, 1100, 3)
        e_r, o_r = rng.uniform(-3, 3, 3), rng.uniform(-3, 3, 3)
        band = float(rng.choice([0.5, 1.0, 100.0]))
        assert sp.elo_update(ego, opp, e_r, o_r, tie_band=band)[0] == \
            jsp.elo_update(ego, opp, e_r, o_r, tie_band=band)[0]
        np.testing.assert_array_equal(sp.elo_update(ego, opp, e_r, o_r, tie_band=band)[1],
                                      jsp.elo_update(ego, opp, e_r, o_r, tie_band=band)[1])
        s = rng.uniform(0, 1, 3)
        got, want = sp.elo_update_scored(ego, opp, s), jsp.elo_update_scored(ego, opp, s)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("m,k", [(2, 1), (4, 2), (6, 3)])
def test_team_split_merge_and_pool_slices(m, k):
    env = types.SimpleNamespace(num_envs=6, num_agents=m)
    x = np.arange(6 * m * 3, dtype=np.float32).reshape(6 * m, 3)
    ego, opp = team_split(env, torch.from_numpy(x))
    jego, jopp = jrs.team_split(env, jnp.asarray(x))
    np.testing.assert_array_equal(ego.numpy(), np.asarray(jego))
    np.testing.assert_array_equal(opp.numpy(), np.asarray(jopp))
    np.testing.assert_array_equal(team_merge(env, ego, opp).numpy(), x)
    np.testing.assert_array_equal(pool_slices(ego, k).numpy(),
                                  np.asarray(jrs.pool_slices(jego, k)))


def combat_runner(tmp_path, num_envs=2, model_dir=None, **cfg):
    env = SingleCombatEnv(num_envs, device="cpu")
    return SelfplayRunner(env, RLConfig(**{**NET, **cfg}), run_dir=str(tmp_path),
                          model_dir=model_dir)


def test_collect_train_and_run(tmp_path):
    """Collect shapes (ego rows only, chunk-start GRU states), a finite
    update that moves every parameter, and run(): one pool entry per save,
    monotone names, the opponents re-drawn from the pool."""
    runner = combat_runner(tmp_path / "a", num_env_steps=16, selfplay_algorithm="fsp")
    assert list(runner.policy_pool) == ["0"]
    carry = runner.init_carry(3)
    assert carry.ego_obs.shape == (2, 15) and carry.opp_obs.shape == (2, 15)
    carry, batch, counters = runner.collect(carry)
    assert batch.obs.shape == (5, 2, 15) and batch.actions.shape == (4, 2, 4)
    assert batch.rnn_states_actor.shape[:2] == (2, 2)
    assert torch.isfinite(batch.rewards).all() and counters["done_count"].shape == ()
    before = [p.clone() for p in runner.policy.parameters()]
    metrics = runner.train(batch)
    assert all(np.isfinite(v) for v in metrics.values())
    assert all(not torch.equal(a, b) for a, b in zip(before, runner.policy.parameters()))
    infos = runner.run()   # 16 steps / (4 x 2 ego rows) = 2 episodes
    runner.close()
    assert np.isfinite(infos["average_episode_rewards"]) and infos["latest_elo"] == 1000.0
    assert sorted(runner.policy_pool) == ["0", "1", "2"]
    saved = sorted(os.listdir(tmp_path / "a" / "checkpoints"))
    assert saved == ["actor_0.pt", "actor_1.pt", "actor_2.pt", "state_ep0.pt",
                     "state_ep1.pt", "state_latest.pt"]
    newest = load_checkpoint(str(tmp_path / "a" / "checkpoints" / "actor_2.pt"))
    for k, v in runner.policy.actor.state_dict().items():
        torch.testing.assert_close(newest[k], v)


class _StubEnv:
    """Deterministic combat-layout env for eval_elo, in both packages' step
    conventions: ego rows earn `ego_r` per step, enemy rows 0; every 3rd step
    ends the episode of every group (done on ego rows); with `wipe` the
    enemy is inactive at that step."""

    num_agents = 2
    num_observation = 6
    num_actions = 4

    def __init__(self, port, num_envs=4, ego_r=2.0, wipe=True):
        self.port, self.num_envs, self.ego_r, self.wipe = port, num_envs, ego_r, wipe
        self.n = num_envs * self.num_agents
        self.config = types.SimpleNamespace(max_steps=12)
        self.device = torch.device("cpu")
        self.actions = []

    def reset(self, seed):
        xp = torch if self.port else jnp
        return xp.zeros((), dtype=xp.int32), xp.zeros((self.n, self.num_observation))

    def step(self, state, action):
        xp = torch if self.port else jnp
        if self.port:   # the JAX runner traces its step
            self.actions.append(action.numpy().copy())
        count = state + 1
        end = (count % 3) == 0
        is_ego = (xp.arange(self.n) % self.num_agents) == 0
        done = is_ego & end
        z = xp.zeros(self.n, dtype=xp.bool if self.port else bool)
        active = xp.where(end & ~is_ego & self.wipe, 0.0, 1.0)
        reward = xp.where(is_ego, self.ego_r, 0.0)
        obs = xp.zeros((self.n, self.num_observation))
        cls = StepOutput if self.port else JStepOutput
        return count, cls(obs=obs, reward=reward, done=done, bad_done=z,
                          exceed_time_limit=z, info={}, active=active)


def stub_pair(tmp_path, eval_num_envs=None, **cfg):
    runners = []
    for port in (True, False):
        env = _StubEnv(port)
        eval_env = _StubEnv(port, eval_num_envs) if eval_num_envs else None
        cls, cfg_cls = (SelfplayRunner, RLConfig) if port else (JSelfplayRunner, JRLConfig)
        runners.append(cls(env, cfg_cls(**{**NET, "elo_tie_band": 1.0, **cfg}),
                           run_dir=str(tmp_path / ("port" if port else "jax")),
                           eval_env=eval_env))
    return runners


@pytest.mark.parametrize("mode", ["banded", "eval_env", "events"])
def test_eval_elo_protocol_matches_jax(tmp_path, mode):
    """Banded: 4 envs x 3 episodes of 3 steps, ego +6 per episode against
    0 -> a win each, +K/2 at equal ratings. eval_env: the same on a
    dedicated 8-env eval env (the episodes counted are its own). Events:
    every episode a wipe -> 12 wins."""
    port, jax_runner = stub_pair(tmp_path, eval_num_envs=8 if mode == "eval_env" else None,
                                 eval_event_scoring=mode == "events")
    got, want = port.eval_elo(num_steps=9), jax_runner.eval_elo(num_steps=9)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(float(want[k]), rel=0, abs=1e-9), k
    assert got["eval_episodes_ended"] == (24.0 if mode == "eval_env" else 12.0)
    assert got["latest_elo"] == pytest.approx(1016.0)
    assert port.policy_pool == pytest.approx(jax_runner.policy_pool)
    if mode == "eval_env":
        assert not port.env.actions and len(port.eval_env.actions) == 9


def test_eval_elo_stochastic_samples(tmp_path):
    """Every row sees the same obs and memory: deterministic play gives
    every row the same mode, eval_stochastic draws a different action per
    row."""
    det, _ = stub_pair(tmp_path / "d")
    sto, _ = stub_pair(tmp_path / "s", eval_stochastic=True)
    det.eval_elo(num_steps=2)
    sto.eval_elo(num_steps=2)
    for a in det.env.actions:
        np.testing.assert_array_equal(a, np.broadcast_to(a[0], a.shape))
    assert all(len(np.unique(a[:, 0])) == len(a) for a in sto.env.actions)


def test_event_scoring_on_the_team_env(tmp_path):
    """Event scoring runs on the real 2v2 env (short horizon, no episode
    ends: all ties, the rating unchanged); a non-team env fails loudly."""
    env = MultipleCombatEnv(num_envs=2, device="cpu")
    cfg = RLConfig(**{**NET, "eval_stochastic": True, "eval_event_scoring": True})
    runner = SelfplayRunner(env, cfg, run_dir=str(tmp_path / "t"))
    out = runner.eval_elo(num_steps=3)
    assert out["eval_wins"] == 0.0 and out["eval_losses"] == 0.0
    assert out["latest_elo"] == pytest.approx(1000.0)
    single = combat_runner(tmp_path / "s", eval_event_scoring=True)
    with pytest.raises(ValueError, match="eval_event_scoring"):
        single.eval_elo(num_steps=2)


def test_pool_and_elo_survive_a_resume(tmp_path):
    """_extra_state carries the ego's ELO and the pool's ratings; a run
    resumed from the checkpoint imports the pool with its ratings and
    numbers its next entry after it."""
    first = combat_runner(tmp_path / "a", num_env_steps=8)
    first.run()
    first.close()
    first.latest_elo = 1042.5
    first.policy_pool = {"0": 990.0, "1": 1010.0}
    ckpt = first.save("latest")
    blob = load_checkpoint(ckpt)
    assert blob["selfplay"] == {"latest_elo": 1042.5,
                                "policy_pool": {"0": 990.0, "1": 1010.0}}
    second = combat_runner(tmp_path / "b", model_dir=ckpt)
    assert second.latest_elo == 1042.5
    assert second.policy_pool == {"0": 990.0, "1": 1010.0}
    assert second._next_pool_name() == "2"
    for k, v in first.policy.state_dict().items():
        torch.testing.assert_close(second.policy.state_dict()[k], v)


def test_imports_a_jax_pool(tmp_path):
    """A JAX run (SelfplayRunner on the JAX SingleCombatEnv) saves its pool
    actor_0.pkl and state_latest.pkl with ratings; the port resumed from it
    converts the pool entry, takes the ratings, and flies the same actor."""
    jcfg = JRLConfig(**NET)
    jrun = JSelfplayRunner(JaxSingle(1), jcfg, run_dir=str(tmp_path / "jax"))
    jrun.latest_elo, jrun.policy_pool = 1033.0, {"0": 977.0}
    path = jrun.save("latest")
    runner = combat_runner(tmp_path / "port", num_envs=1, model_dir=path)
    assert runner.latest_elo == 1033.0 and runner.policy_pool == {"0": 977.0}
    assert os.path.exists(tmp_path / "port" / "checkpoints" / "actor_0.pt")
    with open(tmp_path / "jax" / "checkpoints" / "actor_0.pkl", "rb") as f:
        actor = params_from_jax(jax.tree.map(np.asarray, pickle.load(f)))
    for k, v in actor.items():
        torch.testing.assert_close(runner.opponents[0].state_dict()[k], v)
        torch.testing.assert_close(runner.policy.actor.state_dict()[k], v)


def test_restores_the_committed_selfplay_policy(tmp_path):
    """results/selfplay/policy_checkpoint.pkl (a JAX TrainState) into the
    port's default networks: the actor's deterministic actions on fixed
    observations equal the JAX actor's within 1e-5, and the fresh pool's
    first entry is that policy."""
    env = SingleCombatEnv(2, device="cpu")
    runner = SelfplayRunner(env, RLConfig(), run_dir=str(tmp_path), model_dir=SELFPLAY)
    jrun = JSelfplayRunner(JaxSingle(2), JRLConfig(), run_dir=str(tmp_path / "jax"),
                           model_dir=SELFPLAY)
    obs = np.random.default_rng(13).normal(size=(4, 15)).astype(np.float32)
    h = np.zeros((4, 1, 128), np.float32)
    masks = np.ones((4, 1), np.float32)
    with torch.no_grad():
        a, _ = runner.policy.act(torch.from_numpy(obs), torch.from_numpy(h),
                                 torch.from_numpy(masks), deterministic=True)
    ja, _ = jrun.policy.act(jrun.train_state.params, jnp.asarray(obs), jnp.asarray(h),
                            jnp.asarray(masks), deterministic=True)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-5)
    assert list(runner.policy_pool) == ["0"] and runner.latest_elo == 1000.0
    for k, v in runner.policy.actor.state_dict().items():
        torch.testing.assert_close(runner.opponents[0].state_dict()[k], v)


def test_train_legs_carries_the_pool_and_eval_lines(tmp_path):
    """tools/train_legs.py on a self-play run with ELO evals: a leg stopped
    by its budget keeps each episode's eval line with it and copies the
    pool; the next leg imports that pool (its entries numbered on after
    it) and the legs' lines concatenate into one run."""
    import json
    import subprocess
    import sys
    src = os.path.join(REPO, "neuralplane_tpu", "configs", "selfplay.yaml")
    with open(src, encoding="utf-8") as f:
        text = f.read().replace("max_steps: 2000", "max_steps: 4")
    assert "max_steps: 4" in text
    (tmp_path / "sp.yaml").write_text(text)
    flags = ["--", "--env-name", "SingleCombat", "--scenario-name", str(tmp_path / "sp.yaml"),
             "--use-selfplay", "--selfplay-algorithm", "fsp", "--elo-tie-band", "1.0",
             "--use-eval", "--eval-interval", "2", "--n-rollout-threads", "2",
             "--buffer-size", "4", "--data-chunk-length", "4", "--num-env-steps", "40",
             "--ppo-epoch", "1", "--hidden-size", "16", "--act-hidden-size", "8",
             "--recurrent-hidden-size", "8", "--log-interval", "1", "--device", "cpu",
             "--aero-backend", "stacked"]
    tool = [sys.executable, os.path.join(REPO, "tools", "train_legs.py")]
    leg0, leg1 = tmp_path / "leg_0", tmp_path / "leg_1"
    for extra in (["--out", str(leg0), "--budget-s", "0"],
                  ["--out", str(leg1), "--resume", str(leg0), "--budget-s", "600"]):
        subprocess.run(tool + extra + flags, cwd=REPO, check=True, capture_output=True,
                       timeout=600)
    legs = [json.loads((d / "leg.json").read_text()) for d in (leg0, leg1)]
    assert [leg["episodes"] for leg in legs] == [1, 4] and legs[1]["steps"] == 40
    assert sorted(os.listdir(leg0)) == ["actor_0.pt", "actor_1.pt", "leg.json",
                                        "metrics.jsonl", "phases.jsonl", "run",
                                        "state_latest.pt"]
    assert {f"actor_{k}.pt" for k in range(6)} <= set(os.listdir(leg1))
    recs = [json.loads(line) for d in (leg0, leg1)
            for line in (d / "metrics.jsonl").read_text().splitlines()]
    # the resumed leg's eval episode is its own third (global step 32)
    assert [(r["step"], "latest_elo" in r and "eval_episodes_ended" in r) for r in recs] == [
        (8, False), (16, False), (24, False), (32, False), (32, True), (40, False)]
    assert "average_episode_rewards" not in recs[4]
    state = torch.load(leg1 / "state_latest.pt", weights_only=True)
    assert sorted(state["selfplay"]["policy_pool"]) == [str(k) for k in range(6)]
