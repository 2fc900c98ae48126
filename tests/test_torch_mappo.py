"""The port's MAPPO (algorithms/mappo/*, runner/mappo.py) against the JAX
package's on the CPU (oracles: tests/test_planning_mappo.py:36,
tests/test_event_elo.py:133).

- MAPPOPolicy (Box and ShootTuple actors, a centralized critic on the
  concatenated team obs): get_actions' values and log-probs on the JAX
  sample and evaluate_actions over a chunk within 1e-5, act's mode exactly.
- MAPPOTrainer: the shared-buffer chunks (share_obs, active masks) exactly,
  and one minibatch's loss gradients from a JAX TrainState within 1e-4 of
  each leaf's largest |g|, on a batch where a third of the active masks
  are 0 (the entropy term averages over active agents only).
- MAPPOSelfplayRunner on the 2v2 guns-only and missile team envs: collect
  shapes, an agent shot down mid-episode leaves the active masks, a
  finite update, and run() for two tiny episodes with the pool and the
  shoot_* counters in its records; event-scored eval_elo on the team env.
- The committed results/mappo_2v2_shoot actor (an actor-only pickle)
  restored with no shape mismatch and flown one deterministic step against
  the JAX policy.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralplane_tpu.algorithms.mappo import MAPPOPolicy as JMAPPOPolicy
from neuralplane_tpu.algorithms.mappo import MAPPOTrainer as JMAPPOTrainer
from neuralplane_tpu.algorithms.mappo import SharedRolloutBatch as JBatch
from neuralplane_tpu.algorithms.ppo import buffer as jbuf
from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
from neuralplane_tpu.algorithms.utils import spaces as jspaces
from neuralplane_tpu.envs import MultipleCombatShootEnv as JTeamShoot
from neuralplane_tpu.runner import MAPPOSelfplayRunner as JMAPPORunner
from neuralplane_tpu_torch.algorithms.mappo import MAPPOPolicy, MAPPOTrainer, SharedRolloutBatch
from neuralplane_tpu_torch.algorithms.networks import params_from_jax
from neuralplane_tpu_torch.algorithms.ppo import train_state_from_jax
from neuralplane_tpu_torch.algorithms.ppo.buffer import compute_advantages, compute_returns
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.algorithms.utils import spaces
from neuralplane_tpu_torch.envs import MultipleCombatEnv, MultipleCombatShootEnv
from neuralplane_tpu_torch.runner import MAPPOSelfplayRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPPO_SHOOT = os.path.join(REPO, "results", "mappo_2v2_shoot", "policy_checkpoint.pkl")
TOL = dict(rtol=1e-5, atol=1e-5)
NET = dict(hidden_sizes=(16,), act_hidden_sizes=(8,), recurrent_hidden_size=8,
           recurrent_hidden_layers=1, use_prior=True, lr=1e-3, entropy_coef=0.05,
           max_grad_norm=0.5, data_chunk_length=4)
OBS, HALF = 33, 2
SHOOT = (30, 41, 41, 41)


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + rng.normal(0.0, 0.3, np.shape(x))
                        .astype(np.float32), tree)


def policy_pair(kind, seed=0, **over):
    cfg = {**NET, **over}
    jspace, space = ((jspaces.ShootTuple(SHOOT), spaces.ShootTuple(SHOOT)) if kind == "shoot"
                     else (jspaces.Box((4,)), spaces.Box((4,))))
    jpol = JMAPPOPolicy(JRLConfig(**cfg), OBS, OBS * HALF, act_space=jspace,
                        prior_slots=(18, 20))
    params = perturbed(jpol.init_params(jax.random.PRNGKey(seed)), seed)
    pol = MAPPOPolicy(RLConfig(**cfg), OBS, OBS * HALF, act_space=space, prior_slots=(18, 20),
                      device="cpu")
    pol.load_state_dict(params_from_jax(params))
    return jpol, jax.tree.map(jnp.asarray, params), pol


def team_obs(shape, seed):
    """Obs whose nearest-enemy AO / R slots (18 / 20) spread over every
    prior band, and the centralized obs of consecutive row pairs."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(0.0, 1.0, shape).astype(np.float32)
    obs[..., 18] = rng.uniform(0.0, np.pi / 2, shape[:-1])
    obs[..., 20] = rng.uniform(0.2, 2.0, shape[:-1])
    lead = shape[:-2]
    n = shape[-2]
    cent = np.repeat(obs.reshape(*lead, n // HALF, 1, HALF * OBS), HALF, axis=-2)
    return obs, cent.reshape(*lead, n, HALF * OBS)


@pytest.mark.parametrize("kind", ["box", "shoot"])
def test_mappo_policy_matches_jax(kind):
    jpol, params, pol = policy_pair(kind)
    n = 32
    obs, cent = team_obs((n, OBS), 1)
    rng = np.random.default_rng(2)
    h = rng.normal(0, 0.5, (n, 1, 8)).astype(np.float32)
    masks = (rng.uniform(size=(n, 1)) > 0.2).astype(np.float32)
    t, j = torch.from_numpy, jnp.asarray
    values, actions, logp, h_a, h_c = jpol.get_actions(params, j(cent), j(obs), j(h), j(h),
                                                       j(masks), jax.random.PRNGKey(3))
    with torch.no_grad():
        dist, th_a = pol.actor.dist_step(t(obs), t(h), t(masks))
        tv, th_c = pol.critic.step(t(cent), t(h), t(masks))
        ta, _ = pol.act(t(obs), t(h), t(masks), deterministic=True)
        got = dict(values=tv, logp=dist.log_prob(t(np.asarray(actions))), h_a=th_a, h_c=th_c,
                   bootstrap=pol.get_values(t(cent), t(h), t(masks)))
        _, sampled, slogp, _, _ = pol.get_actions(t(cent), t(obs), t(h), t(h), t(masks),
                                                  torch.Generator().manual_seed(0))
    want = dict(values=values, logp=logp, h_a=h_a, h_c=h_c,
                bootstrap=jpol.get_values(params, j(cent), j(h), j(masks)))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)
    ja, _ = jpol.act(params, j(obs), j(h), j(masks))
    if kind == "box":
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    else:
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert sampled.shape == tuple(np.shape(actions)) and slogp.shape == (n, 1)

    L = 4
    obs_seq, cent_seq = team_obs((L, n, OBS), 4)
    masks_seq = (rng.uniform(size=(L, n, 1)) > 0.25).astype(np.float32)
    acts = np.stack([np.asarray(jpol.get_actions(
        params, j(cent_seq[k]), j(obs_seq[k]), j(h), j(h), j(masks_seq[k]),
        jax.random.PRNGKey(10 + k))[1]) for k in range(L)])
    want = jpol.evaluate_actions(params, j(cent_seq), j(obs_seq), j(h), j(h), j(acts),
                                 j(masks_seq))
    with torch.no_grad():
        got = pol.evaluate_actions(t(cent_seq), t(obs_seq), t(h), t(h), t(acts), t(masks_seq))
    for g, w, name in zip(got, want, ("values", "log_probs", "entropy")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)


def shared_batch(seed, jpol, params, T=8, N=8):
    """A SharedRolloutBatch of numpy arrays: actions sampled by the JAX
    policy, a third of the active masks 0, chunk-start rnn states."""
    rng = np.random.default_rng(seed)
    f = np.float32
    obs, cent = team_obs((T + 1, N, OBS), seed)
    acts = np.stack([np.asarray(jpol.act(params, jnp.asarray(obs[k]), jnp.zeros((N, 1, 8)),
                                         jnp.ones((N, 1)), key=jax.random.PRNGKey(k),
                                         deterministic=False)[0]) for k in range(T)])
    L = NET["data_chunk_length"]
    return dict(obs=obs, share_obs=cent, actions=acts.astype(f),
                rewards=rng.normal(size=(T, N, 1)).astype(f),
                masks=(rng.uniform(size=(T + 1, N, 1)) > 0.2).astype(f),
                bad_masks=(rng.uniform(size=(T + 1, N, 1)) > 0.1).astype(f),
                active_masks=(rng.uniform(size=(T + 1, N, 1)) > 0.33).astype(f),
                action_log_probs=(rng.normal(size=(T, N, 1)) * 0.1 - 8.0).astype(f),
                value_preds=rng.normal(size=(T + 1, N, 1)).astype(f),
                rnn_states_actor=rng.normal(0, 0.5, (T // L, N, 1, 8)).astype(f),
                rnn_states_critic=rng.normal(0, 0.5, (T // L, N, 1, 8)).astype(f))


@pytest.mark.parametrize("kind", ["box", "shoot"])
def test_mappo_minibatch_gradients_match_jax(kind):
    """The shared chunks exactly; then one minibatch (half the chunks, as
    train gathers them) from a JAX TrainState: loss gradients within 1e-4
    of each leaf's largest |g|, the metrics within 1e-5."""
    jpol, params, pol = policy_pair(kind, seed=1)
    jtr = JMAPPOTrainer(JRLConfig(**NET), jpol)
    state = jtr.init_state(params)
    tr = MAPPOTrainer(pol.cfg, pol)
    train_state_from_jax(jax.tree.map(np.asarray, state), tr)
    arrays = shared_batch(5, jpol, params)
    assert 0.2 < 1 - arrays["active_masks"].mean() < 0.5
    jb = JBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tb = SharedRolloutBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    cfg = jtr.cfg
    jret = jbuf.compute_returns(jb, cfg.gamma, cfg.gae_lambda)
    jchunks = jtr._chunk_arrays(jb, jret, jbuf.compute_advantages(jret, jb.value_preds))
    ret = compute_returns(tb, cfg.gamma, cfg.gae_lambda)
    chunks = tr._chunk_arrays(tb, ret, compute_advantages(ret, tb.value_preds))
    assert len(chunks) == len(jchunks) == 11
    for i, (g, w) in enumerate(zip(chunks, jchunks)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=f"chunk array {i}")
    idx = np.sort(np.random.default_rng(6).permutation(jchunks[0].shape[0])[: 8])
    js = tuple(jnp.take(a, idx, axis=0) if i >= len(jchunks) - 2
               else jnp.swapaxes(jnp.take(a, idx, axis=0), 0, 1) for i, a in enumerate(jchunks))
    ts = tuple(torch.from_numpy(np.array(a)) for a in js)
    assert float(ts[8].mean()) < 0.9           # inactive rows in this minibatch
    jgrads, jaux = jax.grad(jtr._loss, has_aux=True)(state.params, js)
    tr.optimizer.zero_grad()
    loss, aux = tr._loss(ts)
    loss.backward()
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, p in tr.policy.named_parameters():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()), err_msg=name)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **TOL, err_msg=k)


RUNNER = dict(buffer_size=4, data_chunk_length=2, ppo_epoch=1, num_mini_batch=1,
              hidden_sizes=(16,), act_hidden_sizes=(8,), recurrent_hidden_size=8,
              n_choose_opponents=1, save_interval=100, log_interval=1, use_prior=True)


@pytest.mark.parametrize("cls", [MultipleCombatEnv, MultipleCombatShootEnv])
def test_runner_collect_train_and_run(tmp_path, cls):
    """2 envs of 2v2: collect shapes (share_obs = 2 ego obs); ego agent 1 of
    group 0 shot down before the first step leaves the active masks from
    the next row on while its group flies on; a finite update that moves
    every parameter; run() for two episodes."""
    env = cls(num_envs=2, aero_backend="stacked", device="cpu")
    runner = MAPPOSelfplayRunner(env, RLConfig(**RUNNER, num_env_steps=32),
                                 run_dir=str(tmp_path / "run"))
    carry = runner.init_carry(3)
    blood = carry.env_state.blood.clone()
    blood[1] = 0.0
    carry.env_state = carry.env_state.replace(blood=blood)
    carry, batch, counters = runner.collect(carry)
    n_ego, d = runner.n_ego, env.num_observation
    assert batch.share_obs.shape == (5, n_ego, 2 * d) and batch.active_masks.shape == (5, n_ego, 1)
    assert batch.actions.shape == (4, n_ego, env.num_actions)
    np.testing.assert_array_equal(batch.active_masks[:, 1, 0].numpy(), [1, 0, 0, 0, 0])
    assert (batch.active_masks[:, [0, 2, 3]] == 1).all()
    torch.testing.assert_close(batch.share_obs[:, 0], batch.share_obs[:, 1])
    torch.testing.assert_close(batch.share_obs[:, 0, d:], batch.obs[:, 1])
    if cls is MultipleCombatShootEnv:
        assert {"shoot_launches", "shoot_hits", "shoot_pk_sum"} <= set(counters)
    before = [p.clone() for p in runner.policy.parameters()]
    metrics = runner.train(batch)
    assert all(np.isfinite(v) for v in metrics.values())
    assert all(not torch.equal(a, b) for a, b in zip(before, runner.policy.parameters()))
    runner.run()
    runner.close()
    with open(tmp_path / "run" / "metrics.jsonl", encoding="utf-8") as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 2 and all(np.isfinite(v) for r in recs for v in r.values())
    assert ("shoot_launches" in recs[0]) == (cls is MultipleCombatShootEnv)
    assert sorted(runner.policy_pool) == ["0", "1", "2"]


def test_event_scored_eval_on_the_team_env(tmp_path):
    """As the JAX oracle: eval_elo with event scoring on the 2v2 missile env
    under the MAPPO runner, a 4-step horizon (no episode ends: all ties,
    the rating unchanged), stochastic play."""
    env = MultipleCombatShootEnv(num_envs=2, aero_backend="stacked", device="cpu")
    cfg = RLConfig(**RUNNER, eval_stochastic=True, eval_event_scoring=True)
    runner = MAPPOSelfplayRunner(env, cfg, run_dir=str(tmp_path))
    out = runner.eval_elo(num_steps=4)
    runner.close()
    assert out["eval_wins"] == 0.0 and out["eval_losses"] == 0.0
    assert out["latest_elo"] == pytest.approx(1000.0)
    assert out["eval_episodes_ended"] == 0.0


def test_restores_the_committed_mappo_shoot_actor(tmp_path):
    """results/mappo_2v2_shoot/policy_checkpoint.pkl into the MAPPO runner's
    default networks (the actor grafted, the centralized critic fresh): no
    shape mismatch; one deterministic step on fixed obs equals the JAX MAPPO
    runner's action."""
    env = MultipleCombatShootEnv(2, device="cpu")
    runner = MAPPOSelfplayRunner(env, RLConfig(use_prior=True), run_dir=str(tmp_path / "p"),
                                 model_dir=MAPPO_SHOOT)
    jrun = JMAPPORunner(JTeamShoot(2), JRLConfig(use_prior=True), run_dir=str(tmp_path / "j"),
                        model_dir=MAPPO_SHOOT)
    runner.close()
    jrun.close()
    assert runner.policy.critic_spec.obs_dim == 2 * env.num_observation == 66
    obs, _ = team_obs((16, OBS), 7)
    h = np.zeros((16, 1, 128), np.float32)
    masks = np.ones((16, 1), np.float32)
    ja, _ = jrun.policy.act(jrun.train_state.params, jnp.asarray(obs), jnp.asarray(h),
                            jnp.asarray(masks))
    with torch.no_grad():
        a, _ = runner.policy.act(torch.from_numpy(obs), torch.from_numpy(h),
                                 torch.from_numpy(masks))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    for k, v in runner.policy.actor.state_dict().items():
        torch.testing.assert_close(runner.opponents[0].state_dict()[k], v)
