"""The five committed combat policies that no other port test reads, restored
into the port's runners and flown one deterministic step against the JAX
package's on the CPU (the pattern of tests/test_torch_heads.py's
shoot_1v1 check and tests/test_torch_mappo.py's mappo_2v2_shoot check).

Each checkpoint goes into the runner its training script used, on its env
and config: F16SimRunner for the 1v1 evadable missile game (actor-only
pickles), MAPPOSelfplayRunner for the team games (the guns-only 2v2 run is a
whole JAX TrainState, the others actor-only). The restore must graft with no
shape mismatch; one deterministic `act` on the JAX env's reset obs, padded to
16 rows with seeded numpy obs whose prior slots spread over every band,
equals the JAX action (exactly for the discrete heads; the guns-only Box
mean within 1e-5, as tests/test_torch_selfplay.py holds the 1v1 one), and
the log-probs of those actions agree within 1e-5. The 3v3 layout, which no
other test flies, also carries one JAX state across one missile step of
`multiple_selfplay_shoot_3v3` at the combat tolerances of
tests/test_torch_shoot.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
from neuralplane_tpu.envs import MultipleCombatEnv as JTeam
from neuralplane_tpu.envs import MultipleCombatShootEnv as JTeamShoot
from neuralplane_tpu.envs import SingleCombatShootEnv as JShoot
from neuralplane_tpu.runner import F16SimRunner as JF16SimRunner
from neuralplane_tpu.runner import MAPPOSelfplayRunner as JMAPPORunner
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.envs import (MultipleCombatEnv, MultipleCombatShootEnv,
                                        SingleCombatShootEnv)
from neuralplane_tpu_torch.runner import F16SimRunner, MAPPOSelfplayRunner
from test_torch_shoot import make_pair, nose_on, run_shoot_chain, stage_missiles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
ROWS, ENVS = 16, 2

# checkpoint, JAX env and port env classes, scenario, runner pair, RLConfig
# overrides of its training script (scripts/*.sh)
CASES = {
    "shoot_evadable": ("shoot_evadable/policy_checkpoint.pkl", JShoot, SingleCombatShootEnv,
                       "selfplay_shoot_evadable", "ppo", {"use_prior": True}),
    "evadable_pfsp_ab": ("evadable_pfsp_ab/fsp_final_checkpoint.pkl", JShoot,
                         SingleCombatShootEnv, "selfplay_shoot_evadable", "ppo",
                         {"use_prior": True}),
    "mappo_2v2": ("mappo_2v2/policy_checkpoint.pkl", JTeam, MultipleCombatEnv,
                  "multiple_selfplay", "mappo", {"min_log_std": -2.3}),
    "mappo_2v2_evadable": ("mappo_2v2_evadable/policy_checkpoint.pkl", JTeamShoot,
                           MultipleCombatShootEnv, "multiple_selfplay_shoot_evadable", "mappo",
                           {"use_prior": True}),
    "mappo_3v3_shoot": ("mappo_3v3_shoot/policy_checkpoint.pkl", JTeamShoot,
                        MultipleCombatShootEnv, "multiple_selfplay_shoot_3v3", "mappo",
                        {"use_prior": True}),
}


def padded_obs(jobs, env, seed):
    """The env's reset obs in the first rows, seeded normal obs below, the
    launch prior's AO / R slots (where the env has them) spread over every
    band."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(0.0, 1.0, (ROWS, env.num_observation)).astype(np.float32)
    slots = getattr(env, "shoot_prior_slots", None)
    if slots is not None:
        obs[:, slots[0]] = rng.uniform(0.0, np.pi / 2, ROWS)
        obs[:, slots[1]] = rng.uniform(0.2, 2.0, ROWS)
    obs[:len(jobs)] = np.asarray(jobs)
    return obs


@pytest.mark.parametrize("case", list(CASES))
def test_committed_policy_restores_and_acts_as_jax(case, tmp_path):
    path, jcls, cls, config, kind, over = CASES[case]
    ckpt = os.path.join(REPO, "results", path)
    env = cls(ENVS, config, device="cpu")
    jenv = jcls(ENVS, config)
    runners = (F16SimRunner, JF16SimRunner) if kind == "ppo" else \
        (MAPPOSelfplayRunner, JMAPPORunner)
    runner = runners[0](env, RLConfig(**over), run_dir=str(tmp_path / "port"), model_dir=ckpt)
    jrun = runners[1](jenv, JRLConfig(**over), run_dir=str(tmp_path / "jax"), model_dir=ckpt)
    runner.close()
    jrun.close()
    assert env.num_observation == jenv.num_observation
    _, jobs = jenv.reset(jax.random.PRNGKey(0))
    assert len(jobs) == env.n <= ROWS
    obs = padded_obs(jobs, env, seed=len(case))
    h = np.zeros((ROWS, 1, 128), np.float32)
    masks = np.ones((ROWS, 1), np.float32)
    jargs = (jnp.asarray(obs), jnp.asarray(h), jnp.asarray(masks))
    ja, _ = jrun.policy.act(jrun.train_state.params, *jargs)
    jpol = jrun.policy._pp if kind == "mappo" else jrun.policy
    jdist, _ = jpol._dist_step(jrun.train_state.params, *jargs)
    args = (torch.from_numpy(obs), torch.from_numpy(h), torch.from_numpy(masks))
    with torch.no_grad():
        a, _ = runner.policy.act(*args)
        dist, _ = runner.policy.actor.dist_step(*args)
    if runner.policy.is_box:
        # the Box mode is the Gaussian mean, a float32 sum whose order
        # differs between XLA and PyTorch: 1e-5, as the heading and
        # selfplay checkpoints are held (tests/test_torch_{runner,selfplay}.py)
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), **TOL)
    else:
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(dist.log_prob(a).numpy(), np.asarray(jdist.log_prob(ja)), **TOL)


def test_3v3_missile_step_matches_jax(monkeypatch):
    """One JAX state of the 3v3 missile game (both sides nose-on, a missile
    of each group's ego closing on its target) carried across one step on
    "stacked": model state, obs, reward, missiles, flags and shoot/* counts
    at tests/test_torch_shoot.py's tolerances."""
    monkeypatch.setenv("NEURALPLANE_AERO_BACKEND", "stacked")
    jenv, env = make_pair("multiple_selfplay_shoot_3v3", 2)
    assert env.num_agents == 6 and env.num_observation == 9 + 7 * 2 + 7 * 3 + 3
    jstate, _ = jenv.reset(jax.random.PRNGKey(4))
    jstate = stage_missiles(env, nose_on(env, jstate, groups=(0, 1)))
    (_, out, *_), = run_shoot_chain(jenv, env, jstate, steps=1, seed=3)
    assert int(out.info["shoot/launches"]) > 0
