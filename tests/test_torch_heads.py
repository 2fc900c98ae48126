"""The port's action heads (algorithms/heads.py) and the non-Box PPO actor
against the JAX package's on the CPU (oracle: tests/test_heads.py).

Each head's JAX parameters, drawn once and perturbed, are carried across
with `params_from_jax`, which maps the JAX tree with no special case; the
same numpy features go through both. mode exactly, log_prob and entropy
within 1e-5; the shoot prior's bands exactly; the draws as frequencies
against the distribution's probabilities (JAX's threefry and the port's
generator differ, so not draw for draw). The `use_prior` ShootTuple policy's
get_actions log-probs, act and evaluate_actions within 1e-5, and the
committed results/shoot_1v1 policy restored and flown one deterministic step.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralplane_tpu.algorithms import heads as jheads
from neuralplane_tpu.algorithms.ppo.policy import PPOPolicy as JPolicy
from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
from neuralplane_tpu.algorithms.utils import spaces as jspaces
from neuralplane_tpu.envs import SingleCombatShootEnv as JShoot
from neuralplane_tpu.runner import F16SimRunner as JF16SimRunner
from neuralplane_tpu_torch.algorithms import heads
from neuralplane_tpu_torch.algorithms.networks import params_from_jax
from neuralplane_tpu_torch.algorithms.ppo import PPOPolicy
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.algorithms.utils import spaces
from neuralplane_tpu_torch.envs import SingleCombatShootEnv
from neuralplane_tpu_torch.runner import F16SimRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHOOT_1V1 = os.path.join(REPO, "results", "shoot_1v1", "policy_checkpoint.pkl")
TOL = dict(rtol=1e-5, atol=1e-5)
IN, N = 12, 64

SPACES = {"box": ("Box", ((3,),)), "discrete": ("Discrete", (5,)),
          "multibinary": ("MultiBinary", (4,)), "multidiscrete": ("MultiDiscrete", ((3, 4, 2),)),
          "shoot": ("ShootTuple", ((3, 5, 5, 5),))}


def space_pair(kind):
    name, args = SPACES[kind]
    return getattr(jspaces, name)(*args), getattr(spaces, name)(*args)


def perturbed(tree, seed):
    """A JAX param tree with every leaf moved off its init (log_std and
    biases start at 0, the logits near 0)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + rng.normal(0.0, 0.5, np.shape(x))
                        .astype(np.float32), tree)


def head_pair(kind, seed=0):
    jspace, space = space_pair(kind)
    jhead = jheads.build_head(jspace, 0.01)
    p = perturbed(jhead.init(jax.random.PRNGKey(seed), IN), seed)
    head = heads.build_head(space, IN, 0.01)
    head.load_state_dict(params_from_jax(p))
    return jhead, p, head


def features(seed=1, n=N):
    return np.random.default_rng(seed).normal(0.0, 1.0, (n, IN)).astype(np.float32)


def priors(n=N, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.choice(np.float32([3.0, 6.0, 10.0]), (n, 1)),
            rng.choice(np.float32([3.0, 6.0, 10.0]), (n, 1)))


@pytest.mark.parametrize("kind", list(SPACES))
def test_state_dict_maps_the_jax_tree(kind):
    """params_from_jax of the JAX head's tree is exactly the port head's
    state_dict layout: the same names and shapes."""
    jspace, space = space_pair(kind)
    p = jheads.build_head(jspace, 0.01).init(jax.random.PRNGKey(0), IN)
    sd = heads.build_head(space, IN, 0.01).state_dict()
    got = params_from_jax(jax.tree.map(np.asarray, p))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("kind,with_prior", [(k, False) for k in SPACES] + [("shoot", True)])
def test_head_mode_log_prob_entropy_match_jax(kind, with_prior):
    jhead, p, head = head_pair(kind)
    feat = features()
    kw = {}
    if with_prior:
        a0, b0 = priors()
        kw = dict(alpha0=a0, beta0=b0)
    jd = jhead.dist(jax.tree.map(jnp.asarray, p), jnp.asarray(feat),
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        d = head.dist(torch.from_numpy(feat), **{k: torch.from_numpy(v) for k, v in kw.items()})
    if kind == "box":
        np.testing.assert_allclose(d.mode().numpy(), np.asarray(jd.mode()), **TOL)
    else:
        np.testing.assert_array_equal(np.asarray(d.mode(), np.float64),
                                      np.asarray(jd.mode(), np.float64))
    actions = np.asarray(jd.sample(jax.random.PRNGKey(3)), np.float32)
    with torch.no_grad():
        lp, ent = d.log_prob(torch.from_numpy(actions)), d.entropy()
    np.testing.assert_allclose(lp.numpy(), np.asarray(jd.log_prob(jnp.asarray(actions))), **TOL)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jd.entropy()), **TOL)
    assert lp.shape == ent.shape == (N, 1)


def test_shoot_priors_bands_exactly():
    """The oracle's three bands each way, and random obs across every band
    edge: both packages' pseudo-counts equal exactly."""
    obs = np.zeros((3, 15), np.float32)
    obs[:, 11] = np.deg2rad([10.0, 30.0, 60.0])
    obs[:, 13] = [0.5, 1.0, 1.5]
    a0, b0 = heads.shoot_priors(torch.from_numpy(obs))
    np.testing.assert_array_equal(a0[:, 0].numpy(), [10.0, 6.0, 3.0])
    np.testing.assert_array_equal(b0[:, 0].numpy(), [3.0, 6.0, 10.0])
    rng = np.random.default_rng(4)
    obs = rng.uniform(0.0, 1.6, (4096, 33)).astype(np.float32)
    obs[:8, 20] = [0.8, 0.8000001, 1.2, 1.2000001, 0.7999999, 1.1999999, 0.0, 1.6]
    obs[:8, 18] = np.float32(np.deg2rad([22.5, 45.0, 22.5, 45.0, 0.0, 90.0, 44.9, 22.6]))
    for slots in ((11, 13), (18, 20)):
        got = heads.shoot_priors(torch.from_numpy(obs), *slots)
        want = jheads.shoot_priors(jnp.asarray(obs), *slots)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["discrete", "multibinary", "multidiscrete", "shoot"])
def test_sample_frequencies_follow_the_probabilities(kind):
    """20,000 draws of one row's distribution: each category's (or bit's)
    frequency within 0.015 of its probability; samples are valid actions."""
    _, _, head = head_pair(kind, seed=5)
    n = 20_000
    feat = torch.from_numpy(np.repeat(features(seed=6, n=1), n, axis=0))
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        d = head.dist(feat)
        a = d.sample(g)
    if kind == "multibinary":
        np.testing.assert_allclose(a.mean(0).numpy(), d.probs[0].numpy(), atol=0.015)
        return
    cats = d.dists if kind == "multidiscrete" else (d.control.dists if kind == "shoot" else (d,))
    for i, c in enumerate(cats):
        freq = np.bincount(a[:, i].long().numpy(), minlength=c.logits.shape[-1]) / n
        np.testing.assert_allclose(freq, c.probs[0].numpy(), atol=0.015)
    if kind == "shoot":
        assert a.dtype == torch.float32 and a.shape == (n, 5)
        assert abs(float(a[:, 4].mean()) - float(d.shoot.probs[0, 0])) < 0.015


CFG = dict(hidden_sizes=(16,), act_hidden_sizes=(8,), recurrent_hidden_size=8,
           recurrent_hidden_layers=1, use_prior=True)
SHOOT = (30, 41, 41, 41)
OBS = 18


def shoot_policies(prior_slots=(11, 13), seed=0):
    jpol = JPolicy(JRLConfig(**CFG), OBS, act_space=jspaces.ShootTuple(SHOOT),
                   prior_slots=prior_slots)
    params = perturbed(jpol.init_params(jax.random.PRNGKey(seed)), seed)
    pol = PPOPolicy(RLConfig(**CFG), OBS, act_space=spaces.ShootTuple(SHOOT),
                    prior_slots=prior_slots, device="cpu")
    pol.load_state_dict(params_from_jax(params))
    return jpol, jax.tree.map(jnp.asarray, params), pol


def shoot_obs(shape, seed):
    """Obs whose AO / R slots spread over every prior band."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(0.0, 1.0, shape).astype(np.float32)
    obs[..., 11] = rng.uniform(0.0, np.pi / 2, shape[:-1])
    obs[..., 13] = rng.uniform(0.2, 2.0, shape[:-1])
    return obs


@pytest.mark.parametrize("use_prior", [True, False])
def test_shoot_policy_matches_jax(use_prior):
    """The ShootTuple actor (trunk, act_mlp, head; the Beta prior on slots
    11 / 13 when use_prior): the log-probs and values of get_actions on the
    JAX sample, act's mode exactly, evaluate_actions over a 4-step chunk
    with episode starts within 1e-5. Without the prior the shoot bit's
    probability differs, so the prior is exercised."""
    jpol, params, pol = shoot_policies()
    if not use_prior:
        jpol.use_prior = pol.actor.use_prior = False
    obs = shoot_obs((N, OBS), 8)
    h = np.random.default_rng(9).normal(0, 0.5, (N, 1, 8)).astype(np.float32)
    masks = (np.random.default_rng(10).uniform(size=(N, 1)) > 0.2).astype(np.float32)
    t = torch.from_numpy
    values, actions, logp, h_a, h_c = jpol.get_actions(
        params, jnp.asarray(obs), jnp.asarray(h), jnp.asarray(h), jnp.asarray(masks),
        jax.random.PRNGKey(11))
    with torch.no_grad():
        dist, th_a = pol.actor.dist_step(t(obs), t(h), t(masks))
        tv = pol.get_values(t(obs), t(h), t(masks))
        tlp = dist.log_prob(t(np.asarray(actions)))
        ta, _ = pol.act(t(obs), t(h), t(masks), deterministic=True)
    ja, _ = jpol.act(params, jnp.asarray(obs), jnp.asarray(h), jnp.asarray(masks))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(logp), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(values), **TOL)
    np.testing.assert_allclose(th_a.numpy(), np.asarray(h_a), **TOL)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta.dtype == torch.float32 and ta.shape == (N, 5)

    L = 4
    obs_seq = shoot_obs((L, N, OBS), 12)
    masks_seq = (np.random.default_rng(13).uniform(size=(L, N, 1)) > 0.25).astype(np.float32)
    acts_seq = np.stack([np.asarray(jpol.get_actions(
        params, jnp.asarray(obs_seq[k]), jnp.asarray(h), jnp.asarray(h),
        jnp.asarray(masks_seq[k]), jax.random.PRNGKey(20 + k))[1]) for k in range(L)])
    want = jpol.evaluate_actions(params, jnp.asarray(obs_seq), jnp.asarray(h), jnp.asarray(h),
                                 jnp.asarray(acts_seq), jnp.asarray(masks_seq))
    with torch.no_grad():
        got = pol.evaluate_actions(t(obs_seq), t(h), t(h), t(acts_seq), t(masks_seq))
    for g, w, name in zip(got, want, ("values", "log_probs", "entropy")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)


def test_team_prior_slots_reach_the_actor():
    """The actor keys its prior on the slots it is given (the team game's
    nearest-enemy AO / R at 18 / 20): two policies with the same parameters,
    one on slots 18 / 20 and one on 11 / 13, see on the nose at 5 km and
    off the nose at 18 km in the same obs, and their shoot probabilities
    follow their own slots."""
    pols = [PPOPolicy(RLConfig(**CFG), OBS + 15, act_space=spaces.ShootTuple(SHOOT),
                      prior_slots=slots, device="cpu") for slots in ((18, 20), (11, 13))]
    pols[1].load_state_dict(pols[0].state_dict())
    obs = np.zeros((1, OBS + 15), np.float32)
    obs[0, 18], obs[0, 20] = 0.1, 0.5     # alpha0 10, beta0 3
    obs[0, 11], obs[0, 13] = 1.2, 1.8     # alpha0 3, beta0 10
    h, m = torch.zeros(1, 1, 8), torch.ones(1, 1)
    with torch.no_grad():
        p = [float(pol.actor.dist_step(torch.from_numpy(obs), h, m)[0].shoot.probs[0, 0])
             for pol in pols]
    assert p[0] > 0.6 and p[1] < 0.4, p


def test_box_policy_unchanged_by_the_heads():
    """A Box policy built from act_dim and from an explicit Box space is the
    fused Actor, drawn identically."""
    cfg = RLConfig(**{**CFG, "use_prior": False})
    p1 = PPOPolicy(cfg, 10, 4, device="cpu")
    p2 = PPOPolicy(cfg, 10, act_space=spaces.Box((4,)), device="cpu")
    assert type(p1.actor).__name__ == "Actor" and "mu.weight" in p1.actor.state_dict()
    for (k, a), (_, b) in zip(p1.state_dict().items(), p2.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_restores_the_committed_shoot_policy(tmp_path):
    """results/shoot_1v1/policy_checkpoint.pkl (an actor-only pickle: trunk,
    act_mlp, head) grafted onto the default networks with no shape
    mismatch; one deterministic step on the env's reset obs equals the JAX
    policy's action, and the log-probs of those actions agree."""
    env = SingleCombatShootEnv(2, device="cpu")
    runner = F16SimRunner(env, RLConfig(use_prior=True), run_dir=str(tmp_path / "port"),
                          model_dir=SHOOT_1V1)
    jenv = JShoot(2)
    jrun = JF16SimRunner(jenv, JRLConfig(use_prior=True), run_dir=str(tmp_path / "jax"),
                         model_dir=SHOOT_1V1)
    runner.close()
    jrun.close()
    _, jobs = jenv.reset(jax.random.PRNGKey(0))
    obs = shoot_obs((16, OBS), 14)
    obs[:4] = np.asarray(jobs)
    h = np.zeros((16, 1, 128), np.float32)
    masks = np.ones((16, 1), np.float32)
    ja, _ = jrun.policy.act(jrun.train_state.params, jnp.asarray(obs), jnp.asarray(h),
                            jnp.asarray(masks))
    with torch.no_grad():
        a, _ = runner.policy.act(torch.from_numpy(obs), torch.from_numpy(h),
                                 torch.from_numpy(masks))
        dist, _ = runner.policy.actor.dist_step(torch.from_numpy(obs), torch.from_numpy(h),
                                                torch.from_numpy(masks))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    jdist, _ = jrun.policy._dist_step(jrun.train_state.params, jnp.asarray(obs),
                                      jnp.asarray(h), jnp.asarray(masks))
    np.testing.assert_allclose(dist.log_prob(a).numpy(), np.asarray(jdist.log_prob(ja)), **TOL)
