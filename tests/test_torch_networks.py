"""The port's actor-critic networks and action distributions against the JAX
package's on the CPU (neuralplane_tpu_torch/algorithms/networks.py,
algorithms/utils/distributions.py).

JAX parameters are drawn once per network shape (module-scope cache) and
carried into the port with `params_from_jax`; the same numpy inputs, made
from a seed, go through both. Tolerance rtol = atol = 1e-5, JAX at
`highest` matmul precision (tests/conftest.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralplane_tpu.algorithms import networks as jnets
from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
from neuralplane_tpu.algorithms.utils import distributions as jdist
from neuralplane_tpu_torch.algorithms import networks as nets
from neuralplane_tpu_torch.algorithms.ppo import PPOPolicy
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.algorithms.utils import distributions as tdist

TOL = dict(rtol=1e-5, atol=1e-5)
OBS, ACT, T, N = 10, 4, 6, 5

# (activation, feature normalization, recurrent, GRU layers, hidden sizes,
#  act hidden sizes, min_log_std)
CASES = [
    ("relu", True, True, 1, (32, 32), (16,), None),
    ("relu", True, True, 2, (32, 32), (16,), None),
    ("tanh", False, True, 1, (24,), (16, 16), None),
    ("leaky_relu", True, False, 1, (32, 32), (16,), None),
    ("elu", False, False, 1, (24,), (), None),
    ("elu", True, True, 2, (24,), (), -0.5),
    ("tanh", True, False, 1, (32,), (16,), -0.5),
    ("leaky_relu", False, True, 2, (), (16,), None),
]


def cfg_of(case, cls):
    act, fn, rec, layers, hidden, act_hidden, min_log_std = case
    return cls(hidden_sizes=hidden, act_hidden_sizes=act_hidden, activation=act,
               use_feature_normalization=fn, use_recurrent_policy=rec,
               recurrent_hidden_size=12, recurrent_hidden_layers=layers,
               min_log_std=min_log_std)


@functools.lru_cache(maxsize=None)
def jax_params(case):
    """JAX params with every LayerNorm and log_std perturbed from its init,
    so that a swapped scale/bias or a missed clamp shows."""
    spec = jnets.NetSpec.from_config(cfg_of(case, JRLConfig), OBS, ACT)
    p = {"actor": jnets.init_actor(jax.random.PRNGKey(0), spec),
         "critic": jnets.init_critic(jax.random.PRNGKey(1), spec)}
    leaves, tree = jax.tree_util.tree_flatten(p)
    rng = np.random.default_rng(5)
    leaves = [np.asarray(x) + rng.normal(0.0, 0.3, np.shape(x)).astype(np.float32)
              for x in leaves]
    return spec, jax.tree_util.tree_unflatten(tree, leaves)


def port_policy(case, params):
    pol = PPOPolicy(cfg_of(case, RLConfig), OBS, ACT, device="cpu")
    pol.load_state_dict(params_from_tree(params))
    return pol


def params_from_tree(params):
    return nets.params_from_jax(jax.tree.map(np.asarray, params))


def inputs(layers, seed=3):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(T, N, OBS)).astype(np.float32)
    h0 = rng.normal(size=(N, layers, 12)).astype(np.float32)
    masks = np.ones((T, N, 1), np.float32)
    masks[2, 1] = masks[4, 0] = masks[3, 3] = 0.0   # resets mid-chunk
    return obs, h0, masks


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c[:4])))
def test_actor_critic_match_jax(case):
    spec, p = jax_params(case)
    pol = port_policy(case, p)
    obs, h0, masks = inputs(spec.recurrent_hidden_layers)
    t = torch.from_numpy
    # one step
    jm, jls, jh = jnets.actor_step(p["actor"], spec, obs[0], h0, masks[2])
    m, ls, h = nets.actor_step(pol.actor, t(obs[0]), t(h0), t(masks[2]))
    close(m, jm), close(ls, jls), close(h, jh)
    jv, jhc = jnets.critic_step(p["critic"], spec, obs[0], h0, masks[2])
    v, hc = nets.critic_step(pol.critic, t(obs[0]), t(h0), t(masks[2]))
    close(v, jv), close(hc, jhc)
    # a chunk of T steps with resets inside
    jm, jls, jh = jnets.actor_seq(p["actor"], spec, obs, h0, masks)
    m, ls, h = nets.actor_seq(pol.actor, t(obs), t(h0), t(masks))
    close(m, jm), close(ls, jls), close(h, jh)
    jv, jhc = jnets.critic_seq(p["critic"], spec, obs, h0, masks)
    v, hc = nets.critic_seq(pol.critic, t(obs), t(h0), t(masks))
    close(v, jv), close(hc, jhc)
    assert m.shape == (T, N, ACT) and v.shape == (T, N, 1)


@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: "-".join(map(str, c[:4])))
def test_state_dict_layout_and_init(case):
    """The port's modules have exactly the JAX tree's leaves (names and
    shapes, after the transposes), and its init follows _mlp_init /
    _dense_init / _gru_init: orthogonal rows or columns with the stated
    gain, GRU uniform within 1/sqrt(H), LayerNorm ones and zeros, biases and
    log_std zero."""
    spec, p = jax_params(case)
    pol = PPOPolicy(cfg_of(case, RLConfig), OBS, ACT, device="cpu")
    sd = pol.state_dict()
    want = params_from_tree(p)
    assert list(sd) == list(want) or sorted(sd) == sorted(want)
    assert nets.first_mismatch(want, sd) is None
    gain = 5.0 / 3.0 if case[0] == "tanh" else np.sqrt(2.0)
    for name, w in sd.items():
        w = w.double()
        if name.endswith("dense.weight") or name.endswith(("mu.weight", "value.weight")):
            g = spec.gain if "mu." in name else 1.0 if "value." in name else gain
            small = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
            np.testing.assert_allclose(small.numpy(), g * g * np.eye(small.shape[0]),
                                       atol=1e-5)
        elif ".w_" in name or ".b_" in name:
            assert w.abs().max() <= 1.0 / np.sqrt(12) + 1e-7 and w.std() > 0.05
        elif name.endswith("bias") or name.endswith("log_std"):
            assert torch.all(w == 0), name
        else:   # LayerNorm scale
            assert torch.all(w == 1), name
    # the same seed gives the same parameters, by construction or by
    # init_params; another seed others
    again = PPOPolicy(cfg_of(case, RLConfig), OBS, ACT, device="cpu")
    assert all(torch.equal(sd[k], again.state_dict()[k]) for k in sd)
    again.init_params(torch.Generator().manual_seed(5))
    assert not torch.equal(sd["actor.mu.weight"], again.actor.mu.weight)
    again.init_params(torch.Generator().manual_seed(1))
    assert all(torch.equal(sd[k], again.state_dict()[k]) for k in sd)
    other = PPOPolicy(cfg_of(case, RLConfig).replace(seed=2), OBS, ACT,
                      device="cpu").state_dict()
    assert not torch.equal(sd["actor.mu.weight"], other["actor.mu.weight"])


def dist_inputs(seed=7, n=64, a=3, k=5):
    rng = np.random.default_rng(seed)
    return dict(mean=np.tanh(rng.normal(size=(n, a))).astype(np.float32),
                log_std=rng.normal(-0.5, 0.5, a).astype(np.float32),
                log_std_rows=rng.normal(-0.5, 0.5, (n, a)).astype(np.float32),
                actions=rng.normal(size=(n, a)).astype(np.float32),
                logits=rng.normal(size=(n, k)).astype(np.float32) * 2,
                idx=rng.integers(0, k, (n, 1)).astype(np.float32),
                probs=rng.uniform(0, 1, (n, a)).astype(np.float32),
                bits=(rng.uniform(0, 1, (n, a)) < 0.5).astype(np.float32))


@pytest.mark.parametrize("kind", ["gaussian", "gaussian_rows", "categorical", "bernoulli"])
def test_distributions_match_jax(kind):
    x = dist_inputs()
    t = torch.from_numpy
    if kind.startswith("gaussian"):
        ls = x["log_std_rows"] if kind == "gaussian_rows" else x["log_std"]
        jd, d = jdist.DiagGaussian(x["mean"], ls), tdist.DiagGaussian(t(x["mean"]), t(ls))
        acts = x["actions"]
    elif kind == "categorical":
        jd, d = jdist.Categorical(x["logits"]), tdist.Categorical(t(x["logits"]))
        acts = x["idx"]
        close(d.probs, jd.probs)
    else:
        jd, d = jdist.Bernoulli(x["probs"]), tdist.Bernoulli(t(x["probs"]))
        acts = x["bits"]
    close(d.log_prob(t(acts)), jd.log_prob(acts))
    close(d.entropy(), jd.entropy())
    close(d.mode().float(), jnp.asarray(jd.mode(), jnp.float32))
    # sampling: the caller's generator decides the draw
    s1 = d.sample(torch.Generator().manual_seed(1))
    s2 = d.sample(torch.Generator().manual_seed(1))
    assert torch.equal(s1, s2) and s1.shape == torch.Size(np.shape(jd.mode()))


def test_sample_statistics():
    """Draws follow their distribution (many rows, loose bounds)."""
    g = torch.Generator().manual_seed(0)
    n = 200_000
    mean, log_std = torch.full((n, 2), 0.3), torch.tensor([-1.0, 0.5])
    s = tdist.DiagGaussian(mean, log_std).sample(g)
    np.testing.assert_allclose(s.mean(0).numpy(), [0.3, 0.3], atol=0.02)
    np.testing.assert_allclose(s.std(0).numpy(), np.exp([-1.0, 0.5]), rtol=0.02)
    logits = torch.log(torch.tensor([0.1, 0.2, 0.7])).expand(n, 3)
    c = tdist.Categorical(logits).sample(g)
    np.testing.assert_allclose(np.bincount(c.numpy().ravel(), minlength=3) / n,
                               [0.1, 0.2, 0.7], atol=0.01)
    b = tdist.Bernoulli(torch.full((n, 1), 0.25)).sample(g)
    assert abs(float(b.mean()) - 0.25) < 0.01


def test_beta_shoot_probability_matches_jax():
    rng = np.random.default_rng(11)
    raw = rng.normal(0, 30, (256, 2)).astype(np.float32)
    a0 = rng.uniform(0, 5, (256, 1)).astype(np.float32)
    b0 = rng.uniform(0, 5, (256, 1)).astype(np.float32)
    t = torch.from_numpy
    close(tdist.beta_shoot_probability(t(raw), t(a0), t(b0)),
          jdist.beta_shoot_probability(raw, a0, b0))
