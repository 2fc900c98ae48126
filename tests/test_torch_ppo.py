"""The port's PPO buffer and trainer against the JAX package's on the CPU
(neuralplane_tpu_torch/algorithms/ppo/{buffer,trainer}.py).

Inputs are `tests/test_ppo.py:_random_batch`-style rollouts made with numpy
from a seed. Returns and advantages agree at 1e-5, chunks exactly. One
minibatch update from a JAX TrainState two updates in (so that Adam's
moments are non-zero), carried by `train_state_from_jax`: gradients within
1e-4 of each leaf's largest |g|, parameters within 1e-5, except entries
whose JAX gradient is below 1e-3 of the leaf's largest, which may move by up
to 2 lr either way (Adam divides their tiny moments by each other, so a
rounding difference becomes a step of up to ~lr). A whole `train` runs with
JAX's epoch permutations substituted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralplane_tpu.algorithms.ppo import buffer as jbuf
from neuralplane_tpu.algorithms.ppo.policy import PPOPolicy as JPolicy
from neuralplane_tpu.algorithms.ppo.trainer import PPOTrainer as JTrainer
from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
from neuralplane_tpu_torch.algorithms.networks import params_from_jax
from neuralplane_tpu_torch.algorithms.ppo import buffer as tbuf
from neuralplane_tpu_torch.algorithms.ppo import PPOPolicy, PPOTrainer, train_state_from_jax
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig

TOL = dict(rtol=1e-5, atol=1e-5)
OBS, ACT = 6, 3
NET = dict(hidden_sizes=(16, 16), act_hidden_sizes=(8,), recurrent_hidden_size=8,
           lr=1e-3, entropy_coef=0.01, max_grad_norm=0.05)


def random_batch(seed, T=8, N=6, obs_dim=OBS, act_dim=ACT, layers=1, H=8, h_rows=None):
    """numpy arrays of a RolloutBatch (tests/test_ppo.py:13-26)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        obs=rng.normal(size=(T + 1, N, obs_dim)).astype(f),
        actions=(rng.normal(size=(T, N, act_dim)) * 0.1).astype(f),
        rewards=rng.normal(size=(T, N, 1)).astype(f),
        masks=(rng.uniform(size=(T + 1, N, 1)) > 0.2).astype(f),
        bad_masks=(rng.uniform(size=(T + 1, N, 1)) > 0.1).astype(f),
        action_log_probs=(rng.normal(size=(T, N, 1)) * 0.1 - 2.0).astype(f),
        value_preds=rng.normal(size=(T + 1, N, 1)).astype(f),
        rnn_states_actor=rng.normal(size=(h_rows or T, N, layers, H)).astype(f),
        rnn_states_critic=rng.normal(size=(h_rows or T, N, layers, H)).astype(f))


def both(arrays):
    return (jbuf.RolloutBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            tbuf.RolloutBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


@pytest.mark.parametrize("use_gae,proper", [(True, False), (True, True),
                                            (False, False), (False, True)])
def test_compute_returns_match_jax(use_gae, proper):
    jb, tb = both(random_batch(0))
    want = jbuf.compute_returns(jb, 0.99, 0.95, use_gae, proper)
    got = tbuf.compute_returns(tb, 0.99, 0.95, use_gae, proper)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_compute_advantages_match_jax():
    jb, tb = both(random_batch(1, T=16, N=9))
    jr = jbuf.compute_returns(jb, 0.99, 0.95)
    want = jbuf.compute_advantages(jr, jb.value_preds)
    got = tbuf.compute_advantages(torch.from_numpy(np.array(jr)), tb.value_preds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert abs(float(got.std(correction=0)) - 1.0) < 1e-4   # population std, as jnp.std


@pytest.mark.parametrize("h_rows", [None, 2], ids=["h-per-step", "h-per-chunk"])
def test_make_chunks_match_jax(h_rows):
    T, N, L = 8, 5, 4
    arrays = random_batch(2, T=T, N=N, h_rows=h_rows)
    jb, tb = both(arrays)
    rng = np.random.default_rng(3)
    ret = rng.normal(size=(T, N, 1)).astype(np.float32)
    adv = rng.normal(size=(T, N, 1)).astype(np.float32)
    want = jbuf.make_chunks(jb, jnp.asarray(ret), jnp.asarray(adv), L)
    got = tbuf.make_chunks(tb, torch.from_numpy(ret), torch.from_numpy(adv), L)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="divisible"):
        tbuf.make_chunks(tb, torch.from_numpy(ret), torch.from_numpy(adv), 3)


def jax_setup(seed=0, **over):
    cfg = JRLConfig(**{**NET, **over})
    pol = JPolicy(cfg, OBS, ACT)
    tr = JTrainer(cfg, pol)
    return cfg, pol, tr, tr.init_state(pol.init_params(jax.random.PRNGKey(seed)))


def port_trainer(jstate, **over):
    pol = PPOPolicy(RLConfig(**{**NET, **over}), OBS, ACT, device="cpu")
    tr = PPOTrainer(pol.cfg, pol)
    train_state_from_jax(jax.tree.map(np.asarray, jstate), tr)
    return tr


def minibatches(seed, cfg, T=8, N=6):
    """JAX chunks of a random batch and the minibatch samples gathered from
    them as trainer.train does, as (jax tuple, torch tuple) pairs."""
    jb, _ = both(random_batch(seed, T=T, N=N))
    ret = jbuf.compute_returns(jb, cfg.gamma, cfg.gae_lambda)
    chunks = jbuf.make_chunks(jb, ret, jbuf.compute_advantages(ret, jb.value_preds),
                              cfg.data_chunk_length)
    perm = np.random.default_rng(seed).permutation(chunks[0].shape[0])
    out = []
    for idx in np.sort(perm.reshape(2, -1), axis=1):
        js = tuple(jnp.take(a, idx, axis=0) if i >= 7
                   else jnp.swapaxes(jnp.take(a, idx, axis=0), 0, 1)
                   for i, a in enumerate(chunks))
        out.append((js, tuple(torch.from_numpy(np.array(a)) for a in js)))
    return out


def assert_params_close(got_sd, want_tree, grads_tree, lr, updates=1):
    """Parameters within 1e-5, except entries whose JAX gradient is below
    1e-3 of the leaf's largest, which may differ by up to 2 lr per update."""
    want, grads = params_from_jax(want_tree), params_from_jax(grads_tree)
    for name, w in want.items():
        g, d = grads[name].abs(), (got_sd[name] - w).abs()
        small = g < 1e-3 * g.max()
        ok = (d <= 1e-5 + 1e-5 * w.abs()) | (small & (d <= 2 * lr * updates))
        assert bool(ok.all()), (f"{name}: largest difference {float(d.max()):.3e}, "
                                f"{int((~ok).sum())} entries out of tolerance")


@pytest.mark.parametrize("clipped_value", [False, True])
def test_update_minibatch_from_jax_train_state(clipped_value):
    """Two JAX updates, then the state carried across; the third update's
    loss gradients, clipped step, metrics and Adam moments agree."""
    cfg, _, jtr, state = jax_setup(use_clipped_value_loss=clipped_value,
                                   data_chunk_length=4)
    (s0, _), (s1, _) = minibatches(4, cfg)
    state, _ = jtr._update_minibatch(state, s0)
    state, _ = jtr._update_minibatch(state, s1)
    (js, ts), _ = minibatches(5, cfg)
    tr = port_trainer(state, use_clipped_value_loss=clipped_value, data_chunk_length=4)
    assert tr.step == 2 and tr.optimizer.state_dict()["state"][0]["step"] == 2

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

    jstate, jm = jtr._update_minibatch(state, js)
    m = tr._update_minibatch(ts)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert min(float(jm["actor_grad_norm"]), float(jm["critic_grad_norm"])) > cfg.max_grad_norm
    assert_params_close(tr.policy.state_dict(), jax.tree.map(np.asarray, jstate.params),
                        jax.tree.map(np.asarray, jgrads), cfg.lr)
    adam = jstate.opt_state[0]
    mu, nu = (params_from_jax(jax.tree.map(np.asarray, t)) for t in (adam.mu, adam.nu))
    opt = tr.optimizer.state_dict()["state"]
    for i, (name, _) in enumerate(tr.policy.named_parameters()):
        np.testing.assert_allclose(opt[i]["exp_avg"].numpy(), mu[name].numpy(), rtol=1e-5,
                                   atol=1e-5 * float(mu[name].abs().max()), err_msg=name)
        np.testing.assert_allclose(opt[i]["exp_avg_sq"].numpy(), nu[name].numpy(),
                                   rtol=1e-4, atol=1e-4 * float(nu[name].abs().max()),
                                   err_msg=name)
    assert tr.step == int(jstate.step) == 3


def test_train_matches_jax_with_its_permutations():
    """A whole update (2 epochs x 2 minibatches) with the JAX permutations
    substituted for the port's draws: metrics and parameters agree."""
    over = dict(ppo_epoch=2, num_mini_batch=2, data_chunk_length=4)
    cfg, _, jtr, state = jax_setup(seed=1, **over)
    arrays = random_batch(6, T=8, N=6, h_rows=2)
    jb, tb = both(arrays)
    key = jax.random.PRNGKey(9)
    tr = port_trainer(state, **over)
    n_chunks = 6 * 8 // 4
    perms = [torch.from_numpy(np.array(jax.random.permutation(k, n_chunks)))
             for k in jax.random.split(key, cfg.ppo_epoch)]
    tr._permutation = lambda n, g: perms.pop(0)
    jstate, jm = jtr.train(state, jb, key)
    m = tr.train(tb, torch.Generator().manual_seed(0))
    assert not perms and tr.step == int(jstate.step) == 4
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    # the gradient of the first minibatch stands for which entries are tiny
    (js, _), _ = minibatches(6, cfg)
    jgrads, _ = jax.grad(jtr._loss, has_aux=True)(state.params, js)
    assert_params_close(tr.policy.state_dict(), jax.tree.map(np.asarray, jstate.params),
                        jax.tree.map(np.asarray, jgrads), cfg.lr, updates=4)


def test_train_draws_from_the_generator():
    """Without substitution the epochs' order comes from the generator
    given to train: the same seed gives the same update."""
    cfg, _, _, state = jax_setup(seed=2, ppo_epoch=2, num_mini_batch=3,
                                 data_chunk_length=4)
    results = []
    for seed in (0, 0, 1):
        tr = port_trainer(state, ppo_epoch=2, num_mini_batch=3, data_chunk_length=4)
        _, tb = both(random_batch(7, T=8, N=6, h_rows=2))
        m = tr.train(tb, torch.Generator().manual_seed(seed))
        assert all(v.dim() == 0 and torch.isfinite(v) for v in m.values())
        results.append(tr.policy.state_dict()["actor.mu.weight"])
    assert torch.equal(results[0], results[1])
    assert not torch.equal(results[0], results[2])
