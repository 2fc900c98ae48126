"""Distillation of the aero surrogate in the PyTorch port
(neuralplane_tpu_torch.surrogates.distill and its CLI) against the JAX
package's surrogates/distill.py on the CPU.

The port draws its batches from torch.Generators, the JAX package from
threefry keys, so every comparison passes the same inputs (made from a seed
with numpy, or drawn by JAX and carried across) to both sides. Tolerances:
the oracle and the build-up totals within 1e-5 of each column's RMS, the
loss within 1e-5 relative, its gradients within 1e-4 of each leaf's largest,
five Adam + EMA steps within 1e-4 of each leaf's RMS, the schedule within
1e-6 relative, evaluate's and xdot_fidelity's R^2 per row within 1e-5.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralplane_tpu.ops.aero import load_aero_weights as jax_load_aero
from neuralplane_tpu.ops.aero_pallas import load_distilled_t
from neuralplane_tpu.surrogates import distill as jd
from neuralplane_tpu_torch.ops import aero as taero
from neuralplane_tpu_torch.scripts import distill_aero as cli
from neuralplane_tpu_torch.surrogates import distill as td

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "neuralplane_tpu", "data", "f16_aero_distilled.npz")
HIDDEN = 16


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def w43():
    return jax_load_aero(), taero.load_aero_weights(device="cpu")


def batch(seed, n):
    """Degrees from the core and extended boxes, and build-up multipliers."""
    rng = np.random.default_rng(seed)
    core = rng.uniform(td.CORE_LO, td.CORE_HI, (n, 3))
    ext = rng.uniform(td.EXT_LO, td.EXT_HI, (n, 3))
    x = np.where(rng.uniform(size=(n, 1)) < 0.8, core, ext).astype(np.float32)
    vt = rng.uniform(300.0, 1500.0, (n, 1))
    mults = np.concatenate([rng.uniform(-2, 2, (n, 3)), 1.0 / (2.0 * vt),
                            rng.uniform(-1, 1, (n, 2))], axis=1).astype(np.float32)
    return x, mults


def close_rms(got, want, rel, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = np.sqrt((want ** 2).mean(axis=0))
    err = np.abs(got - want)
    np.testing.assert_array_less(err, np.broadcast_to(rel * rms + 1e-30, err.shape),
                                 err_msg=msg)


def jax_params(seed, hidden=HIDDEN):
    return jd.init_params(jax.random.PRNGKey(seed), hidden)


def to_port(p):
    return td.DistilledParams(*(T(np.array(v, np.float32)) for v in p))


def jax_stats(jw, x, mults):
    """The output scaling of jd.fit on the given core sample."""
    ys = jd.oracle_coeffs(jw, jnp.asarray(x))
    mean, std = jnp.mean(ys, axis=0), jnp.std(ys, axis=0) + 1e-6
    tot = jd._buildup_totals(ys, jnp.asarray(x[:, 1]), jnp.asarray(mults))
    return mean, std, jnp.std(tot, axis=0) + 1e-6


def jax_loss(p, jw, x, mults, mean, std, tot_std):
    """jd.fit's loss_fn on the given batch."""
    lw = jnp.asarray(jd.coeff_loss_weights())
    y_raw = jd.oracle_coeffs(jw, x)
    y = (y_raw - mean) / std
    y_tot = jd._buildup_totals(y_raw, x[:, 1], mults)
    z = jd.forward(p, x)
    err = z - y
    p_tot = jd._buildup_totals(z * std + mean, x[:, 1], mults)
    tot_err = (p_tot - y_tot) / tot_std
    return jnp.mean(err * err * lw) + 4.0 * jnp.mean(tot_err * tot_err)


@pytest.mark.parametrize("seed", [0, 1])
def test_oracle_and_buildup_totals(w43, seed):
    jw, tw = w43
    x, mults = batch(seed, 512)
    yj = np.asarray(jd.oracle_coeffs(jw, jnp.asarray(x)))
    yt = td.oracle_coeffs(tw, T(x)).numpy()
    close_rms(yt, yj, 1e-5, "oracle_coeffs")
    tj = jd._buildup_totals(jnp.asarray(yj), jnp.asarray(x[:, 1]), jnp.asarray(mults))
    tt = td._buildup_totals(T(yj), T(x[:, 1]), T(mults))
    close_rms(tt.numpy(), np.asarray(tj), 1e-5, "_buildup_totals")


def test_loss_weights_schedule_and_envelope():
    np.testing.assert_array_equal(td.coeff_loss_weights(), jd.coeff_loss_weights())
    for a in ("CORE_LO", "CORE_HI", "EXT_LO", "EXT_HI", "OUT_PAD", "N_FEAT"):
        np.testing.assert_array_equal(getattr(td, a), getattr(jd, a))
    for steps in (5, 2000):
        sched = optax.cosine_decay_schedule(3e-3, steps, alpha=1e-2)
        for count in (0, 1, 2, steps // 2, steps - 1, steps, steps + 3):
            np.testing.assert_allclose(td.cosine_lr(3e-3, steps, count),
                                       float(sched(count)), rtol=1e-6)


def test_samplers_cover_their_boxes():
    g = torch.Generator().manual_seed(0)
    x = td.sample_inputs(20000, g)
    lo, hi = x.min(0).values.numpy(), x.max(0).values.numpy()
    assert (lo >= td.EXT_LO).all() and (hi <= td.EXT_HI).all()
    inside = ((x >= T(td.CORE_LO)) & (x <= T(td.CORE_HI))).all(1).float().mean().item()
    assert 0.8 < inside < 0.9   # 80% core plus the share of the box inside it
    core = td.sample_inputs(5000, g, core_frac=1.0)
    assert ((core >= T(td.CORE_LO)) & (core <= T(td.CORE_HI))).all()
    m = td.sample_buildup_mults(5000, g).numpy()
    assert np.abs(m[:, :3]).max() <= 2.0 and np.abs(m[:, 4:]).max() <= 1.0
    assert (m[:, 3] >= 1 / 3000 - 1e-9).all() and (m[:, 3] <= 1 / 600 + 1e-9).all()


def test_init_params_shapes_and_scale():
    p = td.init_params(32, torch.Generator().manual_seed(0))
    q = jax_params(0, 32)
    for a, b in zip(p, q):
        assert tuple(a.shape) == tuple(b.shape)
    # He normal: std sqrt(2 / fan)
    np.testing.assert_allclose(p.W2.std().item(), np.sqrt(2 / 32), rtol=0.1)
    assert not p.b1.any() and not p.b3.any()


def test_forward_and_output_stats(w43):
    jw, tw = w43
    p = jax_params(3)
    x, mults = batch(4, 2048)
    zj = np.asarray(jd.forward(p, jnp.asarray(x)))
    zt = td.forward(to_port(p), T(x)).numpy()
    close_rms(zt, zj, 1e-5, "forward")
    xc = np.clip(x, td.CORE_LO, td.CORE_HI)
    for got, want in zip(td.output_stats(tw, T(xc), T(mults)), jax_stats(jw, xc, mults)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def make_distiller(tw, jw, seed, steps, stats_seed=5):
    xc, mc = batch(stats_seed, 4096)
    xc = np.clip(xc, td.CORE_LO, td.CORE_HI)
    stats = jax_stats(jw, xc, mc)
    d = td.Distiller(tw, hidden=HIDDEN, steps=steps, batch=256, lr=3e-3, seed=seed,
                     stats=[np.asarray(s) for s in stats])
    p = jax_params(seed)
    with torch.no_grad():
        for dst, src in zip(d.params, p):
            dst.copy_(T(np.array(src, np.float32)))
    return d, p, stats


def test_loss_and_gradients(w43):
    jw, tw = w43
    d, p, (mean, std, tot_std) = make_distiller(tw, jw, 1, steps=10)
    x, mults = batch(6, 1024)
    loss_j, grads_j = jax.value_and_grad(jax_loss)(p, jw, jnp.asarray(x), jnp.asarray(mults),
                                                   mean, std, tot_std)
    loss_t = d.loss(T(x), T(mults))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    for name, gt, gj in zip(td.DistilledParams._fields, d.params, grads_j):
        gj = np.asarray(gj)
        np.testing.assert_array_less(np.abs(gt.grad.numpy() - gj),
                                     1e-4 * np.abs(gj).max() + 1e-30, err_msg=name)


def test_five_adam_ema_steps(w43):
    """jd.fit's step (adam on the cosine schedule, then the EMA) five times
    on fixed batches against Distiller.step on the same batches, and the
    bias-corrected average of both."""
    jw, tw = w43
    steps, decay = 5, 0.999
    d, p, (mean, std, tot_std) = make_distiller(tw, jw, 2, steps=steps)
    opt = optax.adam(optax.cosine_decay_schedule(3e-3, steps, alpha=1e-2))
    opt_state = opt.init(p)
    ema = jax.tree.map(jnp.zeros_like, p)
    grad = jax.jit(jax.value_and_grad(jax_loss))
    for i in range(steps):
        x, mults = batch(10 + i, 512)
        loss_j, g = grad(p, jw, jnp.asarray(x), jnp.asarray(mults), mean, std, tot_std)
        updates, opt_state = opt.update(g, opt_state)
        p = optax.apply_updates(p, updates)
        ema = jax.tree.map(lambda e, q: decay * e + (1.0 - decay) * q, ema, p)
        loss_t = d.step(T(x), T(mults))
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    for name, got, want in zip(td.DistilledParams._fields, d.params, p):
        close_rms(got.detach().numpy().reshape(-1), np.asarray(want).reshape(-1), 1e-4, name)
    out, m, s = d.result()
    corr = 1.0 - decay ** steps
    for name, got, e in zip(td.DistilledParams._fields, out, ema):
        close_rms(got.numpy().reshape(-1), np.asarray(e / corr).reshape(-1), 1e-4, name)
    np.testing.assert_allclose(m, np.asarray(mean), rtol=1e-6)
    np.testing.assert_allclose(s, np.asarray(std), rtol=1e-6)


@pytest.fixture(scope="module")
def shipped():
    with np.load(SHIPPED) as z:
        K = jd.K
        p = jd.DistilledParams(W1=z["W1"], b1=z["b1"], W2=z["W2"], b2=z["b2"],
                               W3=z["W3"][:K], b3=z["b3"][:K])
        return p, z["out_mean"][:K], z["out_std"][:K]


@pytest.mark.parametrize("quantized", [True, False])
def test_evaluate_on_the_shipped_npz(w43, shipped, quantized):
    jw, tw = w43
    p, mean, std = shipped
    n = 8192
    x = np.asarray(jd.sample_inputs(jax.random.PRNGKey(123), n, core_frac=1.0))
    rj = jd.evaluate(jw, jax.tree.map(jnp.asarray, p), mean, std, n=n, quantized=quantized)
    rt = td.evaluate(tw, p, mean, std, x=T(x), quantized=quantized)
    np.testing.assert_allclose(rt["r2"], rj["r2"], rtol=0, atol=1e-5)
    assert rt["worst"] == rj["worst"] or abs(rt["r2_min"] - rj["r2_min"]) < 1e-5
    close_rms(rt["mae"], rj["mae"], 1e-3)


def jax_fidelity_states(n, seed=7):
    """The states of jd.xdot_fidelity (:316-328)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 8)
    s = jnp.zeros((n, 12))
    for i, (col, lo, hi) in enumerate(((2, 3000., 30000.), (3, -1., 1.), (4, -0.5, 0.5),
                                       (5, -3., 3.), (6, 300., 1500.), (7, -0.3, 0.7),
                                       (8, -0.4, 0.4))):
        s = s.at[:, col].set(jax.random.uniform(ks[i], (n,), minval=lo, maxval=hi))
    s = s.at[:, 9:12].set(jax.random.uniform(ks[7], (n, 3), minval=-1., maxval=1.))
    u = jnp.zeros((n, 5)).at[:, 0].set(5000.).at[:, 1].set(2.0).at[:, 2].set(-1.0) \
        .at[:, 3].set(0.5)
    return np.asarray(s), np.asarray(u)


def test_xdot_fidelity_on_the_shipped_npz(w43, shipped):
    """The acceptance gate: per-row R^2 of the port within 1e-5 of JAX's on
    the same states; the shipped net passes the 0.999 gate in both."""
    jw, tw = w43
    p, mean, std = shipped
    s, u = jax_fidelity_states(8192)
    fj = jd.xdot_fidelity(jw, jax.tree.map(jnp.asarray, p), mean, std)
    ft = td.xdot_fidelity(tw, p, mean, std, s=T(s), u=T(u))
    np.testing.assert_allclose(ft["xdot_r2"], fj["xdot_r2"], rtol=0, atol=1e-5)
    assert ft["xdot_r2_min"] >= 0.999 and fj["xdot_r2_min"] >= 0.999
    # the port's own draws of the same protocol land on the same gate
    own = td.xdot_fidelity(tw, p, mean, std)
    assert own["xdot_r2_min"] >= 0.999


def test_to_npz_round_trip(tmp_path, w43):
    """The port's npz equals the JAX writer's for the same parameters, and
    both packages' loaders read it."""
    _, tw = w43
    p = jax_params(7)
    rng = np.random.default_rng(0)
    mean, std = rng.normal(size=jd.K).astype(np.float32), rng.uniform(1, 2, jd.K).astype(
        np.float32)
    meta = {"r2": np.linspace(0.9, 1.0, jd.K), "xdot_r2": np.ones(12)}
    pt, pj = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    td.to_npz(pt, to_port(p), mean, std, meta)
    jd.to_npz(pj, p, mean, std, meta)
    with np.load(pt) as a, np.load(pj) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jw = load_distilled_t(pt)
    w = taero.load_distilled(pt, device="cpu")
    for name, got in zip(taero.LEAVES, w.to_numpy()):
        np.testing.assert_array_equal(got, np.asarray(getattr(jw, name), np.float32),
                                      err_msg=name)


@pytest.mark.parametrize("gate", [0.999, -1e9])
def test_cli_gate(tmp_path, monkeypatch, gate):
    """The JAX CLI's gate logic: below the gate, exit code 1 and no npz;
    above it, the npz both loaders read. The raw parameters are written
    beside the output either way, and nothing under the JAX package."""
    monkeypatch.setattr(td, "STATS_SAMPLES", 4096)
    monkeypatch.setattr(td, "evaluate", functools.partial(td.evaluate, n=4096))
    out = str(tmp_path / "run" / "distilled.npz")
    rc = cli.main(["--hidden", str(HIDDEN), "--steps", "3", "--batch", "256",
                   "--log-every", "1", "--device", "cpu", "--gate", str(gate), "--out", out])
    with np.load(str(tmp_path / "run" / "distill_params_raw.npz")) as raw:
        assert raw["W1"].shape == (HIDDEN, td.N_FEAT) and raw["out_std"].shape == (jd.K,)
    if gate > 0:
        assert rc == 1 and not os.path.exists(out)
        return
    assert rc == 0
    w = taero.load_distilled(out, device="cpu")
    assert w.hidden == HIDDEN
    load_distilled_t(out)
    assert os.path.abspath(cli.DEFAULT_OUT).startswith(os.getcwd())
    assert "neuralplane_tpu" + os.sep not in cli.DEFAULT_OUT
