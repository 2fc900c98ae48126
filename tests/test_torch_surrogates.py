"""Table interpolation, the lo-fi tables and the surrogate training of the
PyTorch port (neuralplane_tpu_torch.ops.interp, ops.lofi,
surrogates.tables, surrogates.train, scripts.train_surrogates) against the
JAX package on the CPU.

The NASA .dat tables are not in the repository, so the table tests write
small tables of their own in the reference's layout. Tolerances: the
interpolation, the lo-fi tables, the table grids and the learning-rate
schedule exact or within 1e-6 relative; one and two training epochs from
the same weights over the same minibatch order within 1e-5 of each leaf's
largest value.
"""
import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralplane_tpu.ops import interp as ji
from neuralplane_tpu.ops import lofi as jl
from neuralplane_tpu.ops.aero import load_aero_weights as jax_load_aero
from neuralplane_tpu.surrogates import tables as jt
from neuralplane_tpu.surrogates import train as jtr
from neuralplane_tpu_torch.ops import aero as taero
from neuralplane_tpu_torch.ops import interp as ti
from neuralplane_tpu_torch.ops import lofi as tl
from neuralplane_tpu_torch.scripts import train_surrogates as tcli
from neuralplane_tpu_torch.surrogates import tables as tt
from neuralplane_tpu_torch.surrogates import train as ttr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- interp

@pytest.mark.parametrize("dims", [(5,), (4, 3), (3, 4, 2), (1, 6)])
def test_interpn_matches_jax(dims):
    rng = np.random.default_rng(len(dims) * 10 + dims[0])
    axes = [np.cumsum(rng.uniform(0.5, 2.0, d)).astype(np.float32) - 3.0 for d in dims]
    values = rng.standard_normal(dims).astype(np.float32)
    lo = np.array([a[0] for a in axes]) - 1.0
    hi = np.array([a[-1] for a in axes]) + 1.0
    pts = rng.uniform(lo, hi, (300, len(dims))).astype(np.float32)   # some outside
    want = np.asarray(ji.interpn([jnp.asarray(a) for a in axes], jnp.asarray(values),
                                 jnp.asarray(pts)))
    got = ti.interpn(axes, values, T(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_interpn_exact_on_linear_and_clamps():
    """tests/test_surrogates.py:17-35 on the port."""
    axes = [np.array([0.0, 1.0, 3.0]), np.array([-1.0, 0.0, 2.0]), np.array([0.0, 4.0])]
    g = np.meshgrid(*axes, indexing="ij")
    vals = 2.0 * g[0] - 3.0 * g[1] + 0.5 * g[2] + 1.0
    pts = np.array([[0.5, -0.5, 2.0], [2.0, 1.0, 1.0], [3.0, 2.0, 4.0]], np.float32)
    expect = 2.0 * pts[:, 0] - 3.0 * pts[:, 1] + 0.5 * pts[:, 2] + 1.0
    np.testing.assert_allclose(ti.interpn(axes, vals, T(pts)).numpy(), expect, rtol=1e-6)
    out = ti.interpn([np.array([0.0, 1.0])], np.array([1.0, 2.0]),
                     T(np.array([[-5.0], [10.0]], np.float32)))
    np.testing.assert_allclose(out.numpy(), [1.0, 2.0])


def test_table_from_flat_and_load_dat(tmp_path):
    axes = [np.arange(2.0), np.arange(3.0)]
    flat = np.arange(6.0)
    table = ti.table_from_flat(flat, axes)
    assert table.shape == (2, 3) and table[1, 0] == 1.0 and table[0, 1] == 2.0
    np.testing.assert_array_equal(table, ji.table_from_flat(flat, axes))
    path = tmp_path / "t.dat"
    path.write_text("1.5 -2e-3\n 7\t8.25\n")
    np.testing.assert_array_equal(ti.load_dat(str(path)), ji.load_dat(str(path)))


# ---------------------------------------------------------------- lofi

LOFI = {"damping": 1, "dmomdcon": 2, "clcn": 2, "cxcm": "ae", "cz": 3}


@pytest.mark.parametrize("name", sorted(LOFI))
def test_lofi_matches_jax(name):
    rng = np.random.default_rng(len(name))
    a = rng.uniform(-15, 50, 2000).astype(np.float32)    # past both ends
    b = rng.uniform(-35, 35, 2000).astype(np.float32)
    e = rng.uniform(-30, 30, 2000).astype(np.float32)
    args = {1: (a,), 2: (a, b), 3: (a, b, e), "ae": (a, e)}[LOFI[name]]
    want = getattr(jl, name)(*map(jnp.asarray, args))
    got = getattr(tl, name)(*map(T, args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_lofi_tables_and_reference_checks():
    """The port's copy of the tables, and tests/test_lofi.py:16-40 on it."""
    for k in ("ALPHA_AXIS", "BETA_AXIS", "DELE_AXIS", "_DAMP", "_DLDA", "_DLDR", "_DNDA",
              "_DNDR", "_CL", "_CN", "_CX", "_CM", "_CZ"):
        np.testing.assert_array_equal(getattr(tl, k), getattr(jl, k), err_msg=k)
    out = tl.damping(T(np.array([-10.0, 0.0, 20.0, 45.0], np.float32)))
    assert len(out) == 9 and out[0].shape == (4,)
    np.testing.assert_allclose(float(out[0][0]), -0.267, rtol=1e-6)
    np.testing.assert_allclose(float(out[3][1]), -28.9, rtol=1e-6)
    cl, cn = tl.clcn(T(np.array([10.0, 10.0], np.float32)), T(np.array([15.0, -15.0], np.float32)))
    np.testing.assert_allclose(float(cl[0]), -float(cl[1]), rtol=1e-6)
    np.testing.assert_allclose(float(cn[0]), -float(cn[1]), rtol=1e-6)
    z = T(np.zeros(1, np.float32))
    base = float(tl.cz(z, z, z)[0])
    np.testing.assert_allclose(base, -0.100, rtol=1e-5)
    with_el = float(tl.cz(z, z, T(np.array([25.0], np.float32)))[0])
    np.testing.assert_allclose(with_el, base - 0.19, rtol=1e-4)


# ---------------------------------------------------------------- tables

# ALPHA1 keeps the NASA tables' 20 points (tests/test_surrogates.py:49), so
# that a 1-D table gives a whole minibatch of 32 at subdivide 2
SMALL_AXES = {"ALPHA1": np.linspace(-20.0, 90.0, 20),
              "ALPHA2": np.linspace(-20.0, 45.0, 7),
              "BETA1": np.array([-30.0, -10.0, 0.0, 10.0, 30.0]),
              "DH1": np.array([-25.0, -10.0, 0.0, 10.0, 25.0]),
              "DH2": np.array([-25.0, 25.0])}


def write_tables(data_dir, names):
    """Axis files and the named coefficient tables in the reference layout
    (whitespace-separated, Fortran order), values a smooth function of the
    grid."""
    os.makedirs(data_dir, exist_ok=True)
    for ax, v in SMALL_AXES.items():
        with open(os.path.join(data_dir, f"{ax}.dat"), "w") as f:
            f.write(" ".join(f"{x:.6f}" for x in v) + "\n")
    for i, name in enumerate(names):
        dat, axis_names, _ = tt.TABLE_REGISTRY[name]
        axes = [SMALL_AXES[a] for a in axis_names]
        g = np.meshgrid(*axes, indexing="ij")
        vals = 0.01 * (i + 1) * np.sin(sum((k + 1) * x / 30.0 for k, x in enumerate(g)))
        flat = vals.transpose(range(len(axes) - 1, -1, -1)).reshape(-1)
        with open(os.path.join(data_dir, dat), "w") as f:
            f.write("\n".join(f"{x:.8e}" for x in flat) + "\n")


def test_table_registry_is_the_jax_one():
    assert tt.TABLE_REGISTRY == jt.TABLE_REGISTRY
    assert set(tt.TABLE_REGISTRY) == set(taero.AERO_NAMES)


def test_load_tables_call_and_dense_grid(tmp_path):
    names = ["Cx", "delta_Cl_lef", "eta_el"]
    write_tables(str(tmp_path), names)
    tp, jp = tt.load_tables(str(tmp_path), names), jt.load_tables(str(tmp_path), names)
    rng = np.random.default_rng(3)
    for name in names:
        a, b = tp[name], jp[name]
        assert a.input_keys == b.input_keys and a.name == b.name
        for x, y in zip(a.axes, b.axes):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.values, b.values)
        lo, hi = [ax[0] for ax in a.axes], [ax[-1] for ax in a.axes]
        pts = rng.uniform(lo, hi, (200, len(lo)))
        np.testing.assert_allclose(a(pts), b(pts), rtol=1e-6, atol=1e-9)
        # at a grid node the node value
        node = np.array([[ax[1] if len(ax) > 1 else ax[0] for ax in a.axes]])
        np.testing.assert_allclose(a(node)[0], a.values[(1,) * len(a.axes)], rtol=1e-6)
        (pa, ya), (pb, yb) = a.dense_grid(3), b.dense_grid(3)
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_allclose(ya, yb, rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------- train

def test_lr_schedule_and_init():
    for epoch in (0, 1, 499, 500, 749, 750, 899, 900, 999, 2000):
        np.testing.assert_allclose(ttr._lr_schedule(epoch), float(jtr._lr_schedule(epoch)),
                                   rtol=1e-6)
    layers = ttr.init_mlp(3, ttr.HIDDEN, torch.Generator().manual_seed(0))
    jlayers = jtr._init_mlp(jax.random.PRNGKey(0), 3)
    for a, b in zip(layers, jlayers):
        assert a["w"].shape == b["w"].shape and a["b"].shape == b["b"].shape
        bound = 1.0 / np.sqrt(a["w"].shape[0])
        assert a["w"].abs().max() <= bound and not a["b"].any()


def jax_epochs(params, X, Y, orders, lrs):
    """train_surrogate's epoch (train.py:110-121) with given orders and rates."""
    tx = optax.chain(optax.add_decayed_weights(5e-4), optax.sgd(learning_rate=1.0, momentum=0.9))
    opt_state = tx.init(params)
    loss = lambda p, xb, yb: jnp.abs(jtr._mlp_apply(p, xb) - yb).mean()
    for order, lr in zip(orders, lrs):
        for idx in order:
            grads = jax.grad(loss)(params, X[idx], Y[idx])
            updates, opt_state = tx.update(grads, opt_state, params)
            updates = jax.tree_util.tree_map(lambda u: u * lr, updates)
            params = optax.apply_updates(params, updates)
    return params


def test_epochs_match_jax():
    """Two epochs (SGD, momentum, weight decay, the epoch's rate) from the
    same weights over the same minibatch orders; torch.optim.SGD with
    weight_decay and momentum is optax's add_decayed_weights + sgd."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((96, 2)).astype(np.float32)
    Y = np.sin(X[:, :1] * 2.0 + X[:, 1:]).astype(np.float32)
    jparams = jtr._init_mlp(jax.random.PRNGKey(1), 2)
    orders = [rng.permutation(96)[:96].reshape(3, 32) for _ in range(2)]
    lrs = [ttr._lr_schedule(0), ttr._lr_schedule(600)]
    want = jax_epochs(jparams, jnp.asarray(X), jnp.asarray(Y), orders, lrs)
    params = [{k: T(np.asarray(v)).requires_grad_() for k, v in layer.items()}
              for layer in jparams]
    opt = ttr.make_optimizer(params)
    for order, lr in zip(orders, lrs):
        ttr.run_epoch(params, opt, T(X), T(Y), T(order), lr)
    for got, exp in zip(params, want):
        for k in ("w", "b"):
            e = np.asarray(exp[k])
            np.testing.assert_array_less(np.abs(got[k].detach().numpy() - e),
                                         1e-5 * np.abs(e).max() + 1e-12)
    xs = rng.standard_normal((20, 2)).astype(np.float32)
    np.testing.assert_allclose(ttr.mlp_apply(params, T(xs)).detach().numpy(),
                               np.asarray(jtr._mlp_apply(want, jnp.asarray(xs))),
                               rtol=1e-4, atol=1e-5)
    yt, pt = T(Y[:40]), T(Y[:40] * 0.9)
    np.testing.assert_allclose(float(ttr._r2(yt, pt)),
                               float(jtr._r2(jnp.asarray(Y[:40]), jnp.asarray(Y[:40] * 0.9))),
                               rtol=1e-6)


def lofi_table():
    return tt.AeroTable("Cx", (tl.ALPHA_AXIS, tl.DELE_AXIS), tl._CX.T.copy(), ("alpha", "el"))


def test_train_surrogate_and_padding():
    """train_surrogate's result has the JAX package's keys; the padded
    [3 -> 20 -> 20 -> 10 -> 1] net reproduces the trained one exactly, and
    both packages' padding agree."""
    r = ttr.train_surrogate(lofi_table(), seed=0, epochs=3, device="cpu")
    assert set(r) == {"name", "params", "input_keys", "x_mean", "x_std", "y_mean", "y_std",
                      "test_r2", "passed"}
    assert np.isfinite(r["test_r2"]) and r["passed"] == (r["test_r2"] > 0.97)
    assert [l["w"].shape for l in r["params"]] == [(2, 20), (20, 10), (10, 1)]
    W1, B1, W2, B2, W3, B3, W4, B4 = ttr._pad_layers(r)
    for a, b in zip((W1, B1, W2, B2, W3, B3, W4, B4), jtr._pad_layers(r)):
        np.testing.assert_array_equal(a, b)
    alpha = np.array([-5.0, 12.5, 37.5])
    el = np.array([-20.0, 3.0, 18.0])
    raw = np.stack([alpha, np.zeros(3), el], axis=1)
    h = np.maximum(raw @ W1 + B1, 0.0)
    h = np.maximum(h @ W2 + B2, 0.0)
    h = np.maximum(h @ W3 + B3, 0.0)
    z = (np.stack([alpha, el], 1) - r["x_mean"]) / r["x_std"]
    params = [{k: T(np.asarray(v, np.float32)) for k, v in layer.items()} for layer in r["params"]]
    direct = ttr.mlp_apply(params, T(z.astype(np.float32))).numpy()[:, 0]
    np.testing.assert_allclose(h @ W4 + B4, direct * r["y_std"] + r["y_mean"],
                               rtol=1e-4, atol=1e-5)


def test_assembled_weights_read_by_both_packages(tmp_path):
    """assemble_stacked_weights of both packages on the same 43 results write
    the same npz, which both packages' load_aero_weights read."""
    base = ttr.train_surrogate(lofi_table(), seed=1, epochs=1, device="cpu")
    col = {"alpha": 0, "beta": 1, "el": 2}
    results = {}
    for i, name in enumerate(taero.AERO_NAMES):
        keys = tt.TABLE_REGISTRY[name][2]
        rng = np.random.default_rng(i)
        params = [{"w": rng.standard_normal((len(keys), 20)).astype(np.float32) * 0.3,
                   "b": rng.standard_normal(20).astype(np.float32) * 0.1}] + base["params"][1:]
        results[name] = {**base, "name": name, "input_keys": keys, "params": params,
                         "x_mean": np.array([base["x_mean"][0]] * len(keys)) + [col[k] for k in keys],
                         "x_std": np.array([base["x_std"][0]] * len(keys))}
    pt, pj = str(tmp_path / "a" / "port.npz"), str(tmp_path / "b" / "jax.npz")
    ttr.assemble_stacked_weights(results, pt)
    jtr.assemble_stacked_weights(results, pj)
    with np.load(pt) as a, np.load(pj) as b:
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tw = taero.load_aero_weights(pt, device="cpu")
    jw = jax_load_aero(pt)
    for name, got in zip(taero.AERO_LEAVES, tw.to_numpy()):
        np.testing.assert_array_equal(got, np.asarray(getattr(jw, name)), err_msg=name)


def read_report(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_cli_subset_and_gate(tmp_path, capsys):
    """The JAX CLI and the port's on the same synthetic tables: the same
    report rows (name, R^2, pass flag by the gate) and the same gate
    behaviour (no weights below the gate, no assembly for a subset)."""
    data = str(tmp_path / "tables")
    names = ["Cxq", "Cy"]
    write_tables(data, names)
    for gate, expect in (("0.99999", "NOT written"), ("-1e9", "Subset trained")):
        port_csv, jax_csv = str(tmp_path / f"p{gate}.csv"), str(tmp_path / f"j{gate}.csv")
        tcli.main(["--data-dir", data, "--names", *names, "--epochs", "2", "--subdivide", "2",
                   f"--r2-gate={gate}", "--report", port_csv, "--device", "cpu",
                   "--out", str(tmp_path / "never.npz")])
        assert expect in capsys.readouterr().out
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
        r = subprocess.run([sys.executable, "-m", "neuralplane_tpu.scripts.train_surrogates",
                            "--data-dir", data, "--names", *names, "--epochs", "2",
                            "--subdivide", "2", f"--r2-gate={gate}", "--report", jax_csv,
                            "--out", str(tmp_path / "never.npz")],
                           cwd=str(tmp_path), env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0 and expect in r.stdout, r.stdout + r.stderr
        got, want = read_report(port_csv), read_report(jax_csv)
        assert got[0] == want[0] == ["name", "test_r2", "passed"]
        assert [row[0] for row in got] == [row[0] for row in want]
        for row in got[1:]:
            assert row[2] == str(float(row[1]) > float(gate))
    assert not os.path.exists(tmp_path / "never.npz")


def test_small_table_trains_in_one_batch():
    """A table with fewer training points than a batch (eta_el's five
    elevator points give 11 at subdivide 3) trains in one batch in the port;
    the JAX package's train_surrogate cannot reshape it (ROADMAP.md section
    3)."""
    table = tt.AeroTable("eta_el", (np.array([-25.0, -10.0, 0.0, 10.0, 25.0]),),
                         np.array([1.0, 0.95, 0.9, 0.95, 1.0]), ("el",))
    assert len(table.dense_grid(3)[0]) == 13
    r = ttr.train_surrogate(table, seed=0, epochs=3, device="cpu")
    assert np.isfinite(r["test_r2"])
    with pytest.raises(TypeError, match="reshape"):
        jtr.train_surrogate(jt.AeroTable(table.name, table.axes, table.values,
                                         table.input_keys), jax.random.PRNGKey(0), epochs=1)


def test_cli_assembles_all_43(tmp_path):
    """With every table present and the gate passed, the CLI writes the
    stacked npz that both packages' load_aero_weights read."""
    data = str(tmp_path / "tables")
    write_tables(data, list(taero.AERO_NAMES))
    out = str(tmp_path / "f16_aero.npz")
    tcli.main(["--data-dir", data, "--epochs", "1", "--subdivide", "2", "--r2-gate=-inf",
               "--device", "cpu", "--out", out])
    tw = taero.load_aero_weights(out, device="cpu")
    jw = jax_load_aero(out)
    assert tw.W1.shape == (43, 3, 20)
    np.testing.assert_array_equal(tw.to_numpy()[0], np.asarray(jw.W1))
