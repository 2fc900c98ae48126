"""F-16 dynamics of the PyTorch port (ops/dynamics, ops/integrators,
ops/atmosphere) against the reference goldens and the JAX package.

tests/golden/f16_golden.npz carries the reference's own aero coefficients
for each golden state, so `nlplant_core` is held against the golden xdot
with exactly those coefficients; the Euler trajectory takes its
coefficients at each new state from the JAX package's stacked 43-net query
(the surrogate the goldens were made with). Tolerances are those of
tests/test_dynamics.py and tests/test_matlab_anchor.py.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralplane_tpu.ops.aero import aero_coeffs, load_aero_weights
from neuralplane_tpu.ops.dynamics import nlplant_core as j_nlplant_core
from neuralplane_tpu_torch.ops import aero as taero
from neuralplane_tpu_torch.ops import aero_cuda
from neuralplane_tpu_torch.ops.atmosphere import atmos, eas2tas
from neuralplane_tpu_torch.ops.dynamics import R2D, nlplant_core
from neuralplane_tpu_torch.ops.integrators import integrate, integrate_with_xdot

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN, "f16_golden.npz"))


def xdot_with(s: torch.Tensor, u: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Port nlplant_core with given [n, 43] coefficients."""
    return torch.stack(nlplant_core(tuple(s.T), tuple(u.T),
                                    lambda nm: coeffs[:, taero.IDX[nm]]), dim=1)


def stacked_xdot(w43):
    """f(s, u): port nlplant_core on the JAX stacked ensemble's coefficients."""
    def f(s, u):
        c = np.asarray(aero_coeffs(w43, jnp.asarray(s[:, 7].numpy() * R2D),
                                   jnp.asarray(s[:, 8].numpy() * R2D),
                                   jnp.asarray(u[:, 1].numpy())))
        return xdot_with(s, u, torch.from_numpy(np.array(c)))
    return f


@pytest.mark.parametrize("case", ["batch", "trim"])
def test_nlplant_core_matches_reference(golden, case):
    if case == "batch":
        x, c, want = golden["x"], golden["coeffs"], golden["xdot"][:, :12]
    else:
        x = golden["trim_x"][None, :]
        want = golden["trim_xdot"][:, :12]
        c = np.asarray(aero_coeffs(load_aero_weights(),
                                   jnp.asarray(x[:, 7] * R2D, jnp.float32),
                                   jnp.asarray(x[:, 8] * R2D, jnp.float32),
                                   jnp.asarray(x[:, 13], jnp.float32)))
    x = torch.from_numpy(x.astype(np.float32))
    got = xdot_with(x[:, :12], x[:, 12:], torch.from_numpy(c.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


def test_nlplant_core_matches_jax_twin():
    """Same arithmetic as the JAX nlplant_core on the same random states and
    coefficients: float32 rounding only (rtol 1e-5)."""
    rng = np.random.default_rng(0)
    n = 300
    s = rng.uniform(-1, 1, (n, 12)).astype(np.float32)
    s[:, 2] = rng.uniform(3e3, 3e4, n)
    s[:, 6] = rng.uniform(300, 1500, n)
    u = rng.uniform(-20, 20, (n, 5)).astype(np.float32)
    u[:, 0] = rng.uniform(1e3, 1.5e4, n)
    c = rng.normal(0, 0.3, (n, 43)).astype(np.float32)
    want = np.stack(j_nlplant_core(tuple(jnp.asarray(s.T)), tuple(jnp.asarray(u.T)),
                                   lambda nm: jnp.asarray(c[:, taero.IDX[nm]])), 1)
    got = xdot_with(torch.from_numpy(s), torch.from_numpy(u), torch.from_numpy(c))
    scale = np.abs(want).max(0)
    np.testing.assert_allclose(got.numpy() / scale, np.asarray(want) / scale,
                               rtol=1e-5, atol=1e-5)


def test_euler_trajectory_matches_reference(golden):
    f = stacked_xdot(load_aero_weights())
    s = torch.from_numpy(golden["traj_s0"].astype(np.float32))
    u = torch.from_numpy(golden["traj_u"].astype(np.float32))
    for t in range(10):
        s = integrate(f, s, u, 0.02, "euler")
        np.testing.assert_allclose(s.numpy(), golden["traj"][t + 1], rtol=3e-3,
                                   atol=3e-3, err_msg=f"diverged at step {t + 1}")


def test_rk4_close_to_euler_small_dt():
    f = stacked_xdot(load_aero_weights())
    s = torch.tensor([[0, 0, 20000, 0, 0, 0, 1100, 0.05, 0, 0, 0, 0]] * 3,
                     dtype=torch.float32)
    u = torch.tensor([[2000, 0, 0, 0, 0]] * 3, dtype=torch.float32)
    se = integrate(f, s, u, 0.02, "euler")
    sr, k1 = integrate_with_xdot(f, s, u, 0.02, "rk4")
    np.testing.assert_allclose(se.numpy(), sr.numpy(), rtol=1e-2, atol=0.5)
    np.testing.assert_allclose(k1.numpy(), f(s, u).numpy())
    assert torch.equal(integrate(f, s, u, 0.02, "rk4"), sr)
    with pytest.raises(ValueError):
        integrate(f, s, u, 0.02, "midpoint")


def test_atmosphere_matches_jax():
    from neuralplane_tpu.ops.atmosphere import atmos as j_atmos, eas2tas as j_eas2tas
    alt = np.linspace(0.0, 45000.0, 91).astype(np.float32)
    vt = np.linspace(100.0, 1500.0, 91).astype(np.float32)
    got = atmos(torch.from_numpy(alt), torch.from_numpy(vt))
    want = j_atmos(jnp.asarray(alt), jnp.asarray(vt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    np.testing.assert_allclose(eas2tas(torch.from_numpy(alt)).numpy(),
                               np.asarray(j_eas2tas(jnp.asarray(alt))), rtol=1e-6)


def _r2(truth, pred):
    return 1.0 - float(((truth - pred) ** 2).sum()) / float(
        ((truth - truth.mean()) ** 2).sum())


def test_distilled_coefficients_match_matlab_and_c():
    """The port's surrogate (the shipped distilled net, plain version) scored
    against the reference's MATLAB and C table lookups, with the gates of
    tests/test_matlab_anchor.py: every coefficient R^2 >= 0.96 against both,
    median >= 0.99."""
    z = np.load(os.path.join(GOLDEN, "f16_matlab_anchor.npz"))
    w = taero.load_distilled(device="cpu")

    def pred(a, b, e):
        t = [torch.from_numpy(np.asarray(v, np.float32)) for v in (a, b, e)]
        return aero_cuda.distilled_coeff_rows(
            aero_cuda.distilled_feature_rows(*t), w).T.numpy()

    pm = pred(z["alpha"], z["beta"], z["dele"])
    pc = pred(z["alpha_c"], z["beta_c"], z["dele_c"])
    r2_m, r2_c = [], []
    for i, name in enumerate(z["names"]):
        v, k = int(z["valid"][i]), taero.IDX[str(name)]
        r2_m.append(_r2(z["matlab"][i, :v], pm[:v, k]))
        r2_c.append(_r2(z["c"][i], pc[:, k]))
    assert min(r2_m) >= 0.96 and min(r2_c) >= 0.96, (min(r2_m), min(r2_c))
    assert np.median(r2_m) >= 0.99 and np.median(r2_c) >= 0.99
