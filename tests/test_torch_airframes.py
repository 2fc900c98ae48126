"""The port's other two airframes against the JAX package on the CPU: the
UAV point mass (ops/dynamics.nlplant_uav, models/uav.py) and the Cessna-172P
(ops/linear_aero.py, models/c172p.py). Both are elementwise eager tensor
ops; no kernel runs.

- nlplant_uav and nlplant_linear on random states from a seeded numpy
  generator: within 1e-5 of each output column's RMS.
- The physics checks of tests/test_c172p.py:38-86 (trim balance, static
  stability and control signs, 10 s of level flight), run on the port.
- ControlEnv on UAV/tracking and C172P/heading_c172p (sensor noise off):
  a JAX state carried in with Env.state_from_jax, 5 steps on the same numpy
  actions, at the env tolerances of tests/test_torch_env.py (obs 2e-5,
  reward 1e-4, flags exact; the state at 1e-5 of each column's RMS, since
  the UAV's controls are forces of up to 27000 N, whose float32 ulp the
  actuator lag's cancellation leaves in a small force).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralplane_tpu.envs import ControlEnv as JaxControlEnv
from neuralplane_tpu.ops.dynamics import nlplant_uav as j_nlplant_uav
from neuralplane_tpu.ops.linear_aero import C172P as J_C172P
from neuralplane_tpu.ops.linear_aero import nlplant_linear as j_nlplant_linear
from neuralplane_tpu.utils.config import load_config as j_load_config
from neuralplane_tpu_torch.envs import ControlEnv
from neuralplane_tpu_torch.models import C172PModel, UAVModel
from neuralplane_tpu_torch.ops.atmosphere import atmos
from neuralplane_tpu_torch.ops.dynamics import nlplant_uav
from neuralplane_tpu_torch.ops.linear_aero import C172P, nlplant_linear
from neuralplane_tpu_torch.utils.config import load_config

from test_torch_env import N as ENV_N
from test_torch_env import run_side_by_side

N = 256


def uav_states(rng, n):
    """SI states (m, rad, m/s, rad/s) and body forces (N)."""
    s = np.zeros((n, 12), np.float32)
    s[:, 0:2] = rng.uniform(-2e3, 2e3, (n, 2))
    s[:, 2] = rng.uniform(1e3, 8e3, n)
    s[:, 3] = rng.uniform(-1.5, 1.5, n)
    s[:, 4] = rng.uniform(-1.2, 1.2, n)
    s[:, 5] = rng.uniform(-3.0, 3.0, n)
    s[:, 6] = rng.uniform(50.0, 400.0, n)
    s[:, 7:9] = rng.uniform(-30.0, 30.0, (n, 2))
    s[:, 9:12] = rng.uniform(-2.0, 2.0, (n, 3))
    return s, rng.uniform(-27000.0, 27000.0, (n, 3)).astype(np.float32)


def c172p_states(rng, n):
    """US-unit states inside a GA envelope and the 172's control throws."""
    s = np.zeros((n, 12), np.float32)
    s[:, 0:2] = rng.uniform(-3e3, 3e3, (n, 2))
    s[:, 2] = rng.uniform(1e3, 1.2e4, n)
    s[:, 3:6] = rng.uniform(-0.8, 0.8, (n, 3))
    s[:, 6] = rng.uniform(100.0, 320.0, n)
    s[:, 7] = rng.uniform(-0.2, 0.3, n)
    s[:, 8] = rng.uniform(-0.2, 0.2, n)
    s[:, 9:12] = rng.uniform(-0.5, 0.5, (n, 3))
    u = np.zeros((n, 5), np.float32)
    u[:, 0] = rng.uniform(0.0, 500.0, n)
    u[:, 1] = rng.uniform(-25.0, 25.0, n)
    u[:, 2] = rng.uniform(-20.0, 20.0, n)
    u[:, 3] = rng.uniform(-16.0, 16.0, n)
    return s, u


def assert_cols_close(got: np.ndarray, want: np.ndarray, rel: float = 1e-5):
    rms = np.sqrt((want.astype(np.float64) ** 2).mean(axis=0))
    err = np.abs(got.astype(np.float64) - want).max(axis=0)
    assert (err <= rel * rms).all(), (err / rms).tolist()


@pytest.mark.parametrize("seed", [0, 1])
def test_nlplant_uav_matches_jax(seed):
    s, u = uav_states(np.random.default_rng(seed), N)
    got = nlplant_uav(torch.from_numpy(s), torch.from_numpy(u)).numpy()
    assert got.shape == (N, 12)
    assert_cols_close(got, np.asarray(j_nlplant_uav(jnp.asarray(s), jnp.asarray(u))))


@pytest.mark.parametrize("seed", [0, 1])
def test_nlplant_linear_matches_jax(seed):
    s, u = c172p_states(np.random.default_rng(seed), N)
    got = nlplant_linear(C172P, torch.from_numpy(s), torch.from_numpy(u)).numpy()
    assert got.shape == (N, 12)
    assert_cols_close(got, np.asarray(j_nlplant_linear(J_C172P, jnp.asarray(s),
                                                       jnp.asarray(u))))


def test_c172p_table_is_the_jax_table():
    """The derivative table and airframe constants, float for float."""
    assert C172P.const._asdict() == J_C172P.const._asdict()
    assert {k: v for k, v in C172P._asdict().items() if k != "const"} == \
        {k: v for k, v in J_C172P._asdict().items() if k != "const"}


# tests/test_c172p.py:17-86 on the port
ALT, VT = 5500.0, 220.0
TRIM_ALPHA, TRIM_DE_DEG, TRIM_T = -0.0071, -0.39, 299.5


def _state(alpha=TRIM_ALPHA, theta=None, vt=VT, n=1):
    s = torch.zeros((n, 12))
    s[:, 2], s[:, 6], s[:, 7] = ALT, vt, alpha
    s[:, 4] = alpha if theta is None else theta
    return s


def _ctrl(T=TRIM_T, el=TRIM_DE_DEG, ail=0.0, rud=0.0, n=1):
    u = torch.zeros((n, 5))
    u[:, 0], u[:, 1], u[:, 2], u[:, 3] = T, el, ail, rud
    return u


def test_c172p_trim_point_balances():
    xd = nlplant_linear(C172P, _state(), _ctrl())[0]
    assert abs(xd[6]) < 0.5 and abs(xd[7]) < 5e-3
    assert abs(xd[10]) < 5e-3 and abs(xd[2]) < 2.0
    _, qbar, _ = atmos(torch.tensor([ALT]), torch.tensor([VT]))
    CL = 2300.0 / (float(qbar[0]) * C172P.const.s_area)
    D = float(qbar[0]) * C172P.const.s_area * (C172P.CD0 + C172P.k_ind * CL ** 2)
    assert abs(TRIM_T - D) / D < 0.05


def test_c172p_static_stability_signs():
    xd0 = nlplant_linear(C172P, _state(), _ctrl())[0]
    xd = nlplant_linear(C172P, _state(alpha=TRIM_ALPHA + 0.05), _ctrl())[0]
    assert xd[10] < xd0[10] - 0.5
    sb = _state()
    sb[0, 8] = 0.1
    xdb = nlplant_linear(C172P, sb, _ctrl())[0]
    assert xdb[11] > 0.05 and xdb[9] < -0.05
    xde = nlplant_linear(C172P, _state(), _ctrl(el=TRIM_DE_DEG - 5.0))[0]
    assert xde[10] > xd0[10] + 0.1
    xdt = nlplant_linear(C172P, _state(), _ctrl(T=TRIM_T + 100))[0]
    assert xdt[6] > xd0[6] + 1.0


def test_c172p_level_flight_holds():
    s, u = _state(n=4), _ctrl(n=4)
    for _ in range(500):
        s = s + 0.02 * nlplant_linear(C172P, s, u)
    assert torch.isfinite(s).all()
    assert (s[:, 2] - ALT).abs().max() < 20.0 and (s[:, 6] - VT).abs().max() < 2.0


def test_model_table_and_scales():
    env = ControlEnv(num_envs=2, config="heading_c172p", model="C172P", device="cpu")
    assert isinstance(env.model, C172PModel) and env.model.weights is None
    assert env.model.thrust_scale == 500.0 and env.model.surface_scales == (25.0, 20.0, 16.0)
    assert env.config.fused_task_kernel and not env.fused
    uav = ControlEnv(num_envs=2, config="tracking", model="UAV", device="cpu")
    assert isinstance(uav.model, UAVModel) and not uav.fused
    with pytest.raises(ValueError, match="model must be one of"):
        ControlEnv(num_envs=2, config="heading", model="B747", device="cpu")


@pytest.mark.parametrize("model,scenario,task", [("UAV", "tracking", "tracking"),
                                                 ("C172P", "heading_c172p", "heading")])
def test_control_env_matches_jax(model, scenario, task):
    jenv = JaxControlEnv(num_envs=ENV_N, config=j_load_config(scenario, noise_scale=0.0),
                         task=task, model=model)
    env = ControlEnv(num_envs=ENV_N, config=load_config(scenario, noise_scale=0.0),
                     task=task, model=model, device="cpu")
    assert not env.fused
    run_side_by_side(jenv, env, steps=5, state_rel_rms=True)


def test_uav_reset_draws_feet_stores_metres():
    env = ControlEnv(num_envs=64, config="tracking", model="UAV", device="cpu")
    state, obs = env.reset(0)
    s, cfg = state.model.s, env.config
    ft = 0.3048
    assert ((s[:, 2] >= cfg.min_altitude * ft - 1e-3)
            & (s[:, 2] <= cfg.max_altitude * ft + 1e-3)).all()
    assert ((s[:, 6] >= cfg.min_vt * ft - 1e-3) & (s[:, 6] <= cfg.max_vt * ft + 1e-3)).all()
    assert (state.model.u[:, 0] == cfg.init_state.init_T).all()
    _, _, alt_ft = env.model.get_position(state.model)
    assert torch.allclose(alt_ft, s[:, 2] / ft)
