"""The port's env as a whole: a JAX ControlEnv("heading") and the port's
ControlEnv step side by side on the CPU from the same state, with the same
weights (the shipped distilled H = 256 net, or the shipped 43 nets on the
"pallas" and "stacked" backends) and actions and sensor noise off.

The JAX state is carried into the port with Env.state_from_jax. The two
envs draw reset values from different generators (threefry vs
torch.Generator), so rows that reset on either side leave the comparison;
the number of rows flagged for reset must agree. Tolerances are those of
tests/test_distilled.py:122-131: state 1e-5, obs 2e-5, reward 1e-4, flags
exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from neuralplane_tpu.envs import ControlEnv as JaxControlEnv
from neuralplane_tpu.ops.aero_pallas import load_distilled_t
from neuralplane_tpu.utils.config import load_config as j_load_config
from neuralplane_tpu_torch.envs import ControlEnv
from neuralplane_tpu_torch.utils.config import load_config

from test_torch_aero import port_weights

N = 40


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def assert_state_close(got, want, rel_rms, msg):
    """Model state at 1e-5; with rel_rms, each column's 1e-5 is scaled by
    that column's RMS (the UAV's forces are in newtons: one float32 ulp of
    the 27000 N scale, cancelled in the actuator lag, is 2e-3 N)."""
    if not rel_rms:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=msg)
        return
    rms = np.sqrt((want.astype(np.float64) ** 2).mean(axis=0)) if len(want) else 0.0
    err = np.abs(got.astype(np.float64) - want)
    np.testing.assert_array_less(err, np.broadcast_to(1e-5 * (rms + 1.0), err.shape),
                                 err_msg=msg)


def run_side_by_side(jenv, env, steps=4, state_rel_rms=False):
    rng = np.random.default_rng(21)
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    # flag a few rows so both sides go through the masked reset
    flagged = np.zeros(N, bool)
    flagged[::7] = True
    jstate = jstate.replace(bad_done=jnp.asarray(flagged))
    env.reset(0)   # seeds the port's generator
    state = env.state_from_jax(jax.tree.map(np.asarray, jstate))
    same = np.ones(N, bool)
    for k in range(steps):
        jmask = np.asarray(jstate.is_done | jstate.bad_done | jstate.exceed_time_limit)
        mask = (state.is_done | state.bad_done | state.exceed_time_limit).numpy()
        # rows compared so far are flagged alike, so the counts of reset rows agree
        np.testing.assert_array_equal(mask[same], jmask[same])
        assert mask.sum() == jmask.sum(), f"step {k}: rows flagged for reset differ"
        same &= ~jmask
        a = rng.uniform(-1.0, 1.0, (N, jenv.num_actions)).astype(np.float32)
        jstate, jout = jenv.step(jstate, jnp.asarray(a))
        state, out = env.step(state, torch.from_numpy(a))
        msg = f"step {k}"
        assert_state_close(state.model.s.numpy()[same], np.asarray(jstate.model.s)[same],
                           state_rel_rms, msg)
        assert_state_close(state.model.u.numpy()[same], np.asarray(jstate.model.u)[same],
                           state_rel_rms, msg)
        np.testing.assert_allclose(out.obs.numpy()[same], np.asarray(jout.obs)[same],
                                   rtol=2e-5, atol=2e-5, err_msg=msg)
        np.testing.assert_allclose(out.reward.numpy()[same],
                                   np.asarray(jout.reward)[same],
                                   rtol=1e-4, atol=1e-4, err_msg=msg)
        for f in ("done", "bad_done", "exceed_time_limit"):
            np.testing.assert_array_equal(getattr(out, f).numpy()[same],
                                          np.asarray(getattr(jout, f))[same])
        np.testing.assert_array_equal(state.step_count.numpy(),
                                      np.asarray(jstate.step_count))
        for t, jt in zip(env.task.kernel_targets(state.task),
                         jenv.task.kernel_targets(jstate.task)):
            np.testing.assert_allclose(t.numpy()[same], np.asarray(jt)[same],
                                       rtol=1e-6, atol=1e-6)
        if mask.sum() == 0 and same.all():
            assert {k: int(v) for k, v in out.info.items()} == \
                {k: int(v) for k, v in jout.info.items()}
    assert same.sum() >= N - flagged.sum() - 2


def test_heading_fused_slice_matches_jax(interpret_pallas):
    jw = load_distilled_t()
    jenv = JaxControlEnv(num_envs=N, config="heading", aero_backend="stacked")
    jenv.model.weights = jw
    jenv._task_kernel = True
    jenv.config = jenv.config.replace(noise_scale=0.0, kernel_obs_noise=False,
                                      kernel_reset_draws=False)
    env = ControlEnv(num_envs=N, config="heading", device="cpu")
    env.model.weights = port_weights(jw)
    env.config = env.config.replace(noise_scale=0.0, kernel_obs_noise=False,
                                    kernel_reset_draws=False)
    assert env.fused
    run_side_by_side(jenv, env)


@pytest.mark.parametrize("solver", ["euler", "rk4"])
def test_heading_portable_branch_matches_jax(interpret_pallas, solver):
    jw = load_distilled_t()
    over = dict(noise_scale=0.0, solver=solver, fused_task_kernel=False)
    jenv = JaxControlEnv(num_envs=N, config=j_load_config("heading", **over),
                         task="heading", aero_backend="stacked")
    jenv.model.weights = jw
    assert not jenv._task_kernel
    env = ControlEnv(num_envs=N, config=load_config("heading", **over),
                     task="heading", device="cpu")
    env.model.weights = port_weights(jw)
    assert not env.fused
    run_side_by_side(jenv, env)


def test_heading_fused_43_nets_matches_jax(interpret_pallas):
    """aero_backend="pallas" on both sides: the fused step on the 43 nets."""
    jenv = JaxControlEnv(num_envs=N, config="heading", aero_backend="pallas")
    assert jenv._task_kernel
    jenv.config = jenv.config.replace(noise_scale=0.0, kernel_obs_noise=False,
                                      kernel_reset_draws=False)
    env = ControlEnv(num_envs=N, config="heading", aero_backend="pallas", device="cpu")
    env.config = env.config.replace(noise_scale=0.0, kernel_obs_noise=False,
                                    kernel_reset_draws=False)
    assert env.fused
    run_side_by_side(jenv, env)


@pytest.mark.parametrize("backend,solver", [("pallas", "euler"), ("pallas", "rk4"),
                                            ("stacked", "euler"), ("stacked", "rk4")])
def test_heading_portable_branch_43_nets_matches_jax(interpret_pallas, backend, solver):
    """The portable branch on the 43 nets: the fused xdot kernel's
    arithmetic ("pallas", 1 derivative per Euler step, 4 per RK4 step) and
    the float32 stacked query ("stacked")."""
    over = dict(noise_scale=0.0, solver=solver, fused_task_kernel=False)
    jenv = JaxControlEnv(num_envs=N, config=j_load_config("heading", **over),
                         task="heading", aero_backend=backend)
    assert not jenv._task_kernel
    env = ControlEnv(num_envs=N, config=load_config("heading", **over),
                     task="heading", aero_backend=backend, device="cpu")
    assert not env.fused
    run_side_by_side(jenv, env)


def test_stacked_backend_never_fuses():
    """The stacked container has no step kernel: the configs' fused
    settings fall through to the portable branch
    (neuralplane_tpu/envs/base.py:62-71)."""
    env = ControlEnv(num_envs=4, config="heading", aero_backend="stacked", device="cpu")
    assert env.config.fused_task_kernel and not env.fused
    state, obs = env.reset(0)
    state, out = env.step(state, torch.zeros(4, env.num_actions))
    assert out.obs.shape == obs.shape == (4, 22) and torch.isfinite(out.obs).all()


def test_state_from_jax_round_trip():
    jenv = JaxControlEnv(num_envs=N, config="heading", aero_backend="stacked")
    jstate, _ = jenv.reset(jax.random.PRNGKey(1))
    jstate = jstate.replace(step_count=jnp.arange(N, dtype=jnp.int32),
                            is_done=jnp.arange(N) % 3 == 0)
    leaves = jax.tree.map(np.asarray, jstate)
    env = ControlEnv(num_envs=N, config="heading", device="cpu")
    st = env.state_from_jax(leaves)
    np.testing.assert_array_equal(st.model.s.numpy(), np.asarray(leaves.model.s))
    np.testing.assert_array_equal(st.model.u.numpy(), np.asarray(leaves.model.u))
    for t, jt in zip(env.task.kernel_targets(st.task),
                     jenv.task.kernel_targets(leaves.task)):
        np.testing.assert_array_equal(t.numpy(), jt)
    for f in ("step_count", "is_done", "bad_done", "exceed_time_limit"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), getattr(leaves, f))
    assert st.step_count.dtype == torch.int32 and st.is_done.dtype == torch.bool
