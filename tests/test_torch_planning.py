"""The port's hierarchical planning env (envs/planning.py) against the JAX
package's PlanningEnv on the CPU.

Both envs run the tracking scenario with `low_level_steps` cut to 5 by a
config override, n = 8, over the committed control policy
(results/control/policy_checkpoint.pkl) as the frozen low level, carried
into the port by params_from_jax. A JAX state after its reset comes across
by PlanningEnv.state_from_jax; then 2 high-level steps on the same numpy
actions. Compared: the state s and u, obs, reward, flags, step_count and
the low-level GRU state h_low, on rows that no reset touched (the two
packages draw resets from different generators), at the env tolerances of
tests/test_torch_env.py: h_low 1e-5, obs 2e-5, reward 1e-4, flags and step
counts exact, and the state at 1e-5 of each column's RMS (thrust is the
actor's output times 5632 lbf after the lag's 0.1, so float32 differences
of the actor's mean reach a few hundredths of a pound there).

One row starts 3 steps short of the task's max_check_interval, so its
bad_done fires at the third inner step: the last two inner steps must roll
it back and freeze it, on both sides. Another is flagged for reset before
the first step, so both sides take the masked reset and zero its h_low.

The aero backend is set for both sides through NEURALPLANE_AERO_BACKEND:
"stacked" (the 43 nets in float32), and "distilled" with the JAX xdot
kernel in interpret mode (the port's plain version of nlplant_distilled on
the CPU).
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from neuralplane_tpu.envs import PlanningEnv as JaxPlanningEnv
from neuralplane_tpu.scripts import train as jtrain
from neuralplane_tpu.utils.config import load_config as j_load_config
from neuralplane_tpu_torch.algorithms.networks import params_from_jax
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.envs import PlanningEnv, PlanningState
from neuralplane_tpu_torch.ops import aero_cuda, step_cuda
from neuralplane_tpu_torch.scripts import train as train_cli
from neuralplane_tpu_torch.utils.config import load_config

from test_torch_env import assert_state_close
from test_torch_runner import CONTROL

N, INNER = 8, 5
CUT_ROW, RESET_ROW = 2, 5


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def control_actor():
    with open(CONTROL, "rb") as f:   # the JAX package's own reader
        return to_np(pickle.load(f)["train_state"].params["actor"])


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def side_by_side(jenv, env, steps=2):
    jstate, _ = jenv.reset(jax.random.PRNGKey(3))
    js = jstate.env
    sc = np.zeros(N, np.int32)
    sc[CUT_ROW] = jenv.config.max_check_interval - 3
    flagged = np.zeros(N, bool)
    flagged[RESET_ROW] = True
    h_low = np.asarray(jax.random.normal(jax.random.PRNGKey(4), jstate.h_low.shape)) * 0.1
    jstate = jstate.replace(h_low=jnp.asarray(h_low), env=js.replace(
        step_count=jnp.asarray(sc), bad_done=jnp.asarray(flagged)))
    env.reset(0)   # seeds the port's generator
    state = env.state_from_jax(to_np(jstate))
    assert isinstance(state, PlanningState)
    same = np.ones(N, bool)
    rng = np.random.default_rng(7)
    for k in range(steps):
        prev = state.env
        jmask = np.asarray(jstate.env.is_done | jstate.env.bad_done
                           | jstate.env.exceed_time_limit)
        mask = (prev.is_done | prev.bad_done | prev.exceed_time_limit).numpy()
        np.testing.assert_array_equal(mask, jmask)
        same &= ~jmask
        a = rng.uniform(-1.2, 1.2, (N, 3)).astype(np.float32)
        jstate, jout = jenv.step(jstate, jnp.asarray(a))
        state, out = env.step(state, torch.from_numpy(a))
        msg = f"high-level step {k}"
        for got, want in ((state.env.model.s, jstate.env.model.s),
                          (state.env.model.u, jstate.env.model.u)):
            assert_state_close(got.numpy()[same], np.asarray(want)[same], True, msg)
        for got, want, tol in ((state.h_low, jstate.h_low, 1e-5),
                               (out.obs, jout.obs, 2e-5), (out.reward, jout.reward, 1e-4)):
            np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same],
                                       rtol=tol, atol=tol, err_msg=msg)
        for f in ("done", "bad_done", "exceed_time_limit"):
            np.testing.assert_array_equal(getattr(out, f).numpy()[same],
                                          np.asarray(getattr(jout, f))[same], err_msg=msg)
        np.testing.assert_array_equal(state.env.step_count.numpy(),
                                      np.asarray(jstate.env.step_count), err_msg=msg)
        assert out.info is None
        if k == 0:
            assert np.asarray(jout.bad_done)[CUT_ROW] and bool(out.bad_done[CUT_ROW])
            assert int(state.env.step_count[RESET_ROW]) == INNER
    assert same.sum() >= N - 2


def make_envs(control_actor, monkeypatch, backend):
    monkeypatch.setenv("NEURALPLANE_AERO_BACKEND", backend)
    jenv = JaxPlanningEnv(num_envs=N, config=j_load_config("tracking", low_level_steps=INNER),
                          low_level_params=jax.tree.map(jnp.asarray, control_actor))
    env = PlanningEnv(num_envs=N, config=load_config("tracking", low_level_steps=INNER),
                      low_level_params=params_from_jax(control_actor), device="cpu")
    assert env.low_level_steps == INNER and not env.fused
    return jenv, env


def test_planning_env_stacked_matches_jax(control_actor, monkeypatch):
    jenv, env = make_envs(control_actor, monkeypatch, "stacked")
    assert type(jenv.model.weights).__name__ == "AeroWeights"
    side_by_side(jenv, env)


def test_planning_env_distilled_matches_jax(control_actor, monkeypatch, interpret_pallas):
    jenv, env = make_envs(control_actor, monkeypatch, "distilled")
    assert type(jenv.model.weights).__name__ == "DistilledAeroWeightsT"
    aero_cuda.nlplant_distilled.launches = 0
    side_by_side(jenv, env)
    # on the CPU the wrapper runs its plain version: nothing was launched
    assert aero_cuda.nlplant_distilled.launches == 0


def test_rolled_back_row_is_frozen(control_actor, monkeypatch):
    """The row whose bad_done fires at the third inner step ends with the
    state of that step: rerunning 3 inner steps alone gives the same s and
    u; the step count still counts all 5."""
    monkeypatch.setenv("NEURALPLANE_AERO_BACKEND", "stacked")
    cfg = load_config("tracking", low_level_steps=INNER)
    env = PlanningEnv(num_envs=N, config=cfg, low_level_params=params_from_jax(control_actor),
                      device="cpu")
    three = PlanningEnv(num_envs=N, config=cfg.replace(low_level_steps=3),
                        low_level_params=params_from_jax(control_actor), device="cpu")
    state, _ = env.reset(0)
    three.reset(0)
    sc = torch.zeros(N, dtype=torch.int32)
    sc[CUT_ROW] = cfg.max_check_interval - 3
    state = PlanningState(env=state.env.replace(step_count=sc), h_low=state.h_low)
    a = torch.zeros((N, 3))
    s5, out5 = env.step(state, a)
    s3, out3 = three.step(state, a)
    assert bool(out5.bad_done[CUT_ROW]) and bool(out3.bad_done[CUT_ROW])
    assert torch.equal(s5.env.model.s[CUT_ROW], s3.env.model.s[CUT_ROW])
    assert torch.equal(s5.env.model.u[CUT_ROW], s3.env.model.u[CUT_ROW])
    assert not torch.equal(s5.env.model.s[0], s3.env.model.s[0])
    assert int(s5.env.step_count[CUT_ROW]) == cfg.max_check_interval + 2


def test_control_checkpoint_low_level_matches_jax_load(tmp_path):
    """results/control/policy_checkpoint.pkl as the low level, through each
    package's CLI make_env: the port's actor equals the JAX load leaf for
    leaf; and a port `.pt` of it loads the same."""
    argv = ["--env-name", "Planning", "--scenario-name", "tracking", "--n-rollout-threads",
            "2", "--low-level-ckpt", CONTROL]
    jenv = jtrain.make_env(jtrain.get_parser().parse_args(argv))
    env = train_cli.make_env(train_cli.get_parser().parse_args(argv + ["--device", "cpu"]))
    want = params_from_jax(to_np(jenv.low_level_params))
    got = env.low_actor.state_dict()
    assert list(got) == list(want) or set(got) == set(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name
    assert not any(p.requires_grad for p in env.low_actor.parameters())
    # a port checkpoint (policy state_dict under "policy") of the same actor
    pt = tmp_path / "state.pt"
    torch.save({"policy": {f"actor.{k}": v for k, v in got.items()}}, pt)
    from_pt = PlanningEnv(num_envs=2, config=load_config("tracking", low_level_ckpt=str(pt)),
                          device="cpu")
    for name, w in want.items():
        assert torch.equal(from_pt.low_actor.state_dict()[name], w), name


def test_low_level_mismatch_names_first_leaf(control_actor):
    with pytest.raises(ValueError, match=r"first difference at .*trunk\.gru\.layers\.0"):
        PlanningEnv(num_envs=2, low_level_params=control_actor,
                    low_level_cfg=RLConfig(recurrent_hidden_size=64), device="cpu")


def test_random_low_level_is_seeded_and_steps(monkeypatch):
    """Without parameters the low level is a random init from a generator
    seeded 0: two envs hold the same actor. A step advances every row by
    low_level_steps and never launches the step kernel."""
    cfg = load_config("tracking", low_level_steps=3)
    a, b = (PlanningEnv(num_envs=4, config=cfg, device="cpu") for _ in range(2))
    for (name, x), y in zip(a.low_actor.state_dict().items(), b.low_actor.state_dict().values()):
        assert torch.equal(x, y), name
    step_cuda.env_step.launches = 0
    state, obs = a.reset(0)
    assert obs.shape == (4, 22) and a.num_actions == 3 and state.h_low.shape == (4, 1, 128)
    state, out = a.step(state, torch.zeros((4, 3)))
    assert (state.env.step_count == 3).all() and torch.isfinite(out.obs).all()
    assert state.env.model.recent_s.shape == (4, 12)
    assert step_cuda.env_step.launches == 0
