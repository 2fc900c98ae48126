"""The port's combat envs (envs/combat.py) against the JAX package's on the
CPU.

A JAX state after its reset is carried into the port with
SingleCombatEnv.state_from_jax; both sides then take chained steps on the
same numpy actions. The two packages draw resets from different generators,
so a group that resets on either side leaves the comparison from then on;
the first step, before any reset, also compares the `info` counts. Both
aero backends: "stacked" (the 43 nets in float32) and "distilled" (the JAX
xdot kernel in interpret mode, the port's plain version of
nlplant_distilled), set for both sides by NEURALPLANE_AERO_BACKEND.

Tolerances. Each step starts from the JAX state carried across again;
model state, obs and reward then agree per column within 1e-4 of the
column's RMS + 1 (largest measured 1.5e-5: within one step the PID loop
feeds a float32 rounding difference of the state derivative back through
five inner steps at a gain of ~600 deg per rad/s, into servos saturated at
+-45 deg). The AO and TA columns of the obs are held to 1e-3 rad absolute
instead: arccos near +-1 turns one float32 ulp of the cosine into up to
~3.5e-4 rad (measured 1.2e-4 with two aircraft flying in line). Left to
run on (`test_free_chain`), the sides drift about tenfold per step; three
free steps are held to 1e-3 of RMS + 1 (measured 5.9e-5). Blood within
1e-4 absolute (damage is at most 2 per step); flags, step counts,
`active`, `info` counts and the team game's permutations and selections
exactly.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from neuralplane_tpu.envs import MultipleCombatEnv as JaxMulti
from neuralplane_tpu.envs import SingleCombatEnv as JaxSingle
from neuralplane_tpu.utils.config import load_config as j_load_config
from neuralplane_tpu_torch.envs import MultipleCombatEnv, SingleCombatEnv
from neuralplane_tpu_torch.utils.config import load_config
from neuralplane_tpu_torch.utils.math import get_AO_TA_R

REL = 1e-4
CHAIN_REL = 1e-3
ANGLE_ATOL = 1e-3


@pytest.fixture(params=["stacked", "distilled"])
def backend(request, monkeypatch):
    monkeypatch.setenv("NEURALPLANE_AERO_BACKEND", request.param)
    if request.param == "distilled":
        orig = pl.pallas_call
        monkeypatch.setattr(pl, "pallas_call",
                            lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    return request.param


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_cols_close(got, want, msg, rel=REL):
    """Per column, |got - want| <= rel * (RMS of the column + 1)."""
    g = np.asarray(got, np.float64).reshape(len(want), -1)
    w = np.asarray(want, np.float64).reshape(len(want), -1)
    if not len(w):
        return
    bound = rel * (np.sqrt((w ** 2).mean(axis=0)) + 1.0)
    err = np.abs(g - w)
    assert (err <= bound).all(), f"{msg}: worst {err.max():.3e}, bound {bound.min():.3e}"


def angle_cols(env):
    """The obs columns that are AO or TA: 11-12 of the 1v1 obs, offsets 2-3
    of each 7-dim block after the team obs' 9 ego dims."""
    if env.num_observation == 15:
        return np.array([11, 12])
    starts = 9 + 7 * np.arange((env.num_observation - 9) // 7)
    return np.concatenate([starts + 2, starts + 3])


_PAIRS = {}


def make_pair(jcls, cls, num_envs, config, **overrides):
    """A JAX env and the port's on one config, kept for the module per
    backend so that the JAX step compiles once."""
    key = (jcls, num_envs, config, tuple(sorted(overrides.items())),
           os.environ.get("NEURALPLANE_AERO_BACKEND"))
    if key not in _PAIRS:
        jcfg = dataclasses.replace(j_load_config(config), **overrides)
        cfg = load_config(config, **overrides)
        _PAIRS[key] = jcls(num_envs, jcfg), cls(num_envs, cfg, device="cpu")
    return _PAIRS[key]


def run_chain(jenv, env, jstate, steps, flagged_group=None, seed=0, resync=True):
    """Carry jstate into the port and step both sides `steps` times on the
    same actions (with `resync`, each step from the JAX state carried
    across again); compare the groups that no reset touched."""
    rng = np.random.default_rng(seed)
    E, M = env.num_envs, env.num_agents
    if flagged_group is not None:
        bad = np.zeros(env.n, bool)
        bad[flagged_group * M] = True
        jstate = jstate.replace(bad_done=jnp.asarray(bad))
    env.reset(0)   # seeds the port's generator
    state = env.state_from_jax(to_np(jstate))
    same = np.ones(E, bool)
    outs = []
    for k in range(steps):
        flags = np.asarray(jstate.is_done | jstate.bad_done | jstate.exceed_time_limit)
        same &= ~flags.reshape(E, M).any(axis=1)
        act = rng.uniform(-1.2, 1.2, (env.n, 4)).astype(np.float32)
        if resync and k:
            state = env.state_from_jax(to_np(jstate))
        jstate, jout = jenv.step(jstate, jnp.asarray(act))
        state, out = env.step(state, torch.from_numpy(act))
        rows = np.repeat(same, M)
        ang = np.zeros(env.num_observation, bool)
        ang[angle_cols(env)] = True
        obs, jobs = out.obs.numpy()[rows], np.asarray(jout.obs)[rows]
        for name, g, w in (("s", state.model.s.numpy()[rows], jstate.model.s[rows]),
                           ("u", state.model.u.numpy()[rows], jstate.model.u[rows]),
                           ("obs", obs[:, ~ang], jobs[:, ~ang]),
                           ("reward", out.reward.numpy()[rows], jout.reward[rows])):
            assert_cols_close(g, np.asarray(w), f"step {k} {name}",
                              REL if resync else CHAIN_REL)
        np.testing.assert_allclose(obs[:, ang], jobs[:, ang], rtol=0, atol=ANGLE_ATOL,
                                   err_msg=f"step {k} AO, TA")
        np.testing.assert_allclose(state.blood.numpy()[rows], np.asarray(jstate.blood)[rows],
                                   atol=1e-4, err_msg=f"step {k} blood")
        for name in ("done", "bad_done", "exceed_time_limit"):
            np.testing.assert_array_equal(getattr(out, name).numpy()[rows],
                                          np.asarray(getattr(jout, name))[rows],
                                          err_msg=f"step {k} {name}")
        np.testing.assert_array_equal(state.step_count.numpy()[rows],
                                      np.asarray(jstate.step_count)[rows])
        if jout.active is not None:
            np.testing.assert_array_equal(out.active.numpy()[rows],
                                          np.asarray(jout.active)[rows])
        if same.all():
            assert {k_: int(v) for k_, v in out.info.items()} == \
                {k_: int(v) for k_, v in jout.info.items()}, f"step {k} info"
        outs.append((state, out, jstate, jout, same.copy()))
    return outs


def test_single_combat_chained_steps(backend):
    """Three 1v1 steps without flags, one group dying of low blood (shutdown)
    and one timing out, so the counts are not all zero."""
    jenv, env = make_pair(JaxSingle, SingleCombatEnv, 4, "selfplay")
    jstate, _ = jenv.reset(jax.random.PRNGKey(1))
    blood = np.full(env.n, 100.0, np.float32)
    blood[2] = -1.0                            # group 1's ego is dead: shutdown
    sc = np.zeros(env.n, np.int32)
    sc[4:6] = jenv.config.max_steps - 1        # group 2 times out at the first step
    jstate = jstate.replace(blood=jnp.asarray(blood), step_count=jnp.asarray(sc))
    outs = run_chain(jenv, env, jstate, steps=3)
    info = outs[0][1].info
    assert int(info["termination/shutdown"]) == 2 and int(info["termination/timeout"]) == 2
    assert outs[-1][4].sum() == 2              # groups 1 and 2 reset after step 0


def test_free_chain(backend):
    """Three 1v1 steps, each side carrying its own state."""
    jenv, env = make_pair(JaxSingle, SingleCombatEnv, 4, "selfplay")
    jstate, _ = jenv.reset(jax.random.PRNGKey(3))
    run_chain(jenv, env, jstate, steps=3, resync=False)


def test_single_combat_masked_reset(backend):
    """A flagged group resets on both sides (different draws): full blood,
    step count 1, the controller's rows zeroed, its latches kept; the other
    groups stay in step with JAX."""
    jenv, env = make_pair(JaxSingle, SingleCombatEnv, 4, "selfplay")
    jstate, _ = jenv.reset(jax.random.PRNGKey(2))
    jstate = jstate.replace(blood=jstate.blood - 30.0)
    (state, out, jstate, jout, same), = run_chain(jenv, env, jstate, steps=1, flagged_group=1)
    assert list(same) == [True, False, True, True]
    np.testing.assert_allclose(state.blood.numpy()[2:4], 100.0, atol=2.0)
    assert (state.step_count.numpy()[2:4] == 1).all()
    assert bool(state.controller.roll_ctl.pid.initialized)
    s = state.model.s.numpy()[2:4]
    cfg = env.config
    assert ((s[:, 2] > cfg.min_altitude - 100) & (s[:, 2] < cfg.max_altitude + 100)).all()


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("planar", [False, True])
def test_pair_geometry_and_side_flag(symmetric, planar):
    """AO, TA, R and the side flag of every agent against its opponent,
    both side-flag conventions, planar and 3-D; one pair flies exactly
    parallel and level (an exact-zero cross product: sign 0 on both sides)."""
    jenv, env = make_pair(JaxSingle, SingleCombatEnv, 5, "selfplay",
                          symmetric_side_flag=symmetric)
    rng = np.random.default_rng(3)
    s = np.zeros((env.n, 12), np.float32)
    s[:, :3] = rng.uniform(-5000, 5000, (env.n, 3)) + [0, 0, 20000]
    xdot = rng.uniform(-900, 900, (env.n, 12)).astype(np.float32)
    s[8:10, :3] = [[0, 0, 20000], [3000, 0, 20000]]
    xdot[8:10, :3] = [[800, 0, 0], [800, 0, 0]]
    jst = jenv.init_state(jax.random.PRNGKey(0))
    jst = jst.replace(model=jst.model.replace(s=jnp.asarray(s)))
    want = jenv._pair_geometry(jst, jnp.asarray(xdot), planar=planar)
    mstate = env.init_state().model
    mstate.s = torch.from_numpy(s)
    got = env._pair_geometry(mstate, torch.from_numpy(xdot), planar=planar)
    for name, g, w in zip(("AO", "TA", "R"), got, want):
        assert_cols_close(g.numpy(), np.asarray(w), name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[3][8] == 0 and got[3][9] == 0


def team_envs(h, num_envs=3, **overrides):
    config = "multiple_selfplay" if h == 2 else "multiple_selfplay_3v3"
    if h not in (2, 3):
        overrides = {"num_agents": 2 * h, **overrides}
    return make_pair(JaxMulti, MultipleCombatEnv, num_envs, config, **overrides)


def random_group_geometry(E, m, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-8000, 8000, (E, m, 3)).astype(np.float32) + np.float32([0, 0, 20000])
    vel = rng.uniform(-900, 900, (E, m, 3)).astype(np.float32)
    return pos, vel


@pytest.mark.parametrize("h", [2, 3])
def test_all_pairs_geometry(h):
    """[E, m, m] all-pairs geometry against the JAX pass and against the
    pairwise helper get_AO_TA_R on every (i, j)."""
    jenv, env = team_envs(h)
    pos, vel = random_group_geometry(3, 2 * h, 4)
    got = env._all_pairs_both(torch.from_numpy(pos), torch.from_numpy(vel))
    want = jenv._all_pairs_both(jnp.asarray(pos), jnp.asarray(vel))
    for (gp, wp), tag in zip(zip(got, want), ("planar", "3-D")):
        for i, (g, w) in enumerate(zip(gp, wp)):
            if i == 3:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                assert_cols_close(g.numpy().reshape(-1), np.asarray(w).reshape(-1),
                                  f"{tag} {i}")
    E, m = pos.shape[:2]
    p = torch.from_numpy(pos).reshape(E, m, 1, 3).expand(E, m, m, 3).reshape(-1, 3)
    q = torch.from_numpy(pos).reshape(E, 1, m, 3).expand(E, m, m, 3).reshape(-1, 3)
    v = torch.from_numpy(vel).reshape(E, m, 1, 3).expand(E, m, m, 3).reshape(-1, 3)
    w = torch.from_numpy(vel).reshape(E, 1, m, 3).expand(E, m, m, 3).reshape(-1, 3)
    off = ~torch.eye(m, dtype=torch.bool).expand(E, m, m).reshape(-1)
    AO, TA, R = get_AO_TA_R(p, q, v, w)
    for g, want_pair, name in zip(got[1], (AO, TA, R), ("AO", "TA", "R")):
        assert_cols_close(g.reshape(-1)[off].numpy(), want_pair[off].numpy(), name)


@pytest.mark.parametrize("h", [2, 3, 5])
def test_nearest_enemy_perm_ties_and_dead(h):
    """Exact order and keys, with tied ranges and dead enemies (+inf keys,
    which tie too): the compare-exchange network (h <= 4) and the stable
    sort (h = 5) against the JAX package's."""
    E, m = 6, 2 * h
    jenv, env = team_envs(h, num_envs=E)
    rng = np.random.default_rng(5)
    R = rng.choice(np.float32([1000, 2000, 3000]), (E, m, m))   # many ties
    alive = rng.random((E, m)) < 0.6
    alive[0] = True
    alive[1, h:] = False                                        # a whole team dead
    got = env._nearest_enemy_perm(torch.from_numpy(R), torch.from_numpy(alive))
    want = jenv._nearest_enemy_perm(jnp.asarray(R), jnp.asarray(alive))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.isinf(got[1][1, :h].numpy()).all()


@pytest.mark.parametrize("h", [2, 3])
def test_team_obs_layout(h):
    """The team obs after the reset: 9 ego dims + 7 per teammate + 7 per
    enemy, and equal to the JAX package's on the carried state, with some
    agents dead (their blocks zeroed, alive = 0)."""
    jenv, env = team_envs(h)
    assert env.num_observation == jenv.num_observation == 9 + 7 * (h - 1) + 7 * h
    jstate, _ = jenv.reset(jax.random.PRNGKey(6))
    blood = np.full(env.n, 100.0, np.float32)
    blood[[1, 2 * h + h]] = -5.0
    jstate = jstate.replace(blood=jnp.asarray(blood))
    env.reset(0)
    state = env.state_from_jax(to_np(jstate))
    xdot = jenv.model.extended_state(jstate.model)
    want = np.asarray(jenv._obs(jstate, xdot))
    got = env._obs(state, torch.from_numpy(np.array(xdot))).numpy()
    assert got.shape == (env.n, env.num_observation)
    ang = np.zeros(env.num_observation, bool)
    ang[angle_cols(env)] = True
    assert_cols_close(got[:, ~ang], want[:, ~ang], "team obs")
    np.testing.assert_allclose(got[:, ang], want[:, ang], rtol=0, atol=ANGLE_ATOL)
    # agent 0's teammate block for the dead agent 1 is zeroed with alive = 0
    np.testing.assert_array_equal(got[0, 9:16], 0.0)


def test_team_damage_wipe_and_freezing(backend):
    """2v2, one chained step from a staged state: in group 0 ego agent 0
    flies at enemy 3 (blood 0.5) from 2000 ft behind, enemy 2 is already
    dead; the hit wipes the enemy team (+-200 event rewards, shutdown done
    and bad), the dead agent stays frozen. Other groups fly on as drawn."""
    jenv, env = team_envs(2)
    jstate, _ = jenv.reset(jax.random.PRNGKey(7))
    s = np.array(jstate.model.s)
    s[0:4, :3] = [[0, 0, 20000], [0, 20000, 20000], [0, -20000, 21000], [2000, 0, 20000]]
    s[0:4, 3:6] = 0.0
    s[0:4, 6] = 1000.0
    blood = np.full(env.n, 100.0, np.float32)
    blood[2], blood[3] = -1.0, 0.5
    jstate = jstate.replace(model=jstate.model.replace(s=jnp.asarray(s)),
                            blood=jnp.asarray(blood))
    (state, out, jstate2, jout, same), = run_chain(jenv, env, jstate, steps=1)
    assert same.all()
    np.testing.assert_array_equal(state.model.s.numpy()[2], s[2])       # frozen corpse
    np.testing.assert_array_equal(out.active.numpy()[:4], [1, 1, 0, 0])
    r = out.reward.numpy()[:4]
    assert r[0] > 150 and r[1] > 150 and r[2] < -150 and r[3] < -150
    np.testing.assert_array_equal(out.done.numpy()[:4], [True, True, False, False])
    np.testing.assert_array_equal(out.bad_done.numpy()[:4], [False, False, True, True])
    assert int(out.info["termination/shutdown"]) == 4


def test_team_chained_steps(backend):
    """Three 2v2 steps on random actions, one group flagged for reset."""
    jenv, env = team_envs(2)
    jstate, _ = jenv.reset(jax.random.PRNGKey(8))
    outs = run_chain(jenv, env, jstate, steps=3, flagged_group=2, seed=1)
    assert list(outs[-1][4]) == [True, True, False]


def test_step_needs_reset_first():
    env = SingleCombatEnv(1, device="cpu")
    with pytest.raises(RuntimeError, match="reset"):
        env.step(env.init_state(), torch.zeros(env.n, 4))
