"""The port's missiles (ops/missile.py) and missile combat envs
(envs/combat_shoot.py) against the JAX package's on the CPU (oracle:
tests/test_shoot_combat.py).

Missile functions: the same numpy inputs through both packages, both fuse
modes, targets per shooter and per slot, the g-limit clamp (and the
unguided g_max = 0 corner), launch slots and clear: positions, velocities,
ages and pk within 1e-5 of each column's RMS + 1, flags exactly.

Envs: a JAX state staged with both sides nose-on inside the WEZ and a
missile of each group's ego already closing on its target (head-on in
group 0, 250 ft abeam in group 1, so the graded fuse gives a partial pk),
carried into the port with `state_from_jax`; then chained steps on the same
numpy ShootTuple actions, the shoot bit set on 60% of rows, each step from
the JAX state carried across again (the tolerances of
tests/test_torch_combat.py: model state, obs and reward per column within
1e-4 of RMS + 1, AO / TA 1e-3 rad, blood 1e-4). Missile positions,
velocities and ages per column within 1e-4 of RMS + 1; ammo, cooldown,
active slots, locks, flags and the launch and hit counts exactly; pk_sum
exactly under the binary fuse (pk is 0 or 1) and within 1e-5 under the
graded one (a ramp of the miss distance). Both aero backends on the 1v1
and 2v2 games ("distilled": the JAX xdot kernel in interpret mode against
the port's plain version); "stacked" for the evadable variants and the
staged single-step checks (WEZ gate, locks, dead shooters, masked reset).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from neuralplane_tpu.envs import MultipleCombatShootEnv as JTeam
from neuralplane_tpu.envs import SingleCombatShootEnv as JSingle
from neuralplane_tpu.ops import missile as jm
from neuralplane_tpu.utils.config import load_config as j_load_config
from neuralplane_tpu_torch.envs import MultipleCombatShootEnv, SingleCombatShootEnv
from neuralplane_tpu_torch.ops import missile as tm
from neuralplane_tpu_torch.utils.config import load_config

REL = 1e-4
ANGLE_ATOL = 1e-3


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


# ------------------------------------------------------------------ missiles

KW = dict(dt=0.1, speed=2000.0, nav_gain=3.0, g_max=12.0, duration=20.0, hit_radius=200.0)


def missile_inputs(n=64, K=4, seed=0):
    """Missiles around their targets: some inside the kill radius, some on
    the ramp, some far; a quarter of the slots inactive, one at age ~
    duration; velocities at cruise speed."""
    rng = np.random.default_rng(seed)
    f = np.float32
    tpos = rng.uniform(-5e4, 5e4, (n, 3)).astype(f)
    tvel = rng.normal(0, 600, (n, 3)).astype(f)
    off = rng.normal(0, 1, (n, K, 3))
    off *= (rng.choice([80.0, 250.0, 600.0, 5000.0], (n, K, 1)) / np.linalg.norm(off, axis=-1,
                                                                                 keepdims=True))
    pos = (tpos[:, None] - off).astype(f)
    vel = rng.normal(0, 1, (n, K, 3))
    vel = (2000.0 * vel / np.linalg.norm(vel, axis=-1, keepdims=True)).astype(f)
    vel[: n // 2] = (2000.0 * off[: n // 2] / np.linalg.norm(off[: n // 2], axis=-1,
                                                             keepdims=True)).astype(f)
    active = rng.random((n, K)) < 0.75
    age = rng.uniform(0, 20.0, (n, K)).astype(f)
    age[0, 0], active[0, 0] = 19.95, True
    return (dict(pos=pos, vel=vel, active=active, age=age), tpos, tvel,
            rng.normal(0, 600, (n, K, 3)).astype(f))


def both_states(arrs):
    return (jm.MissileState(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            tm.MissileState(**{k: torch.from_numpy(np.array(v)) for k, v in arrs.items()}))


def assert_missiles_close(got, want, msg=""):
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active), err_msg=msg)
    for name in ("pos", "vel", "age"):
        assert_cols_close(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                          f"{msg} {name}", rel=1e-5)


@pytest.mark.parametrize("per_slot", [False, True], ids=["per-shooter", "per-slot"])
@pytest.mark.parametrize("fuse_outer,g_max", [(0.0, 12.0), (400.0, 5.0), (0.0, 0.0),
                                              (400.0, 60.0)],
                         ids=["binary", "graded", "unguided", "graded-high-g"])
def test_step_missiles_matches_jax(fuse_outer, g_max, per_slot):
    """One step of every slot; the 5 g and unguided cases clamp (or zero)
    the PN acceleration on most rows, the 60 g case on few."""
    arrs, tpos, tvel, slot_vel = missile_inputs()
    if per_slot:
        tpos = np.repeat(tpos[:, None], arrs["pos"].shape[1], axis=1)
        tvel = slot_vel
    kw = {**KW, "g_max": g_max, "fuse_outer": fuse_outer, **(
        {"hit_radius": 100.0} if fuse_outer else {})}
    js, ts = both_states(arrs)
    jn, jhits, jpk = jm.step_missiles(js, jnp.asarray(tpos), jnp.asarray(tvel), **kw)
    tn, hits, pk = tm.step_missiles(ts, torch.from_numpy(tpos), torch.from_numpy(tvel), **kw)
    assert_missiles_close(tn, jn)
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jhits))
    np.testing.assert_allclose(pk.numpy(), np.asarray(jpk), rtol=0, atol=1e-5)
    assert hits.any() and (~hits & ts.active).any()
    if fuse_outer:
        assert ((pk > 0.01) & (pk < 0.99)).any()   # some partial kills on the ramp
    a_max = g_max * tm.G0_FTPS2 * KW["dt"] + 1e-2
    dv = (tn.vel - ts.vel).norm(dim=-1)[ts.active & ~hits]
    assert float(dv.max()) <= max(a_max, 1e-2) + 2000.0 * 1e-3


def test_segment_min_dist_matches_jax_and_brute_force():
    rng = np.random.default_rng(1)
    rel_pos = (rng.normal(size=(64, 3)) * 1000.0).astype(np.float32)
    rel_vel = (rng.normal(size=(64, 3)) * 500.0).astype(np.float32)
    got = tm.segment_min_dist(torch.from_numpy(rel_pos), torch.from_numpy(rel_vel), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.segment_min_dist(
        jnp.asarray(rel_pos), jnp.asarray(rel_vel), 0.1)), rtol=1e-5, atol=1e-3)
    ts = np.linspace(0.0, 0.1, 2001)
    brute = np.linalg.norm(rel_pos[:, None] + ts[None, :, None] * rel_vel[:, None],
                           axis=-1).min(axis=1)
    np.testing.assert_allclose(got.numpy(), brute, rtol=1e-4, atol=0.5)


def test_launch_slots_and_clear_match_jax():
    """Slot by slot, some shooters firing, one standing still (launches
    north); then a masked clear."""
    n, K = 6, 3
    rng = np.random.default_rng(2)
    arrs = {k: v[:n, :K] for k, v in missile_inputs(n=n, K=K, seed=2)[0].items()}
    arrs["active"][:] = False
    js, ts = both_states(arrs)
    pos = rng.uniform(-1e4, 1e4, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 800, (n, 3)).astype(np.float32)
    vel[3] = 0.0
    for slot in range(K):
        fire = rng.random(n) < 0.7
        fire[3] = True
        sl = np.full(n, slot, np.int32)
        js = jm.launch_missiles(js, jnp.asarray(sl), jnp.asarray(fire), jnp.asarray(pos),
                                jnp.asarray(vel), speed=2000.0)
        ts = tm.launch_missiles(ts, torch.from_numpy(sl), torch.from_numpy(fire),
                                torch.from_numpy(pos), torch.from_numpy(vel), speed=2000.0)
        assert_missiles_close(ts, js, f"slot {slot}")
    np.testing.assert_allclose(ts.vel[3].numpy(), [[2000.0, 0.0, 0.0]] * K)
    mask = np.array([True, False, True, False, False, True])
    jc = jm.clear_missiles(js, jnp.asarray(mask))
    tc = tm.clear_missiles(ts, torch.from_numpy(mask))
    np.testing.assert_array_equal(tc.active.numpy(), np.asarray(jc.active))
    assert not tc.active[mask].any() and tc.active[~mask].any()


# ---------------------------------------------------------------------- envs

@pytest.fixture(params=["stacked", "distilled"])
def backend(request, monkeypatch):
    monkeypatch.setenv("NEURALPLANE_AERO_BACKEND", request.param)
    if request.param == "distilled":
        orig = pl.pallas_call
        monkeypatch.setattr(pl, "pallas_call",
                            lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    return request.param


@pytest.fixture
def stacked(monkeypatch):
    monkeypatch.setenv("NEURALPLANE_AERO_BACKEND", "stacked")


_PAIRS = {}


def make_pair(config, num_envs, **overrides):
    """A JAX env and the port's on one scenario, kept for the module per
    backend so that the JAX step compiles once."""
    key = (config, num_envs, tuple(sorted(overrides.items())),
           os.environ.get("NEURALPLANE_AERO_BACKEND"))
    if key not in _PAIRS:
        jcls, cls = (JTeam, MultipleCombatShootEnv) if "multiple" in config else \
            (JSingle, SingleCombatShootEnv)
        jcfg = dataclasses.replace(j_load_config(config), **overrides)
        _PAIRS[key] = jcls(num_envs, jcfg), cls(num_envs, load_config(config, **overrides),
                                                 device="cpu")
    return _PAIRS[key]


def nose_on(env, state, rng_ft=12000.0, lateral=5000.0, groups=None):
    """Every pairing (ego k, enemy k) of the groups nose-on inside the WEZ:
    ego northbound at the origin row, its enemy southbound rng_ft ahead."""
    m, h = env.num_agents, env.num_agents // 2
    s = np.array(state.model.s)
    for e in (range(env.num_envs) if groups is None else groups):
        for k in range(h):
            i, j = e * m + k, e * m + h + k
            s[i, :3] = [0.0, k * lateral, 19500.0]
            s[j, :3] = [rng_ft, k * lateral, 19500.0]
            s[i, 5], s[j, 5] = 0.0, np.pi
            s[i, 6] = s[j, 6] = 1000.0
            s[i, 3] = s[i, 4] = s[j, 3] = s[j, 4] = 0.0
    sj = jnp.asarray(s)
    return state.replace(model=state.model.replace(s=sj, recent_s=sj))


def stage_missiles(env, state, offsets=(0.0, 250.0)):
    """Group g's ego (agent 0 of the group) has a missile in its last slot,
    flying north at cruise speed, `offsets[g]` ft abeam of its enemy (agent
    h of the group, southbound at 1000 ft/s) and half a step's closure short
    of it, so that the closest approach falls inside the next step; locked
    on that enemy in the team game."""
    m, h, K = env.num_agents, env.num_agents // 2, env.config.max_missiles
    mis = to_np(state.missiles)
    pos, vel, act, age = (np.array(a) for a in (mis.pos, mis.vel, mis.active, mis.age))
    s = np.asarray(state.model.s)
    short = 0.5 * (env.config.missile_speed + 1000.0) * env.inner_steps * env.config.dt
    extra = {}
    tgt = np.array(state.missile_target) if hasattr(state, "missile_target") else None
    for g, off in enumerate(offsets):
        i, j = g * m, g * m + h
        pos[i, K - 1] = s[j, :3] - np.float32([short, -off, 0.0])
        vel[i, K - 1] = [env.config.missile_speed, 0.0, 0.0]
        act[i, K - 1], age[i, K - 1] = True, 1.0
        if tgt is not None:
            tgt[i, K - 1] = h
    if tgt is not None:
        extra["missile_target"] = jnp.asarray(tgt)
    return state.replace(missiles=jm.MissileState(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel), active=jnp.asarray(act),
        age=jnp.asarray(age)), **extra)


def angle_cols(env):
    """AO and TA columns: 11-12 of the 1v1 obs; offsets 2-3 of each 7-dim
    block after the team obs' 9 ego dims."""
    if env.num_agents == 2:
        return np.array([11, 12])
    starts = 9 + 7 * np.arange(2 * env.half - 1)
    return np.concatenate([starts + 2, starts + 3])


def shoot_actions(env, rng, fire_share=0.6, fire=None):
    nvec = np.asarray(env.action_space.nvec)
    idx = rng.integers(0, nvec, (env.n, 4))
    bits = rng.random(env.n) < fire_share if fire is None else fire
    return np.concatenate([idx, bits[:, None]], axis=1).astype(np.float32)


def run_shoot_chain(jenv, env, jstate, steps, seed=0, flagged_group=None, fire=None):
    """Carry jstate into the port and step both sides `steps` times on the
    same actions, each step from the JAX state carried across again; compare
    the groups that no reset touched. Returns [(state, out, jstate, jout,
    same)] per step."""
    rng = np.random.default_rng(seed)
    E, M = env.num_envs, env.num_agents
    if flagged_group is not None:
        done = np.zeros(env.n, bool)
        done[flagged_group * M] = True
        jstate = jstate.replace(is_done=jnp.asarray(done))
    env.reset(0)   # seeds the port's generator
    graded = env.config.missile_fuse_outer > 0.0
    same = np.ones(E, bool)
    ang = np.zeros(env.num_observation, bool)
    ang[angle_cols(env)] = True
    outs = []
    for k in range(steps):
        flags = np.asarray(jstate.is_done | jstate.bad_done | jstate.exceed_time_limit)
        same &= ~flags.reshape(E, M).any(axis=1)
        act = shoot_actions(env, rng, fire=fire)
        state = env.state_from_jax(to_np(jstate))
        jstate, jout = jenv.step(jstate, jnp.asarray(act))
        state, out = env.step(state, torch.from_numpy(act))
        rows = np.repeat(same, M)
        obs, jobs = out.obs.numpy()[rows], np.asarray(jout.obs)[rows]
        for name, g, w in (("s", state.model.s.numpy(), jstate.model.s),
                           ("u", state.model.u.numpy(), jstate.model.u),
                           ("reward", out.reward.numpy(), jout.reward),
                           ("missile pos", state.missiles.pos.numpy(), jstate.missiles.pos),
                           ("missile vel", state.missiles.vel.numpy(), jstate.missiles.vel),
                           ("missile age", state.missiles.age.numpy(), jstate.missiles.age)):
            assert_cols_close(g[rows], np.asarray(w)[rows], f"step {k} {name}")
        assert_cols_close(obs[:, ~ang], jobs[:, ~ang], f"step {k} obs")
        np.testing.assert_allclose(obs[:, ang], jobs[:, ang], rtol=0, atol=ANGLE_ATOL,
                                   err_msg=f"step {k} AO, TA")
        np.testing.assert_allclose(state.blood.numpy()[rows], np.asarray(jstate.blood)[rows],
                                   atol=1e-4, err_msg=f"step {k} blood")
        exact = [("ammo", state.ammo, jstate.ammo), ("cooldown", state.cooldown, jstate.cooldown),
                 ("active", state.missiles.active, jstate.missiles.active),
                 ("step_count", state.step_count, jstate.step_count),
                 ("done", out.done, jout.done), ("bad_done", out.bad_done, jout.bad_done),
                 ("exceed", out.exceed_time_limit, jout.exceed_time_limit),
                 ("fire_vec", out.info["shoot/fire_vec"], jout.info["shoot/fire_vec"])]
        if hasattr(state, "missile_target"):
            exact += [("missile_target", state.missile_target, jstate.missile_target),
                      ("active agents", out.active, jout.active)]
        for name, g, w in exact:
            np.testing.assert_array_equal(g.numpy()[rows], np.asarray(w)[rows],
                                          err_msg=f"step {k} {name}")
        np.testing.assert_allclose(out.info["shoot/pk_dealt_vec"].numpy()[rows],
                                   np.asarray(jout.info["shoot/pk_dealt_vec"])[rows],
                                   rtol=0, atol=1e-5)
        if same.all():
            counts = {k_: v for k_, v in out.info.items() if not k_.endswith("_vec")}
            pk = counts.pop("shoot/pk_sum")
            want = {k_: v for k_, v in jout.info.items() if not k_.endswith("_vec")}
            jpk = want.pop("shoot/pk_sum")
            assert {k_: int(v) for k_, v in counts.items()} == \
                {k_: int(v) for k_, v in want.items()}, f"step {k} info"
            if graded:
                assert float(pk) == pytest.approx(float(jpk), abs=1e-5)
            else:
                assert float(pk) == float(jpk)
        outs.append((state, out, jstate, jout, same.copy()))
    return outs


def staged(config, num_envs, seed, **overrides):
    jenv, env = make_pair(config, num_envs, **overrides)
    jstate, _ = jenv.reset(jax.random.PRNGKey(seed))
    return jenv, env, stage_missiles(env, nose_on(env, jstate, groups=(0, 1)))


@pytest.mark.parametrize("config", ["selfplay_shoot", "multiple_selfplay_shoot"])
def test_chained_steps(backend, config):
    """Three steps: launches at step 0 (groups 0 and 1 nose-on in the WEZ,
    the bit on 60% of rows), a hit from group 0's staged missile (group 1's
    passes 250 ft abeam, outside the binary fuse's 200 ft), missiles in the
    air after; the hit deals 100 blood, so its victim's group ends (1v1) or
    the victim dies (2v2)."""
    jenv, env, jstate = staged(config, 3, seed=1)
    outs = run_shoot_chain(jenv, env, jstate, steps=3)
    info = outs[0][1].info
    assert int(info["shoot/launches"]) > 0 and int(info["shoot/hits"]) == 1
    assert float(info["shoot/pk_sum"]) == 1.0
    assert int(outs[-1][0].missiles.active.sum()) > 0


@pytest.mark.parametrize("config", ["selfplay_shoot_evadable",
                                    "multiple_selfplay_shoot_evadable"])
def test_chained_steps_evadable(stacked, config):
    """The evadable variants (graded fuse, threat obs): the head-on staged
    missile detonates with pk 1, the abeam one with a partial pk."""
    jenv, env, jstate = staged(config, 3, seed=2)
    assert env.num_observation == jenv.num_observation
    outs = run_shoot_chain(jenv, env, jstate, steps=3, seed=1)
    pk = outs[0][1].info["shoot/pk_dealt_vec"].numpy()
    m = env.num_agents
    assert pk[0] == pytest.approx(1.0) and 0.05 < pk[m] < 0.95
    assert np.abs(outs[0][1].obs.numpy()[:, -3:]).sum() > 0   # threat block live


def test_masked_reset_restores_missile_state(stacked):
    """A group flagged done after a volley rearms on the next step: full
    ammo, no cooldown, no missile in the air, no lock; the other groups stay
    in step with JAX."""
    jenv, env, jstate = staged("multiple_selfplay_shoot", 3, seed=3)
    fire = np.ones(env.n, bool)
    (_, _, jstate, _, _), = run_shoot_chain(jenv, env, jstate, steps=1, fire=fire)
    assert int(np.asarray(jstate.ammo)[4]) < env.config.max_missiles
    outs = run_shoot_chain(jenv, env, jstate, steps=1, flagged_group=1,
                           fire=np.zeros(env.n, bool))
    state, _, _, _, same = outs[0]
    assert list(same) == [True, False, True]
    g = slice(4, 8)
    assert (state.ammo[g] == env.config.max_missiles).all()
    assert (state.cooldown[g] == 0.0).all() and not state.missiles.active[g].any()
    assert (state.missile_target[g] == 0).all()


@pytest.mark.parametrize("case", ["trail", "out_of_range"])
def test_wez_gate(stacked, case):
    """Trail (both northbound: only the chaser has the target in its cone)
    launches one per group; nose-on beyond wez_max_range launches none.
    Both packages agree step for step."""
    jenv, env = make_pair("selfplay_shoot", 4)
    jstate, _ = jenv.reset(jax.random.PRNGKey(7))
    if case == "trail":
        jstate = nose_on(env, jstate)
        s = np.array(jstate.model.s)
        s[1::2, 5] = 0.0
        jstate = jstate.replace(model=jstate.model.replace(s=jnp.asarray(s),
                                                           recent_s=jnp.asarray(s)))
    else:
        jstate = nose_on(env, jstate, rng_ft=30000.0)
    (state, out, *_), = run_shoot_chain(jenv, env, jstate, steps=1,
                                        fire=np.ones(env.n, bool))
    want = env.num_envs if case == "trail" else 0
    assert int(out.info["shoot/launches"]) == want
    if case == "trail":
        np.testing.assert_array_equal(out.info["shoot/fire_vec"].numpy(), [1, 0] * 4)


def lock_stage(env, jstate, enemy2_alive=True):
    """Group 0: ego 0 northbound at the origin, its wingman 3000 ft behind,
    enemy 2 head-on at 12,000 ft, enemy 3 head-on at 16,000 ft."""
    s = np.array(jstate.model.s)
    for i, (npos, head) in enumerate([(0.0, 0.0), (-3000.0, 0.0), (12000.0, np.pi),
                                      (16000.0, np.pi)]):
        s[i, :3] = [npos, 0.0, 19500.0]
        s[i, 5], s[i, 6] = head, 1000.0
        s[i, 3] = s[i, 4] = 0.0
    blood = np.array(jstate.blood)
    if not enemy2_alive:
        blood[2] = 0.0
    sj = jnp.asarray(s)
    return jstate.replace(model=jstate.model.replace(s=sj, recent_s=sj),
                          blood=jnp.asarray(blood))


@pytest.mark.parametrize("enemy2_alive", [True, False])
def test_team_locks_the_nearest_alive_enemy(stacked, enemy2_alive):
    """Agent 0 fires: its missile locks enemy 2, the nearer, or enemy 3 when
    2 is dead; the same lock, slot and ammo as JAX."""
    jenv, env = make_pair("multiple_selfplay_shoot", 2)
    jstate, _ = jenv.reset(jax.random.PRNGKey(1))
    jstate = lock_stage(env, jstate, enemy2_alive)
    fire = np.zeros(env.n, bool)
    fire[0] = True
    (state, out, *_), = run_shoot_chain(jenv, env, jstate, steps=1, fire=fire)
    assert int(out.info["shoot/launches"]) == 1
    assert int(state.missile_target[0, 0]) == (2 if enemy2_alive else 3)
    assert bool(state.missiles.active[0, 0]) and int(state.ammo[0]) == 3


def test_team_dead_cannot_fire_and_corpses_take_nothing(stacked):
    """Everyone nose-on and firing with agent 0 of every group dead: n - E
    launches. A missile 100 ft from a dead victim connects for nothing."""
    jenv, env = make_pair("multiple_selfplay_shoot", 2)
    jstate, _ = jenv.reset(jax.random.PRNGKey(2))
    jstate = nose_on(env, jstate)
    blood = np.array(jstate.blood)
    blood[0::env.num_agents] = 0.0
    jstate = jstate.replace(blood=jnp.asarray(blood))
    (_, out, *_), = run_shoot_chain(jenv, env, jstate, steps=1, fire=np.ones(env.n, bool))
    assert int(out.info["shoot/launches"]) == env.n - env.num_envs

    jstate, _ = jenv.reset(jax.random.PRNGKey(3))
    jstate = stage_missiles(env, nose_on(env, jstate), offsets=(0.0, 0.0))
    blood = np.array(jstate.blood)
    blood[2] = 0.0                                   # group 0's victim is a corpse
    jstate = jstate.replace(blood=jnp.asarray(blood))
    (state, out, *_), = run_shoot_chain(jenv, env, jstate, steps=1,
                                        fire=np.zeros(env.n, bool))
    assert int(out.info["shoot/hits"]) == 1          # group 1's only
    assert float(state.blood[2]) == 0.0 and float(out.info["shoot/pk_dealt_vec"][0]) == 0.0


@pytest.mark.parametrize("config,slots", [("selfplay_shoot", (11, 13)),
                                          ("multiple_selfplay_shoot", (18, 20)),
                                          ("multiple_selfplay_shoot_3v3", (25, 27))])
def test_shoot_prior_slots(config, slots):
    """The AO / R slots of the Beta launch prior: the 1v1 layout's 11 / 13,
    the team layout's nearest-enemy block; equal to the JAX envs'."""
    jenv, env = make_pair(config, 1)
    assert env.shoot_prior_slots == tuple(jenv.shoot_prior_slots) == slots
    assert env.num_observation == jenv.num_observation
    assert env.action_space.nvec == jenv.action_space.nvec == (30, 41, 41, 41)


def test_decode_bins():
    env = SingleCombatShootEnv(1, device="cpu")
    demands, fire = env._decode(torch.tensor([[0.0, 0.0, 40.0, 20.0, 0.0],
                                              [29.4, 45.0, -3.0, 20.5, 1.0]]))
    np.testing.assert_allclose(demands.numpy(), [[-1, -1, 1, 0], [1, 1, -1, 0]], atol=1e-6)
    assert fire.tolist() == [False, True]


def test_committed_policy_fires_as_jax_along_its_trajectory(stacked, tmp_path):
    """results/shoot_1v1 flying both sides deterministically from a nose-on
    start (4 groups, 30 steps, the Beta prior on): at each step the port's
    policy, given the JAX obs and memory, picks the JAX actions (the shoot
    bit exactly, the control bins on all but near-tied rows), and the
    port's step from the carried JAX state launches and hits exactly as the
    JAX step does."""
    from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
    from neuralplane_tpu.runner import F16SimRunner as JRunner
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.runner import F16SimRunner
    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "results", "shoot_1v1", "policy_checkpoint.pkl")
    jenv, env = make_pair("selfplay_shoot", 4)
    jrun = JRunner(jenv, JRLConfig(use_prior=True), run_dir=str(tmp_path / "j"), model_dir=ckpt)
    run = F16SimRunner(env, RLConfig(use_prior=True), run_dir=str(tmp_path / "p"),
                       model_dir=ckpt)
    jrun.close()
    run.close()
    jstate, jobs = jenv.reset(jax.random.PRNGKey(4))
    jstate = nose_on(env, jstate)
    jobs = jenv._obs(jstate, jenv.model.extended_state(jstate.model))
    params = jrun.train_state.params
    act = jax.jit(lambda o, h, m: jrun.policy.act(params, o, h, m, deterministic=True))
    h, masks = jnp.zeros((env.n, 1, 128)), jnp.ones((env.n, 1))
    env.reset(0)
    fired = ctl_diff = 0
    for k in range(30):
        a, h_next = act(jobs, h, masks)
        with torch.no_grad():
            pa, _ = run.policy.act(torch.from_numpy(np.array(jobs)), torch.from_numpy(np.array(h)),
                                   torch.from_numpy(np.array(masks)))
        ja = np.asarray(a)
        np.testing.assert_array_equal(pa.numpy()[:, 4], ja[:, 4], err_msg=f"step {k} shoot")
        ctl_diff += int((pa.numpy()[:, :4] != ja[:, :4]).any(axis=1).sum())
        state = env.state_from_jax(to_np(jstate))
        jstate, jout = jenv.step(jstate, a)
        _, out = env.step(state, torch.from_numpy(ja))
        for key in ("shoot/launches", "shoot/hits"):
            assert int(out.info[key]) == int(jout.info[key]), f"step {k} {key}"
        fired += int(jout.info["shoot/launches"])
        reset = np.asarray(jout.done | jout.bad_done | jout.exceed_time_limit).reshape(-1, 2)
        h = h_next * jnp.asarray(1.0 - np.repeat(reset.any(1), 2))[:, None, None]
        masks = jnp.asarray(1.0 - np.repeat(np.asarray(jout.done).reshape(-1, 2).any(1), 2))[:, None]
        jobs = jout.obs
    assert fired > 0 and ctl_diff <= 0.01 * 30 * env.n
