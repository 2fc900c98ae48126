"""The port's classical controllers (neuralplane_tpu_torch/algorithms/pid)
against the JAX package's on the CPU.

Every PID, attitude, speed, TECS and L1 function runs 50 chained calls on
both sides from the same numpy-seeded inputs, each side threading its own
state; every output and state leaf agrees within 1e-5 of that leaf's RMS
(plus 1e-5 absolute for leaves that are all zero), bools exactly. Then the
Controller's methods and its masked reset with the running `initialized`
latches, and the port's versions of tests/test_pid.py's behaviour checks.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralplane_tpu.algorithms import pid as jpid
from neuralplane_tpu.algorithms.pid.pid import pid_ff as jpid_ff
from neuralplane_tpu_torch.algorithms import pid
from neuralplane_tpu_torch.algorithms.pid.pid import pid_ff
from neuralplane_tpu_torch.envs import ControlEnv
from neuralplane_tpu_torch.utils.math import wrap_PI

N, CALLS, REL = 16, 50, 1e-5


def leaves(tree, prefix=""):
    """(name, leaf) pairs of a port dataclass / NamedTuple / tensor tree."""
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name), f"{prefix}{f.name}.")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{getattr(tree, '_fields', range(99))[i]}.")
    else:
        yield prefix.rstrip("."), tree


def jax_leaf(tree, name):
    for part in name.split("."):
        tree = tree[int(part)] if part.isdigit() else getattr(tree, part)
    return np.asarray(tree)


def assert_tree_close(got, want, msg=""):
    """Every leaf of the port tree `got` against the JAX tree `want`."""
    for name, g in leaves(got):
        w = jax_leaf(want, name) if name else np.asarray(want)
        g = g.numpy()
        assert g.shape == w.shape, f"{msg} {name}: shape {g.shape} vs {w.shape}"
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=f"{msg} {name}")
            continue
        rms = float(np.sqrt(np.mean(w.astype(np.float64) ** 2))) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=0, atol=REL * rms + 1e-5 * (rms == 0),
                                   err_msg=f"{msg} {name}")


class Inputs:
    """The same numpy-seeded [n] arrays for both sides."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, lo, hi, shape=(N,)):
        a = self.rng.uniform(lo, hi, shape).astype(np.float32)
        return jnp.asarray(a), torch.from_numpy(a)

    def bools(self, p):
        a = self.rng.random(N) < p
        return jnp.asarray(a), torch.from_numpy(a)


def chain(step_j, step_t, init_j, init_t, make_inputs, seed=0):
    """CALLS chained calls; each step returns (state, output)."""
    inp = Inputs(seed)
    sj, st = init_j, init_t
    for k in range(CALLS):
        aj, at = zip(*make_inputs(inp))
        sj, oj = step_j(sj, *aj)
        st, ot = step_t(st, *at)
        assert_tree_close(st, sj, f"call {k} state")
        if ot is not None:
            assert_tree_close(ot, oj, f"call {k} output")
    return st, sj


def test_pid_update_all_chain():
    g = pid.PIDGains(Kp=2.0, Ki=1.0, Kd=0.1, Kff=0.5, Kimax=0.3, dt=0.1)
    jg = jpid.PIDGains(Kp=2.0, Ki=1.0, Kd=0.1, Kff=0.5, Kimax=0.3, dt=0.1)

    def inputs(inp):
        return inp(-2, 2), inp(-2, 2), inp.bools(0.3)

    def step_t(st, target, meas, lim):
        st, out = pid.pid_update_all(g, st, target, meas, lim)
        return st, (out, pid_ff(g, st))

    def step_j(st, target, meas, lim):
        st, out = jpid.pid_update_all(jg, st, target, meas, lim)
        return st, (out, jpid_ff(jg, st))
    st, _ = chain(step_j, step_t, jpid.pid_init(N), pid.pid_init(N, "cpu"), inputs)
    assert bool(st.initialized)


def _rate_inputs(inp):
    return inp(-1.0, 1.0), inp(0.4, 2.0), inp(-1.0, 1.0), inp(1.0, 1.5)


@pytest.mark.parametrize("fn,cfg", [("roll_servo_out", "roll"), ("yaw_rate_out", "yaw")])
def test_rate_loops_chain(fn, cfg):
    c, jc = getattr(pid.RateControllerConfig, cfg)(), getattr(jpid.RateControllerConfig, cfg)()
    chain(lambda s, *a: getattr(jpid, fn)(jc, s, *a),
          lambda s, *a: getattr(pid, fn)(c, s, *a),
          jpid.rate_init(N), pid.rate_init(N, "cpu"), _rate_inputs, seed=1)


def test_pitch_servo_out_chain():
    """Roll over the whole circle: upright, inverted right and left, and
    the high-bank demand reduction; pitch across the shallow limit."""
    c, jc = pid.RateControllerConfig.pitch(), jpid.RateControllerConfig.pitch()

    def inputs(inp):
        return _rate_inputs(inp)[:3] + (inp(-math.pi, math.pi), inp(-1.5, 1.5),
                                        inp(300.0, 1500.0), inp(1.0, 1.5))
    chain(lambda s, *a: jpid.pitch_servo_out(jc, s, *a),
          lambda s, *a: pid.pitch_servo_out(c, s, *a),
          jpid.rate_init(N), pid.rate_init(N, "cpu"), inputs, seed=2)


def test_rate_limits_and_rmax():
    """The rmax branches the shipped gains leave off."""
    c = pid.RateControllerConfig(tau=0.3, rmax_pos=0.5, rmax_neg=0.4)
    jc = jpid.RateControllerConfig(tau=0.3, rmax_pos=0.5, rmax_neg=0.4)
    for fn in ("roll_servo_out", "pitch_servo_out"):
        def inputs(inp, fn=fn):
            base = _rate_inputs(inp)
            return base if fn == "roll_servo_out" else base[:3] + (
                inp(-2, 2), inp(-1, 1), inp(400, 1200), base[3])
        chain(lambda s, *a, fn=fn: getattr(jpid, fn)(jc, s, *a),
              lambda s, *a, fn=fn: getattr(pid, fn)(c, s, *a),
              jpid.rate_init(N), pid.rate_init(N, "cpu"), inputs, seed=3)


@pytest.mark.parametrize("gains", [{}, dict(KA=0.2, KI=0.5, KD=0.1, KFF=1.0)])
def test_yaw_servo_out_chain(gains):
    c, jc = pid.YawDamperConfig(**gains), jpid.YawDamperConfig(**gains)

    def inputs(inp):
        return (inp(0.4, 2.0), inp(-2.5, 2.5), inp(500, 1500), inp(-1.0, 1.0),
                inp(-5, 5), inp(1.0, 1.5))
    chain(lambda s, *a: jpid.yaw_servo_out(jc, s, *a),
          lambda s, *a: pid.yaw_servo_out(c, s, *a),
          jpid.yaw_damper_init(N), pid.yaw_damper_init(N, "cpu"), inputs, seed=4)


def test_speed_throttle_out_chain():
    c, jc = pid.SpeedControllerConfig(), jpid.SpeedControllerConfig()
    chain(lambda s, *a: jpid.speed_throttle_out(jc, s, *a),
          lambda s, *a: pid.speed_throttle_out(c, s, *a),
          jpid.speed_init(N), pid.speed_init(N, "cpu"),
          lambda inp: (inp(-5, 5), inp(-5, 5)), seed=5)


def test_tecs_chain():
    c, jc = pid.TECSConfig(dt=0.1), jpid.TECSConfig(dt=0.1)

    def inputs(inp):
        hgt, tas = inp(18000, 21000), inp(900, 1300)
        meas = [inp(18000, 21000), inp(-50, 50), inp(-0.8, 0.8), inp(-0.3, 0.3),
                inp(-3, 3), inp(900, 1300), inp(1.0, 1.5), inp(-20, 20)]
        return [hgt, tas] + meas

    def step_t(st, hgt, tas, *m):
        st = pid.tecs_update_pitch_throttle(c, st, hgt, tas, pid.tecs.TECSInputs(*m))
        return st, None

    def step_j(st, hgt, tas, *m):
        st = jpid.tecs_update_pitch_throttle(jc, st, hgt, tas, jpid.tecs.TECSInputs(*m))
        return st, None
    st, _ = chain(step_j, step_t, jpid.tecs_init(N), pid.tecs_init(N, "cpu"), inputs, seed=6)
    assert bool(st.initialized)


def _loc(inp, lo, hi):
    (j1, t1), (j2, t2) = inp(lo, hi), inp(lo, hi)
    return jnp.stack([j1, j2], axis=1), torch.stack([t1, t2], dim=1)


@pytest.mark.parametrize("mode", ["waypoint", "loiter", "heading_hold", "level_flight"])
def test_l1_chain(mode):
    """Each guidance mode, then l1_nav_roll on its state."""
    c, jc = pid.L1Config(), jpid.L1Config()

    def inputs(inp):
        loc, gs, yaw, pitch = (_loc(inp, -3000, 3000), _loc(inp, -900, 900),
                               inp(-3.1, 3.1), inp(-0.5, 0.5))
        if mode == "waypoint":     # prev_WP, next_WP, dist_min
            return (_loc(inp, -3000, 3000), _loc(inp, -3000, 3000), inp(100, 800),
                    loc, gs, yaw, pitch)
        if mode == "loiter":       # center_WP, radius, loiter_direction
            (dj, dt) = inp(0, 1)
            direction = (jnp.sign(dj - 0.5), torch.sign(dt - 0.5))
            return _loc(inp, -3000, 3000), inp(500, 3000), direction, loc, gs, yaw, pitch
        if mode == "heading_hold":
            return inp(-3.1, 3.1), gs, yaw, pitch
        return yaw, pitch

    def step(lib, cfg):
        def f(st, *a):
            *a, pitch = a
            if mode == "level_flight":
                st = lib.l1_update_level_flight(st, *a)
            else:
                st = getattr(lib, f"l1_update_{mode}")(cfg, st, *a)
            return st, lib.l1_nav_roll(cfg, st, pitch)
        return f
    chain(step(jpid, jc), step(pid, c), jpid.l1_init(N), pid.l1_init(N, "cpu"), inputs,
          seed=7)


def _flight_data(inp):
    """A FlightData bundle for both sides."""
    cols = [inp(-1.2, 1.2), inp(-0.5, 0.5), inp(-3.1, 3.1), inp(700, 1400), inp(1.0, 1.5),
            inp(-0.5, 0.5), inp(-0.3, 0.3), inp(-0.2, 0.2), inp(-40, 40), inp(-20, 20),
            _loc(inp, -5000, 5000), _loc(inp, -900, 900)]
    j, t = zip(*cols)
    return jpid.FlightData(*j), pid.FlightData(*t)


def test_controller_methods_chain():
    """stabilize, cal_pitch_throttle, the four update_* methods and
    get_action, 50 chained calls through one ControllerState per side."""
    jc, c = jpid.Controller(dt=0.02), pid.Controller(dt=0.02)
    inp = Inputs(8)
    sj, st = jc.init_state(N), c.init_state(N, "cpu")
    modes = ("heading_hold", "waypoint", "loiter", "level_flight")
    for k in range(CALLS):
        dj, dt = _flight_data(inp)
        mode = modes[k % 4]
        if mode == "heading_hold":
            hj, ht = inp(-3.1, 3.1)
            sj, st = jc.update_heading_hold(sj, hj, dj), c.update_heading_hold(st, ht, dt)
        elif mode == "waypoint":
            (pj, pt), (nj, nt) = _loc(inp, -6000, 6000), _loc(inp, -6000, 6000)
            sj = jc.update_waypoint(sj, pj, nj, 300.0, dj)
            st = c.update_waypoint(st, pt, nt, 300.0, dt)
        elif mode == "loiter":
            (cj, ct) = _loc(inp, -6000, 6000)
            sj = jc.update_loiter(sj, cj, 2000.0, 1.0, dj)
            st = c.update_loiter(st, ct, 2000.0, 1.0, dt)
        else:
            sj, st = jc.update_level_flight(sj, dj), c.update_level_flight(st, dt)
        (hj, ht), (vj, vt), (aj, at) = inp(18000, 21000), inp(900, 1300), inp(18000, 21000)
        sj = jc.cal_pitch_throttle(sj, hj, vj, aj, dj)
        st = c.cal_pitch_throttle(st, ht, vt, at, dt)
        sj, st = jc.stabilize(sj, dj), c.stabilize(st, dt)
        assert_tree_close(st, sj, f"call {k} ({mode})")
        assert_tree_close(c.get_action(st), jc.get_action(sj), f"call {k} action")
    for tas in (1.0, 1e3, 1e9):   # both clamps of the speed scaler
        assert float(c.speed_scaler(torch.tensor([tas]))[0]) == \
            float(jc.speed_scaler(jnp.array([tas]))[0])


@pytest.mark.parametrize("latched", [False, True])
def test_controller_masked_reset_keeps_latches(latched):
    """A masked reset zeroes the masked rows of every [n] leaf (TECS's
    climb and sink scalers back to one) and leaves every 0-d `initialized`
    latch as it was, on both sides."""
    jc, c = jpid.Controller(dt=0.02), pid.Controller(dt=0.02)
    inp = Inputs(9)
    sj, st = jc.init_state(N), c.init_state(N, "cpu")
    for _ in range(3 if latched else 0):
        dj, dt = _flight_data(inp)
        (hj, ht), (vj, vt) = inp(18000, 21000), inp(900, 1300)
        sj = jc.stabilize(jc.cal_pitch_throttle(sj, hj, vj, dj.position[:, 0] * 0 + 19500.0,
                                                dj), dj)
        st = c.stabilize(c.cal_pitch_throttle(st, ht, vt, dt.position[:, 0] * 0 + 19500.0,
                                              dt), dt)
    mask_np = np.arange(N) % 3 == 0
    rj = jc.reset(sj, jnp.asarray(mask_np))
    rt = c.reset(st, torch.from_numpy(mask_np))
    assert_tree_close(rt, rj, "reset")
    for name, leaf in leaves(rt):
        if leaf.ndim == 0:
            assert bool(leaf) is latched, name
        elif name in ("tecs.max_climb_scaler", "tecs.max_sink_scaler"):
            assert (leaf[torch.from_numpy(mask_np)] == 1.0).all()
        elif leaf.dtype == torch.float32:
            assert (leaf[torch.from_numpy(mask_np)] == 0.0).all(), name


# --- the port's versions of tests/test_pid.py's behaviour checks ---

def test_pid_core_semantics():
    g = pid.PIDGains(Kp=2.0, Ki=1.0, Kd=0.1, Kff=0.5, Kimax=0.3, dt=0.1)
    st = pid.pid_init(3, "cpu")
    target = torch.tensor([1.0, -1.0, 0.0])
    meas = torch.zeros(3)
    no_limit = torch.zeros(3, dtype=torch.bool)
    st, out = pid.pid_update_all(g, st, target, meas, no_limit)
    np.testing.assert_allclose(st.derivative.numpy(), 0.0)
    np.testing.assert_allclose(st.integrator.numpy(), [0.1, -0.1, 0.0], rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), [2.1, -2.1, 0.0], rtol=1e-6)
    st2, _ = pid.pid_update_all(g, st, target, torch.tensor([0.5, -0.5, 0.0]), no_limit)
    np.testing.assert_allclose(st2.derivative.numpy(), [-5.0, 5.0, 0.0], rtol=1e-6)
    st3, _ = pid.pid_update_all(g, st2, target, meas, torch.ones(3, dtype=torch.bool))
    np.testing.assert_allclose(st3.integrator.numpy(), [0.15, -0.25, 0.0], rtol=1e-6)
    st4 = st
    for _ in range(20):
        st4, _ = pid.pid_update_all(g, st4, target, meas, no_limit)
    assert float(st4.integrator.abs().max()) <= 0.3 + 1e-6


def _fly(num_steps, heading_dem, alt_offset, tas_dem):
    """Closed loop on the port: L1 heading hold -> TECS -> attitude PIDs ->
    F-16 dynamics (the 43 nets in float32, as the JAX test's CPU default)."""
    env = ControlEnv(num_envs=2, config="heading", aero_backend="stacked", device="cpu")
    state, _ = env.reset(1)
    ctl, model, mstate = pid.Controller(dt=env.config.dt), env.model, state.model
    hgt_dem = model.get_position(mstate)[2] + alt_offset
    cst = ctl.init_state(env.n, "cpu")
    hdg, tas = torch.full((env.n,), heading_dem), torch.full((env.n,), tas_dem)
    with torch.no_grad():
        for _ in range(num_steps):
            xdot = model.extended_state(mstate)
            data = pid.flight_data(model, mstate, xdot)
            cst = ctl.update_heading_hold(cst, hdg, data)
            cst = ctl.cal_pitch_throttle(cst, hgt_dem, tas, model.get_position(mstate)[2], data)
            cst = ctl.stabilize(cst, data)
            mstate = model.update(mstate, torch.clamp(ctl.get_action(cst), -1.0, 1.0))
    return mstate.s.numpy()


def test_heading_hold_converges():
    s = _fly(1500, heading_dem=0.5, alt_offset=0.0, tas_dem=1100.0)
    assert np.isfinite(s).all()
    yaw_err = wrap_PI(torch.from_numpy(s[:, 5] - 0.5)).abs().numpy()
    assert (yaw_err < 0.15).all(), f"yaw error {yaw_err} after 30 s"
    assert (np.abs(s[:, 3]) < 0.4).all(), f"roll {s[:, 3]}"


def test_tecs_holds_altitude_and_speed():
    s = _fly(1500, heading_dem=0.0, alt_offset=0.0, tas_dem=1100.0)
    assert ((s[:, 2] > 18000) & (s[:, 2] < 21000)).all(), f"altitude drifted: {s[:, 2]}"
    assert (np.abs(s[:, 6] - 1100.0) < 150.0).all(), f"vt {s[:, 6]}"


def test_speed_controller_throttle_and_antiwindup():
    cfg = pid.SpeedControllerConfig()
    st = pid.speed_init(2, "cpu")
    demand = torch.tensor([10.0, 0.0])
    st, out = pid.speed_throttle_out(cfg, st, demand, torch.zeros(2))
    assert float(out[0]) > 40.0 and abs(float(out[1])) < 1e-6
    for _ in range(50):
        st, out = pid.speed_throttle_out(cfg, st, demand, torch.zeros(2))
    assert float(out[0]) == 100.0 and float(out.abs().max()) <= 100.0
    i_before = float(st.pid.integrator[0])
    st, _ = pid.speed_throttle_out(cfg, st, demand, torch.zeros(2))
    assert float(st.pid.integrator[0]) <= i_before + 1e-6
    assert abs(float(st.pid.integrator[1])) < 1e-9


def test_yaw_sideslip_damper():
    n = 2
    scaler, roll, ay, eas2tas = torch.ones(n), torch.zeros(n), torch.zeros(n), torch.ones(n)
    vt = torch.full((n,), 1000.0)
    rate_z = torch.tensor([0.2, -0.2])
    _, out = pid.yaw_servo_out(pid.YawDamperConfig(), pid.yaw_damper_init(n, "cpu"), scaler,
                               roll, vt, torch.tensor([0.5, -0.5]), ay, eas2tas)
    np.testing.assert_allclose(out.numpy(), 0.0)
    cfg = pid.YawDamperConfig(KA=0.0, KI=0.5, KD=0.1, KFF=1.0)
    st, out = pid.yaw_servo_out(cfg, pid.yaw_damper_init(n, "cpu"), scaler, roll, vt, rate_z,
                                ay, eas2tas)
    assert float(out[0]) < 0.0 < float(out[1])
    np.testing.assert_allclose(float(out[0]), -float(out[1]), rtol=1e-6)
    cfg_hp = pid.YawDamperConfig(KA=0.0, KI=0.0, KD=0.1, KFF=1.0)
    st_hp, mags = pid.yaw_damper_init(n, "cpu"), []
    for _ in range(200):
        st_hp, out_hp = pid.yaw_servo_out(cfg_hp, st_hp, scaler, roll, vt, rate_z, ay, eas2tas)
        mags.append(abs(float(out_hp[0])))
    assert mags[-1] < 0.5 * mags[0]
    st, out = pid.yaw_servo_out(cfg, st, scaler, roll, vt, torch.tensor([50.0, -50.0]), ay,
                                eas2tas)
    np.testing.assert_allclose(out.abs().numpy(), 45.0)
    bank = torch.full((n,), 0.5)
    _, out2 = pid.yaw_servo_out(cfg, pid.yaw_damper_init(n, "cpu"), scaler, bank, vt,
                                32.174 * torch.sin(bank) / vt, ay, eas2tas)
    np.testing.assert_allclose(out2.numpy(), 0.0, atol=1e-5)


def test_exports_match_the_jax_package():
    assert pid.__all__ == jpid.__all__
