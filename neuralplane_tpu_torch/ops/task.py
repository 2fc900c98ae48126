"""Row-level task layer of the three control tasks (counterpart of
neuralplane_tpu/ops/task_pallas.py:43-194): the 22-slot observation, six
terminations and the shaped + event reward, over [n] tensors.

This is the plain version. On the card the same arithmetic is a device
function inside the step kernel (`csrc/task.cuh`).
"""
from __future__ import annotations

import math

import torch

from ..utils.math import wrap_PI

FT = 0.3048
THRUST_NORM = 0.3048 / (0.225 * 76300.0)
R2D = 180.0 / 3.141592653589793
PI = math.pi

N_OBS = 22
N_CND = 6
VARIANTS = ("heading", "control", "tracking")

COND_NAMES = {
    "heading": ("overload", "low_altitude", "high_speed", "low_speed",
                "extreme_state", "unreach_heading"),
    "control": ("overload", "low_altitude", "high_speed", "low_speed",
                "extreme_state", "unreach_posture"),
    "tracking": ("overload", "low_altitude", "high_speed", "low_speed",
                 "extreme_state", "unreach_target"),
}


def task_consts(cfg) -> dict:
    """Config scalars consumed by the task layer."""
    return dict(
        airspeed=float(cfg.airspeed),
        acc_limit=float(cfg.acceleration_limit),
        alt_limit=float(cfg.altitude_limit),
        max_mach=float(cfg.max_velocity),
        min_mach=float(cfg.min_velocity),
        min_alpha=float(cfg.min_alpha), max_alpha=float(cfg.max_alpha),
        min_beta=float(cfg.min_beta), max_beta=float(cfg.max_beta),
        max_check=int(cfg.max_check_interval),
        min_check=int(cfg.min_check_interval),
    )


def task_rows(variant: str, c: dict, sr, ur, xdr, tr, step_count):
    """sr: 12 state rows, ur: 5 control rows (post-update), xdr: 12 xdot rows
    (step-start derivative), tr: 3 target rows, step_count: int32 [n].

    Returns (obs_rows list[22], done bool[n], bad bool[n], reward f32[n],
    conds list[6] of bool[n] in COND_NAMES order, the last being the unreach
    trigger = goal | overtime-miss)."""
    airspeed = c["airspeed"]
    npos, epos, alt = sr[0], sr[1], sr[2]
    roll, pitch, hdg = sr[3], sr[4], sr[5]
    vt, alpha, beta = sr[6], sr[7], sr[8]
    P, Q, R = sr[9], sr[10], sr[11]
    T, el, ail, rud, lef = ur[0], ur[1], ur[2], ur[3], ur[4]
    t0, t1, t2 = tr[0], tr[1], tr[2]

    if variant == "heading":
        head = [(alt - t0) * FT / 1000.0,
                wrap_PI(hdg - t1),
                (vt - t2) * FT / 340.0]
    elif variant == "control":
        head = [wrap_PI(pitch - t0),
                wrap_PI(hdg - t1),
                (vt - t2) * FT / 340.0]
    else:
        head = [(npos - t0) * FT / 1000.0,
                (epos - t1) * FT / 1000.0,
                (alt - t2) * FT / 1000.0]

    tfac = 1.0 - 0.703e-5 * alt
    eas2tas = torch.sqrt(1.0 / torch.pow(tfac, 4.14))
    TAS = vt + airspeed
    EAS = TAS / eas2tas
    sin_a, cos_a = torch.sin(alpha), torch.cos(alpha)
    sin_b, cos_b = torch.sin(beta), torch.cos(beta)
    tail = [
        alt * FT / 5000.0,
        torch.sin(roll), torch.cos(roll),
        torch.sin(pitch), torch.cos(pitch),
        EAS * FT / 340.0,
        sin_a, cos_a, sin_b, cos_b,
        P, Q, R,
        T * THRUST_NORM,
        el / 45.0, ail / 45.0, rud / 45.0, lef / 45.0,
        eas2tas,
    ]
    obs_rows = head + tail

    vel_u = vt * cos_b * cos_a
    vel_v = vt * sin_b
    vel_w = vt * cos_b * sin_a
    vt_d, al_d, be_d = xdr[6], xdr[7], xdr[8]
    u_dot = cos_b * cos_a * vt_d - vt * sin_b * cos_a * be_d \
        - vt * cos_b * sin_a * al_d
    v_dot = sin_b * vt_d + vt * cos_b * be_d
    w_dot = cos_b * sin_a * vt_d - vt * sin_b * sin_a * be_d \
        + vt * cos_b * cos_a * al_d
    ax = u_dot + Q * vel_w - R * vel_v
    ay = v_dot + R * vel_u - P * vel_w
    az = w_dot + P * vel_v - Q * vel_u
    acc = torch.sqrt(ax * ax + ay * ay + az * az)
    c_overload = acc > c["acc_limit"]
    c_low_alt = alt < c["alt_limit"]
    mach = TAS * FT / 340.0
    c_high_spd = mach >= c["max_mach"]
    c_low_spd = mach <= c["min_mach"]
    alpha_deg, beta_deg = alpha * R2D, beta * R2D
    c_extreme = ((alpha_deg < c["min_alpha"]) | (alpha_deg > c["max_alpha"])
                 | (beta_deg < c["min_beta"]) | (beta_deg > c["max_beta"]))

    over_max = step_count >= c["max_check"]
    if variant == "heading":
        off = ((torch.abs(wrap_PI(hdg - t1)) >= PI / 36.0)
               | (torch.abs(alt - t0) >= 100.0)
               | (torch.abs(vt - t2) >= 20.0))
        goal = (~off) & (~over_max) & (step_count >= c["min_check"])
    elif variant == "control":
        off = ((torch.abs(wrap_PI(hdg - t1)) >= PI / 36.0)
               | (torch.abs(wrap_PI(pitch - t0)) >= PI / 36.0)
               | (torch.abs(vt - t2) >= 20.0))
        goal = (~off) & (~over_max)
    else:
        off = ((torch.abs(npos - t0) >= 100.0)
               | (torch.abs(epos - t1) >= 100.0)
               | (torch.abs(alt - t2) >= 100.0))
        goal = (~off) & (~over_max)
    c_unreach_bad = over_max & off

    bad = (c_overload | c_low_alt | c_high_spd | c_low_spd | c_extreme
           | c_unreach_bad)
    done = goal

    if variant == "heading":
        d0 = (alt - t0) * FT / 1000.0
        d1 = wrap_PI(hdg - t1) / PI
        d2 = (vt - t2) * FT / 340.0
        base = -(d0 * d0) - (d1 * d1) - (d2 * d2)
    elif variant == "control":
        d0 = wrap_PI(pitch - t0) / PI
        d1 = wrap_PI(hdg - t1) / PI
        d2 = (vt - t2) * FT / 340.0
        base = -(d0 * d0) - (d1 * d1) - (d2 * d2)
    else:
        d0 = (npos - t0) * FT / 1000.0
        d1 = (epos - t1) * FT / 1000.0
        d2 = (alt - t2) * FT / 1000.0
        base = 0.1 * (-(d0 * d0) - (d1 * d1) - (d2 * d2))
    reward = base + 200.0 * done.float() - 200.0 * bad.float()
    conds = [c_overload, c_low_alt, c_high_spd, c_low_spd, c_extreme,
             c_unreach_bad | goal]
    return obs_rows, done, bad, reward, conds
