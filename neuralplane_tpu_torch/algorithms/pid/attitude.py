"""Roll / pitch / yaw rate controllers and the legacy yaw damper
(counterpart of neuralplane_tpu/algorithms/pid/attitude.py).

Shared structure: angle error -> desired rate (tau), rate PID on
scaler^2-scaled rates, feed-forward divided by (scaler * eas2tas), output in
degrees clamped to +-45 with the unclamped value latched for anti-windup.
All tensors are flat [n].
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from .config import RateControllerConfig, YawDamperConfig
from .pid import PIDState, pid_ff, pid_init, pid_update_all

PI = math.pi


@dataclasses.dataclass
class RateState:
    pid: PIDState
    last_out: torch.Tensor  # [n] deg, unclamped (anti-windup latch)

    def replace(self, **kw) -> "RateState":
        return dataclasses.replace(self, **kw)


def rate_init(n: int, device="cuda") -> RateState:
    return RateState(pid=pid_init(n, device),
                     last_out=torch.zeros(n, dtype=torch.float32, device=device))


def _rate_out(cfg: RateControllerConfig, st: RateState, desired_rate, scaler,
              rate_meas, eas2tas, limit_deg: float = 45.0
              ) -> Tuple[RateState, torch.Tensor]:
    limit_I = torch.abs(st.last_out) >= limit_deg
    pid_st, pid_out = pid_update_all(cfg.gains, st.pid, desired_rate * scaler * scaler,
                                     rate_meas * scaler * scaler, limit_I)
    ff_out = pid_ff(cfg.gains, pid_st) / (scaler * eas2tas + 1e-8)
    out = (ff_out + pid_out) * 180.0 / PI
    return RateState(pid=pid_st, last_out=out), torch.clamp(out, -limit_deg, limit_deg)


def roll_servo_out(cfg: RateControllerConfig, st: RateState, angle_err, scaler,
                   roll_rate, eas2tas) -> Tuple[RateState, torch.Tensor]:
    """Aileron demand in deg."""
    desired_rate = angle_err / max(cfg.tau, 0.05)
    if cfg.rmax_pos:
        desired_rate = torch.clamp(desired_rate, -cfg.rmax_pos, cfg.rmax_pos)
    return _rate_out(cfg, st, desired_rate, scaler, roll_rate, eas2tas)


def _pitch_coordination(cfg: RateControllerConfig, roll, pitch, tas, eas2tas):
    """Turn-coordination pitch-rate offset and the inverted-flight flag."""
    m_upright = torch.abs(roll) < (PI / 2)
    m_right = roll >= (PI / 2)
    roll_eff = torch.where(
        m_upright, torch.clamp(roll, -4 * PI / 9, 4 * PI / 9),
        torch.where(m_right, torch.clamp(roll, 5 * PI / 9, PI),
                    torch.clamp(roll, -PI, -5 * PI / 9)))
    inverted = ~m_upright
    shallow = torch.abs(pitch) <= (7 * PI / 18)
    rate_offset = (shallow * torch.cos(pitch)
                   * torch.abs(cfg.gravity / tas * torch.tan(roll_eff)
                               * torch.sin(roll_eff) * eas2tas) * cfg.roll_ff)
    return inverted, torch.where(inverted, -rate_offset, rate_offset)


def pitch_servo_out(cfg: RateControllerConfig, st: RateState, angle_err, scaler,
                    pitch_rate, roll, pitch, tas, eas2tas
                    ) -> Tuple[RateState, torch.Tensor]:
    """Elevator demand in deg: coordination offset, inverted handling and
    bank-proportional demand reduction."""
    desired_rate = angle_err / max(cfg.tau, 0.05)
    inverted, rate_offset = _pitch_coordination(cfg, roll, pitch, tas, eas2tas)
    rate1 = desired_rate + rate_offset
    if cfg.rmax_pos:
        rate1 = torch.clamp_max(rate1, cfg.rmax_pos)
    if cfg.rmax_neg:
        rate1 = torch.clamp_min(rate1, -cfg.rmax_neg)
    desired_rate = torch.where(inverted, rate_offset - desired_rate, rate1)

    # reduce demand proportionally at high bank + moderate pitch
    roll_wrapped = torch.abs(roll)
    roll_wrapped = torch.where(roll_wrapped > PI / 2, PI - roll_wrapped, roll_wrapped)
    engage = (roll_wrapped > 5 * PI / 18) & (torch.abs(pitch) < 7 * PI / 18)
    roll_prop = (roll_wrapped - 5 * PI / 18) / (4 * PI / 18) * engage
    desired_rate = desired_rate * (1.0 - roll_prop)
    return _rate_out(cfg, st, desired_rate, scaler, pitch_rate, eas2tas)


def yaw_rate_out(cfg: RateControllerConfig, st: RateState, desired_rate, scaler,
                 yaw_rate, eas2tas) -> Tuple[RateState, torch.Tensor]:
    """Rudder demand in deg (the rate-loop path the controller uses)."""
    return _rate_out(cfg, st, desired_rate, scaler, yaw_rate, eas2tas)


@dataclasses.dataclass
class YawDamperState:
    """Filter and integrator state of the legacy sideslip damper."""
    last_out: torch.Tensor          # [n] deg (anti-windup latch on +-45)
    last_rate_hp_out: torch.Tensor  # [n] high-pass output memory
    last_rate_hp_in: torch.Tensor   # [n] high-pass input memory
    integrator: torch.Tensor        # [n]

    def replace(self, **kw) -> "YawDamperState":
        return dataclasses.replace(self, **kw)


def yaw_damper_init(n: int, device="cuda") -> YawDamperState:
    z = torch.zeros(n, dtype=torch.float32, device=device)
    return YawDamperState(last_out=z, last_rate_hp_out=z, last_rate_hp_in=z,
                          integrator=z)


def yaw_servo_out(cfg: YawDamperConfig, st: YawDamperState, scaler, roll, vt,
                  rate_z, ay, eas2tas) -> Tuple[YawDamperState, torch.Tensor]:
    """Legacy sideslip-damper servo path: the yaw rate minus the
    turn-coordination offset, high-passed (pole 0.996008), into a
    lateral-accel + washed-rate integrator; rudder KD*(integrator -
    hp_rate)*scaler^2 clamped to +-45 deg. The shipped gains (KA = KI = KD
    = 0) turn it off; KD < 1e-4 returns zeros."""
    mask = torch.abs(roll) < (PI / 2)
    roll_eff = torch.where(mask, torch.clamp(roll, -4 * PI / 9, 4 * PI / 9), roll)
    rate_offset = cfg.KFF * cfg.gravity * torch.sin(roll_eff) * eas2tas / vt
    rate_hp_in = (rate_z - rate_offset) * 180.0 / PI
    rate_hp_out = 0.996008 * st.last_rate_hp_out + rate_hp_in - st.last_rate_hp_in
    integ_in = -cfg.KI * (cfg.KA * ay + rate_hp_out)
    if cfg.KD > 0:
        # anti-windup: only integrate toward recovery while output saturated
        lo = st.last_out < -45.0
        hi = st.last_out > 45.0
        step = integ_in * cfg.gains.dt
        integrator = (st.integrator + torch.clamp_min(step, 0.0) * lo
                      + torch.clamp_max(step, 0.0) * hi + step * ~(lo | hi))
    else:
        integrator = torch.zeros_like(st.integrator)
    if cfg.KD < 1e-4:
        return (YawDamperState(last_out=st.last_out, last_rate_hp_out=rate_hp_out,
                               last_rate_hp_in=rate_hp_in, integrator=integrator),
                torch.zeros_like(rate_z))
    int_lim = cfg.imax * 0.01 / (cfg.KD * scaler * scaler)
    integrator = torch.clamp(integrator, -int_lim, int_lim)
    out = (cfg.KD * integrator * scaler * scaler
           + cfg.KD * (-rate_hp_out) * scaler * scaler)
    return (YawDamperState(last_out=out, last_rate_hp_out=rate_hp_out,
                           last_rate_hp_in=rate_hp_in, integrator=integrator),
            torch.clamp(out, -45.0, 45.0))
