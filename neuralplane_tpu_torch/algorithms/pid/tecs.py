"""TECS total-energy controller as a state-transition function (counterpart
of neuralplane_tpu/algorithms/pid/tecs.py).

One call runs the stage pipeline update -> update_speed ->
update_speed_demand -> update_height_demand -> update_energies ->
update_pitch -> update_throttle_with_airspeed. Every branch is a
torch.where select; the first-call reset latch is the 0-d bool tensor
`initialized` (captured at entry, shared by all rows, never read by the
host). The reference's quirk is kept for trajectory parity: the height
demand's rate limiter passes the previous filtered `hgt_dem` through.

All tensors flat [n]; units ft, ft/s, rad.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .config import TECSConfig


class TECSInputs(NamedTuple):
    """Measurements consumed per call (model getters and the shared xdot)."""
    altitude: torch.Tensor    # [n] ft
    climb_rate: torch.Tensor  # [n] ft/s (xdot[:,2])
    roll: torch.Tensor
    pitch: torch.Tensor
    yaw: torch.Tensor
    TAS: torch.Tensor         # [n] ft/s
    eas2tas: torch.Tensor
    acc_x: torch.Tensor       # [n] body-x acceleration


@dataclasses.dataclass
class TECSState:
    acc_x_lpf: torch.Tensor
    TAS_max: torch.Tensor
    TAS_dem_adj: torch.Tensor
    TAS_rate_dem_lpf: torch.Tensor
    hgt_dem: torch.Tensor
    hgt_dem_in_prev: torch.Tensor
    hgt_dem_rate_ltd: torch.Tensor
    hgt_dem_lpf: torch.Tensor
    hgt_dem_prev: torch.Tensor
    post_TO_hgt_offset: torch.Tensor
    max_climb_scaler: torch.Tensor
    max_sink_scaler: torch.Tensor
    climb_rate_limit: torch.Tensor
    sink_rate_limit: torch.Tensor
    pitch_dem_unc: torch.Tensor
    integSEBdot: torch.Tensor
    integKE: torch.Tensor
    last_pitch_dem: torch.Tensor
    STEdotErrLast: torch.Tensor
    integTHR_state: torch.Tensor
    # outputs (read by the Controller)
    pitch_dem: torch.Tensor
    throttle_dem: torch.Tensor
    STEdot_dem: torch.Tensor
    STEdot_est: torch.Tensor
    SEBdot_dem: torch.Tensor
    SEBdot_est: torch.Tensor
    initialized: torch.Tensor  # [] bool

    def replace(self, **kw) -> "TECSState":
        return dataclasses.replace(self, **kw)


def tecs_init(n: int, device="cuda") -> TECSState:
    z = torch.zeros(n, dtype=torch.float32, device=device)
    ones = torch.ones(n, dtype=torch.float32, device=device)
    fields = {f.name: z for f in dataclasses.fields(TECSState)}
    fields.update(max_climb_scaler=ones, max_sink_scaler=ones,
                  initialized=torch.zeros((), dtype=torch.bool, device=device))
    return TECSState(**fields)


def tecs_update_pitch_throttle(cfg: TECSConfig, st: TECSState,
                               hgt_dem_in_raw: torch.Tensor, TAS_dem: torch.Tensor,
                               inp: TECSInputs) -> TECSState:
    """One TECS cycle; the new state's pitch_dem and throttle_dem are the
    demands."""
    where = torch.where
    dt, g = cfg.dt, cfg.gravity
    reset = ~st.initialized
    THR_max = max(cfg.THR_max, cfg.THR_min + 0.01)
    THR_min = cfg.THR_min
    pitch_max = max(cfg.pitch_max, cfg.pitch_min)
    pitch_min = cfg.pitch_min

    # --- input saturation gate ---
    max_climb_cond = st.pitch_dem_unc > pitch_max
    max_descent_cond = st.pitch_dem_unc < pitch_min
    m1 = max_climb_cond & (hgt_dem_in_raw > st.hgt_dem_in_prev)
    m2 = max_descent_cond & (hgt_dem_in_raw < st.hgt_dem_in_prev)
    hgt_dem_in = where(m1 | m2, st.hgt_dem_in_prev, hgt_dem_in_raw)

    # --- update: reset inits and energy-rate bounds ---
    alt, pitch = inp.altitude, inp.pitch
    climb_rate_limit = where(reset, cfg.maxClimbRate * st.max_climb_scaler,
                             st.climb_rate_limit)
    sink_rate_limit = where(reset, cfg.maxSinkRate * st.max_sink_scaler,
                            st.sink_rate_limit)
    last_pitch_dem = where(reset, pitch, st.last_pitch_dem)
    hgt_dem = where(reset, alt, st.hgt_dem)
    hgt_dem_in_prev = where(reset, alt, st.hgt_dem_in_prev)
    hgt_dem_lpf = where(reset, alt, st.hgt_dem_lpf)
    hgt_dem_rate_ltd = where(reset, alt, st.hgt_dem_rate_ltd)
    hgt_dem_prev = where(reset, alt, st.hgt_dem_prev)
    height = alt
    climb_rate = inp.climb_rate
    STEdot_max = climb_rate_limit * g
    STEdot_min = -sink_rate_limit * g

    # --- update_speed ---
    acc_x = inp.acc_x
    alpha = dt / (dt + cfg.timeConst)
    acc_x_lpf = where(reset, acc_x, st.acc_x_lpf * (1 - alpha) + acc_x * alpha)
    TAS_max = where(reset, cfg.airspeed_max * inp.eas2tas, st.TAS_max)
    TAS_max = torch.minimum(TAS_max, cfg.airspeed_max * inp.eas2tas)
    TAS_min = cfg.airspeed_min * inp.eas2tas
    TAS_max = torch.maximum(TAS_max, TAS_min)
    TAS_state = inp.TAS

    # --- update_speed_demand ---
    TAS_dem_adj_prev = where(reset, TAS_state, st.TAS_dem_adj)
    TAS_dem = torch.clamp(TAS_dem, TAS_min, TAS_max)
    velRateMax = STEdot_max / TAS_state
    velRateMin = STEdot_min / TAS_state
    d = TAS_dem - TAS_dem_adj_prev
    m1 = d > velRateMax * dt
    m2 = d < velRateMin * dt
    TAS_dem_adj = where(m1, TAS_dem_adj_prev + velRateMax * dt,
                        where(m2, TAS_dem_adj_prev + velRateMin * dt, TAS_dem))
    TAS_rate_dem = where(m1, velRateMax, where(m2, velRateMin, d / dt))
    TAS_rate_dem_lpf = where(reset, TAS_rate_dem,
                             st.TAS_rate_dem_lpf * (1 - alpha) + TAS_rate_dem * alpha)
    TAS_dem_adj = torch.clamp(TAS_dem_adj, TAS_min, TAS_max)

    # --- update_height_demand ---
    climb_rate_limit = cfg.maxClimbRate * st.max_climb_scaler
    sink_rate_limit = cfg.maxSinkRate * st.max_sink_scaler
    hgt_dem_avg = 0.5 * (hgt_dem_in + hgt_dem_in_prev)
    hgt_dem_in_prev = hgt_dem_in
    d = hgt_dem_avg - hgt_dem_rate_ltd
    m1 = d > climb_rate_limit * dt
    m2 = d < -sink_rate_limit * dt
    # pass-through branch uses the previous filtered hgt_dem (reference quirk)
    hgt_dem_rate_ltd = where(m1, hgt_dem_rate_ltd + climb_rate_limit * dt,
                             where(m2, hgt_dem_rate_ltd - sink_rate_limit * dt, hgt_dem))
    coef = min(dt / (dt + max(cfg.hgt_dem_tconst, dt)), 1.0)
    hgt_dem_lpf = hgt_dem_rate_ltd * coef + (1 - coef) * hgt_dem_lpf
    post_TO_hgt_offset = st.post_TO_hgt_offset * (1 - coef)
    hgt_dem = hgt_dem_lpf + post_TO_hgt_offset
    hgt_dem_alpha = dt / max(dt + cfg.hgt_dem_tconst, dt)
    m1 = max_climb_cond & (hgt_dem > hgt_dem_prev)
    m2 = max_descent_cond & (hgt_dem < hgt_dem_prev)
    m3 = ~(m1 | m2)
    max_climb_scaler = where(m1, st.max_climb_scaler * (1 - hgt_dem_alpha),
                             st.max_climb_scaler)
    max_climb_scaler = where(m3, max_climb_scaler * (1 - hgt_dem_alpha) + hgt_dem_alpha,
                             max_climb_scaler)
    max_sink_scaler = where(m2, st.max_sink_scaler * (1 - hgt_dem_alpha),
                            st.max_sink_scaler)
    max_sink_scaler = where(m3, max_sink_scaler * (1 - hgt_dem_alpha) + hgt_dem_alpha,
                            max_sink_scaler)
    hgt_dem_prev = hgt_dem

    # --- update_energies ---
    SPE_dem = hgt_dem * g
    SKE_dem = 0.5 * TAS_dem_adj * TAS_dem_adj
    SKEdot_dem = TAS_state * (TAS_rate_dem - TAS_rate_dem_lpf)
    SPE_est = height * g
    SKE_est = 0.5 * TAS_state * TAS_state
    SPEdot = climb_rate * g
    SKEdot = TAS_state * (acc_x - acc_x_lpf)
    STEdot_est = SPEdot + SKEdot

    # --- update_pitch ---
    SKE_w = min(max(cfg.spdWeight, 0.0), 2.0)
    SPE_w = min(2.0 - SKE_w, 1.0)
    SKE_w = min(SKE_w, 1.0)
    SEB_dem = SPE_dem * SPE_w - SKE_dem * SKE_w
    SEB_est = SPE_est * SPE_w - SKE_est * SKE_w
    SEB_error = SEB_dem - SEB_est
    SPEdot_dem = (SPE_dem - SPE_est) / cfg.timeConst
    SEBdot_dem = SPEdot_dem * SPE_w - SKEdot_dem * SKE_w
    SEBdot_dem = torch.clamp(SEBdot_dem, -cfg.maxSinkRate * g, cfg.maxClimbRate * g)
    SEBdot_est = SPEdot * SPE_w - SKEdot * SKE_w
    SEBdot_error = SEBdot_dem - SEBdot_est
    SEBdot_dem_total = (0.5 * SEBdot_dem * cfg.timeConst
                        + SEBdot_error * cfg.pitchDamp + 0.8 * SEB_error)
    gainInv = TAS_state * g * cfg.timeConst
    m1 = st.pitch_dem_unc > pitch_max
    m2 = st.pitch_dem_unc < pitch_min
    integSEB_delta = where(
        m1, torch.minimum(SEB_error * cfg.integGain, pitch_max - st.pitch_dem_unc),
        where(m2, torch.minimum(SEB_error * cfg.integGain, pitch_min - st.pitch_dem_unc),
              SEB_error * cfg.integGain))
    inhibit = ((m1 & (integSEB_delta > 0)) | (m2 & (integSEB_delta < 0)))
    coef_i = 1 - dt / (dt + cfg.timeConst)
    integSEBdot = where(inhibit, st.integSEBdot * coef_i,
                        st.integSEBdot + integSEB_delta * dt)
    integKE = where(inhibit, st.integKE * coef_i,
                    st.integKE + (SKE_est - SKE_dem) * SKE_w * dt / cfg.timeConst)
    KE_limit = 0.25 * (pitch_max - pitch_min) * gainInv
    integKE = torch.clamp(integKE, -KE_limit, KE_limit)
    pitch_dem_unc = (SEBdot_dem_total + integSEBdot) / gainInv
    pitch_dem = torch.clamp(pitch_dem_unc, pitch_min, pitch_max)
    incr = dt * cfg.vertAccLim / TAS_state
    pitch_dem = torch.clamp(pitch_dem, last_pitch_dem - incr, last_pitch_dem + incr)
    last_pitch_dem = pitch_dem

    # --- update_throttle_with_airspeed ---
    SPE_err_max = torch.clamp_min(0.5 * TAS_max * TAS_max - SKE_dem, 0.0)
    SPE_err_min = torch.clamp_max(0.5 * TAS_min * TAS_min - SKE_dem, 0.0)
    STE_error = (torch.clamp(SPE_dem - SPE_est, SPE_err_min, SPE_err_max)
                 + SKE_dem - SKE_est)
    STEdot_dem = torch.clamp(SPEdot_dem + SKEdot_dem, STEdot_min, STEdot_max)
    STEdot_error = STEdot_dem - SPEdot - SKEdot
    filt = 2 * dt
    STEdot_error = filt * STEdot_error + (1 - filt) * st.STEdotErrLast
    STEdotErrLast = STEdot_error
    K_STE2Thr = (THR_max - THR_min) / (cfg.timeConst * (STEdot_max - STEdot_min))
    nomThr = cfg.throttle_cruise * 0.01
    roll, yaw = inp.roll, inp.yaw
    a = torch.cos(yaw) * torch.sin(roll) * torch.sin(pitch) - torch.cos(roll) * torch.sin(yaw)
    b = torch.cos(yaw) * torch.cos(roll) + torch.sin(yaw) * torch.sin(roll) * torch.sin(pitch)
    cosPhi2 = torch.clamp(a * a + b * b, 0.1, 1.0)
    STEdot_dem = STEdot_dem + cfg.rollComp * (1.0 / cosPhi2 - 1.0)
    ff_throttle = nomThr + STEdot_dem / (STEdot_max - STEdot_min) * (THR_max - THR_min)
    throttle_dem = (STE_error + STEdot_error * cfg.thrDamp) * K_STE2Thr + ff_throttle
    THRmin0 = min(max(THR_min, 0.0), THR_max)
    maxAmp = 0.5 * (THR_max - THRmin0)
    integ_max = torch.clamp(THR_max - throttle_dem + 0.1, -maxAmp, maxAmp)
    integ_min = torch.clamp(THR_min - throttle_dem - 0.1, -maxAmp, maxAmp)
    integTHR_state = st.integTHR_state + STE_error * cfg.integGain * dt * K_STE2Thr
    integTHR_state = torch.clamp(integTHR_state, integ_min, integ_max)
    throttle_dem = torch.clamp(0.5 * throttle_dem + integTHR_state, THR_min, THR_max)

    return TECSState(
        acc_x_lpf=acc_x_lpf, TAS_max=TAS_max, TAS_dem_adj=TAS_dem_adj,
        TAS_rate_dem_lpf=TAS_rate_dem_lpf, hgt_dem=hgt_dem,
        hgt_dem_in_prev=hgt_dem_in_prev, hgt_dem_rate_ltd=hgt_dem_rate_ltd,
        hgt_dem_lpf=hgt_dem_lpf, hgt_dem_prev=hgt_dem_prev,
        post_TO_hgt_offset=post_TO_hgt_offset,
        max_climb_scaler=max_climb_scaler, max_sink_scaler=max_sink_scaler,
        climb_rate_limit=climb_rate_limit, sink_rate_limit=sink_rate_limit,
        pitch_dem_unc=pitch_dem_unc, integSEBdot=integSEBdot, integKE=integKE,
        last_pitch_dem=last_pitch_dem, STEdotErrLast=STEdotErrLast,
        integTHR_state=integTHR_state, pitch_dem=pitch_dem, throttle_dem=throttle_dem,
        STEdot_dem=STEdot_dem, STEdot_est=STEdot_est, SEBdot_dem=SEBdot_dem,
        SEBdot_est=SEBdot_est, initialized=torch.ones_like(st.initialized))
