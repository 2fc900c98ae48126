"""Controller: attitude stabilization + TECS + L1 navigation (counterpart of
neuralplane_tpu/algorithms/pid/controller.py).

Demands and the sub-controllers' filter states live in one
`ControllerState` threaded through the env step; measurements are bundled
once per step into `FlightData` from the model state and the shared xdot.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ...utils.math import wrap_PI
from .attitude import RateState, pitch_servo_out, rate_init, roll_servo_out, yaw_rate_out
from .config import ControllerConfig
from .l1 import (L1State, l1_init, l1_nav_roll, l1_update_heading_hold,
                 l1_update_level_flight, l1_update_loiter, l1_update_waypoint)
from .tecs import TECSInputs, TECSState, tecs_init, tecs_update_pitch_throttle

PI = math.pi


class FlightData(NamedTuple):
    """Per-step measurement bundle consumed by all controllers."""
    roll: torch.Tensor
    pitch: torch.Tensor
    yaw: torch.Tensor
    TAS: torch.Tensor
    eas2tas: torch.Tensor
    roll_rate: torch.Tensor   # euler angle rates (xdot[:,3:6])
    pitch_rate: torch.Tensor
    yaw_rate: torch.Tensor
    climb_rate: torch.Tensor  # xdot[:,2]
    acc_x: torch.Tensor       # body-frame acceleration x
    position: torch.Tensor    # [n, 2] (npos, epos)
    ground_speed: torch.Tensor  # [n, 2] (xdot[:,0:2])


def flight_data(model, mstate, xdot: torch.Tensor) -> FlightData:
    """The bundle from the model's getters and the shared xdot."""
    roll, pitch, yaw = model.get_posture(mstate)
    ax, _, _ = model.get_acceleration(mstate, xdot)
    npos, epos, _ = model.get_position(mstate)
    return FlightData(
        roll=roll, pitch=pitch, yaw=yaw,
        TAS=model.get_TAS(mstate), eas2tas=model.get_EAS2TAS(mstate),
        roll_rate=xdot[:, 3], pitch_rate=xdot[:, 4], yaw_rate=xdot[:, 5],
        climb_rate=xdot[:, 2], acc_x=ax, position=torch.stack([npos, epos], dim=1),
        ground_speed=xdot[:, 0:2])


@dataclasses.dataclass
class ControllerState:
    roll_ctl: RateState
    pitch_ctl: RateState
    yaw_ctl: RateState
    tecs: TECSState
    l1: L1State
    # demands
    roll_dem: torch.Tensor
    pitch_dem: torch.Tensor
    yaw_dem: torch.Tensor
    yaw_rate_dem: torch.Tensor
    throttle_dem: torch.Tensor
    # servo outputs (deg)
    ail: torch.Tensor
    el: torch.Tensor
    rud: torch.Tensor

    def replace(self, **kw) -> "ControllerState":
        return dataclasses.replace(self, **kw)


def _select(mask: torch.Tensor, new, old):
    """Masked row select over matching state dataclasses; 0-d leaves (the
    `initialized` latches) keep running."""
    if dataclasses.is_dataclass(new):
        return type(new)(**{f.name: _select(mask, getattr(new, f.name),
                                            getattr(old, f.name))
                            for f in dataclasses.fields(new)})
    if new.ndim == 0:
        return old
    return torch.where(mask.reshape(mask.shape[0], *([1] * (new.ndim - 1))), new, old)


class Controller:
    """Stateless op collection; every method maps (state, data) -> state."""

    def __init__(self, config: ControllerConfig = None, dt: float = 0.02,
                 airspeed_min: float = 100.0, airspeed_max: float = 2300.0):
        self.cfg = config or ControllerConfig.make(dt, airspeed_min, airspeed_max)
        self._fresh = None   # reset's all-initial state, made once per size and device

    def init_state(self, n: int, device="cuda") -> ControllerState:
        z = torch.zeros(n, dtype=torch.float32, device=device)
        return ControllerState(
            roll_ctl=rate_init(n, device), pitch_ctl=rate_init(n, device),
            yaw_ctl=rate_init(n, device), tecs=tecs_init(n, device),
            l1=l1_init(n, device), roll_dem=z, pitch_dem=z, yaw_dem=z,
            yaw_rate_dem=z, throttle_dem=z, ail=z, el=z, rud=z)

    def reset(self, st: ControllerState, mask: torch.Tensor) -> ControllerState:
        """Zero every filter and demand of the masked rows; the 0-d
        `initialized` latches keep running."""
        n, dev = mask.shape[0], mask.device
        if self._fresh is None or self._fresh.roll_dem.shape[0] != n \
                or self._fresh.roll_dem.device != dev:
            self._fresh = self.init_state(n, dev)
        return _select(mask, self._fresh, st)

    def speed_scaler(self, TAS: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        scale_min = min(0.5, 1000.0 / (2 * cfg.airspeed_max))
        scale_max = max(2.0, 1000.0 / (0.7 * cfg.airspeed_min))
        return torch.clamp(1000.0 / (TAS + 1e-8), scale_min, scale_max)

    def stabilize(self, st: ControllerState, data: FlightData) -> ControllerState:
        cfg = self.cfg
        scaler = self.speed_scaler(data.TAS)
        roll_ctl, ail = roll_servo_out(cfg.roll, st.roll_ctl, wrap_PI(st.roll_dem - data.roll),
                                       scaler, data.roll_rate, data.eas2tas)
        pitch_ctl, el = pitch_servo_out(cfg.pitch, st.pitch_ctl,
                                        wrap_PI(st.pitch_dem - data.pitch), scaler,
                                        data.pitch_rate, data.roll, data.pitch, data.TAS,
                                        data.eas2tas)
        yaw_ctl, rud = yaw_rate_out(cfg.yaw, st.yaw_ctl, st.yaw_rate_dem, scaler,
                                    data.yaw_rate, data.eas2tas)
        return st.replace(roll_ctl=roll_ctl, pitch_ctl=pitch_ctl, yaw_ctl=yaw_ctl,
                          ail=ail, el=el, rud=rud)

    def cal_pitch_throttle(self, st: ControllerState, hgt_dem, TAS_dem, altitude,
                           data: FlightData) -> ControllerState:
        inputs = TECSInputs(altitude=altitude, climb_rate=data.climb_rate, roll=data.roll,
                            pitch=data.pitch, yaw=data.yaw, TAS=data.TAS,
                            eas2tas=data.eas2tas, acc_x=data.acc_x)
        tecs = tecs_update_pitch_throttle(self.cfg.tecs, st.tecs, hgt_dem, TAS_dem, inputs)
        return st.replace(tecs=tecs, pitch_dem=tecs.pitch_dem,
                          throttle_dem=tecs.throttle_dem)

    def _apply_nav(self, st: ControllerState, l1: L1State, data: FlightData
                   ) -> ControllerState:
        roll_dem = torch.clamp(l1_nav_roll(self.cfg.l1, l1, data.pitch),
                               -self.cfg.roll_limit, self.cfg.roll_limit)
        yaw_rate_dem = self.cfg.gravity * torch.tan(roll_dem) / data.TAS * data.eas2tas
        return st.replace(l1=l1, roll_dem=roll_dem, yaw_rate_dem=yaw_rate_dem)

    def update_waypoint(self, st: ControllerState, prev_WP, next_WP, dist_min,
                        data: FlightData) -> ControllerState:
        l1 = l1_update_waypoint(self.cfg.l1, st.l1, prev_WP, next_WP, dist_min,
                                data.position, data.ground_speed, data.yaw)
        return self._apply_nav(st, l1, data)

    def update_loiter(self, st: ControllerState, center_WP, radius, loiter_direction,
                      data: FlightData) -> ControllerState:
        l1 = l1_update_loiter(self.cfg.l1, st.l1, center_WP, radius, loiter_direction,
                              data.position, data.ground_speed, data.yaw)
        return self._apply_nav(st, l1, data)

    def update_heading_hold(self, st: ControllerState, navigation_heading,
                            data: FlightData) -> ControllerState:
        l1 = l1_update_heading_hold(self.cfg.l1, st.l1, navigation_heading,
                                    data.ground_speed, data.yaw)
        return self._apply_nav(st, l1, data)

    def update_level_flight(self, st: ControllerState, data: FlightData) -> ControllerState:
        return self._apply_nav(st, l1_update_level_flight(st.l1, data.yaw), data)

    def get_action(self, st: ControllerState) -> torch.Tensor:
        """The normalized env action (throttle, -el, -ail, -rud) / 45."""
        return torch.stack([st.throttle_dem, -st.el / 45.0, -st.ail / 45.0,
                            -st.rud / 45.0], dim=1)
