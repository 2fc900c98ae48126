"""L1 lateral navigation as state-transition functions (counterpart of
neuralplane_tpu/algorithms/pid/l1.py).

Waypoint / loiter / heading-hold / level-flight guidance producing a
lateral-acceleration demand, turned into a bank angle by `l1_nav_roll`. The
reference's wall-clock integrator reset is the `reset_i` argument. 2-D
vectors are [n, 2] (north, east); everything else flat [n].
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ...utils.math import wrap_PI
from .config import L1Config

PI = math.pi


def _length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=1))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]


def _diff_angle(loc1: torch.Tensor, loc2: torch.Tensor) -> torch.Tensor:
    d = loc2 - loc1
    return torch.atan2(d[:, 1], d[:, 0])


def _unit(v: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(length, 1e-9)[:, None]


@dataclasses.dataclass
class L1State:
    L1_xtrack_i: torch.Tensor      # [n]
    last_Nu: torch.Tensor          # [n]
    # outputs of the last update_* call
    Nu: torch.Tensor
    latAccDem: torch.Tensor        # [n] ft/s^2
    L1_dist: torch.Tensor
    target_bearing: torch.Tensor
    nav_bearing: torch.Tensor
    crosstrack_error: torch.Tensor
    bearing_error: torch.Tensor
    WPcircle: torch.Tensor         # [n] bool

    def replace(self, **kw) -> "L1State":
        return dataclasses.replace(self, **kw)


def l1_init(n: int, device="cuda") -> L1State:
    z = torch.zeros(n, dtype=torch.float32, device=device)
    return L1State(L1_xtrack_i=z, last_Nu=z, Nu=z, latAccDem=z, L1_dist=z,
                   target_bearing=z, nav_bearing=z, crosstrack_error=z,
                   bearing_error=z, WPcircle=torch.zeros(n, dtype=torch.bool, device=device))


def _prevent_indecision(Nu, last_Nu, target_bearing, yaw):
    """Keep the previous turn direction in the narrow pointing-away band."""
    Nu_limit = 0.9 * PI
    osc = ((torch.abs(Nu) > Nu_limit) & (torch.abs(last_Nu) > Nu_limit)
           & (torch.abs(wrap_PI(target_bearing - yaw)) > 2 * PI / 3)
           & (Nu * last_Nu < 0))
    return torch.where(osc, last_Nu, Nu)


def l1_update_waypoint(cfg: L1Config, st: L1State, prev_WP, next_WP, dist_min,
                       current_loc, ground_speed, yaw, reset_i: bool = False) -> L1State:
    """Waypoint-tracking guidance."""
    xtrack_i = torch.zeros_like(st.L1_xtrack_i) if reset_i else st.L1_xtrack_i
    K_L1 = 4.0 * cfg.L1_damping * cfg.L1_damping
    target_bearing = _diff_angle(current_loc, next_WP)
    gs = _length(ground_speed)
    L1_dist = torch.maximum(cfg.L1_damping * cfg.L1_period * gs / PI,
                            torch.as_tensor(dist_min, dtype=gs.dtype, device=gs.device))

    AB = next_WP - prev_WP
    AB = torch.where((_length(AB) < 1e-6)[:, None], next_WP - current_loc, AB)
    AB = torch.where((_length(AB) < 1e-6)[:, None],
                     torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=1), AB)
    AB = AB / _length(AB)[:, None]

    A_air = current_loc - prev_WP
    crosstrack_error = _cross(A_air, AB)
    WP_A_dist = _length(A_air)
    alongTrackDist = _dot(A_air, AB)

    m1 = (WP_A_dist > L1_dist) & (alongTrackDist / torch.clamp_min(WP_A_dist, 1.0) < -0.7071)
    # guarded unit vector: current_loc == prev_WP would give 0/0
    A_unit = _unit(A_air, _length(A_air))
    Nu_a = torch.atan2(_cross(ground_speed, -A_unit), _dot(ground_speed, -A_unit))
    nav_a = torch.atan2(-A_unit[:, 1], -A_unit[:, 0])

    seg_len = _length(next_WP - prev_WP)
    m2 = (~m1) & (alongTrackDist > seg_len + gs * 3)
    B_air = current_loc - next_WP
    B_unit = _unit(B_air, _length(B_air))
    Nu_b = torch.atan2(_cross(ground_speed, -B_unit), _dot(ground_speed, -B_unit))
    nav_b = torch.atan2(-B_unit[:, 1], -B_unit[:, 0])

    m3 = ~(m1 | m2)
    Nu2 = torch.atan2(_cross(ground_speed, AB), _dot(ground_speed, AB))
    sine_Nu1 = torch.clamp(crosstrack_error / torch.clamp_min(L1_dist, 0.1),
                           -0.7071, 0.7071)
    Nu1 = torch.arcsin(sine_Nu1)
    small = torch.abs(Nu1) < (5 * PI / 180)
    xtrack_i = torch.clamp(xtrack_i + Nu1 * cfg.L1_xtrack_i_gain * cfg.dt * small,
                           -0.1, 0.1)
    Nu1 = Nu1 + xtrack_i
    nav_ab = wrap_PI(torch.atan2(AB[:, 1], AB[:, 0]) + Nu1)

    Nu = Nu_a * m1 + Nu_b * m2 + (Nu1 + Nu2) * m3
    nav_bearing = nav_a * m1 + nav_b * m2 + nav_ab * m3
    Nu = _prevent_indecision(Nu, st.last_Nu, target_bearing, yaw)
    last_Nu = Nu
    Nu = torch.clamp(Nu, -PI / 2, PI / 2)
    latAccDem = K_L1 * gs * gs / L1_dist * torch.sin(Nu)
    return L1State(L1_xtrack_i=xtrack_i, last_Nu=last_Nu, Nu=Nu, latAccDem=latAccDem,
                   L1_dist=L1_dist, target_bearing=target_bearing,
                   nav_bearing=nav_bearing, crosstrack_error=crosstrack_error,
                   bearing_error=Nu, WPcircle=torch.zeros_like(st.WPcircle))


def l1_update_loiter(cfg: L1Config, st: L1State, center_WP, radius, loiter_direction,
                     current_loc, ground_speed, yaw) -> L1State:
    """Loiter-circle guidance."""
    omega = 2 * PI / cfg.L1_period
    Kx = omega * omega
    Kv = 2 * cfg.L1_damping * omega
    K_L1 = 4 * cfg.L1_damping * cfg.L1_damping
    gs = _length(ground_speed)
    target_bearing = _diff_angle(current_loc, center_WP)
    L1_dist = cfg.L1_damping * cfg.L1_period * gs / PI
    radius = torch.as_tensor(radius, dtype=gs.dtype, device=gs.device)

    A_air = current_loc - center_WP
    a_len = _length(A_air)
    m1 = a_len > 0.1
    m2 = (~m1) & (gs < 0.1)
    m3 = ~(m1 | m2)
    A_unit = (_unit(A_air, a_len) * m1[:, None]
              + torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=1) * m2[:, None]
              + _unit(ground_speed, gs) * m3[:, None])

    xtrackVelCap = _cross(A_unit, ground_speed)
    ltrackVelCap = -_dot(ground_speed, A_unit)
    Nu = torch.atan2(xtrackVelCap, ltrackVelCap)
    Nu = _prevent_indecision(Nu, st.last_Nu, target_bearing, yaw)
    last_Nu = Nu
    Nu = torch.clamp(Nu, -PI / 2, PI / 2)
    latAccDemCap = K_L1 * gs * gs / torch.clamp_min(L1_dist, 1e-6) * torch.sin(Nu)

    xtrackVelCirc = -ltrackVelCap
    xtrackErrCirc = a_len - radius
    latAccDemCircPD = xtrackErrCirc * Kx + xtrackVelCirc * Kv
    velTangent = xtrackVelCap * loiter_direction
    wrong_way = (ltrackVelCap < 0) & (velTangent < 0)
    latAccDemCircPD = torch.where(wrong_way, torch.clamp_min(latAccDemCircPD, 0.0),
                                  latAccDemCircPD)
    latAccDemCircCtr = velTangent * velTangent / torch.maximum(
        0.5 * radius, radius + xtrackErrCirc)
    latAccDemCirc = loiter_direction * (latAccDemCircPD + latAccDemCircCtr)

    capture = (xtrackErrCirc > 0) & (loiter_direction * latAccDemCap
                                     < loiter_direction * latAccDemCirc)
    latAccDem = torch.where(capture, latAccDemCap, latAccDemCirc)
    nav_bearing = torch.atan2(-A_unit[:, 1], -A_unit[:, 0])
    return L1State(L1_xtrack_i=st.L1_xtrack_i, last_Nu=last_Nu, Nu=Nu,
                   latAccDem=latAccDem, L1_dist=L1_dist, target_bearing=target_bearing,
                   nav_bearing=nav_bearing, crosstrack_error=xtrackErrCirc,
                   bearing_error=Nu * capture, WPcircle=~capture)


def l1_update_heading_hold(cfg: L1Config, st: L1State, navigation_heading,
                           ground_speed, yaw) -> L1State:
    """Heading-hold guidance."""
    omegaA = 4.4428 / cfg.L1_period
    target_bearing = wrap_PI(navigation_heading)
    Nu = wrap_PI(target_bearing - wrap_PI(yaw))
    gs = _length(ground_speed)
    Nu = torch.clamp(Nu, -PI / 2, PI / 2)
    z = torch.zeros_like(Nu)
    return L1State(L1_xtrack_i=st.L1_xtrack_i, last_Nu=st.last_Nu, Nu=Nu,
                   latAccDem=2 * torch.sin(Nu) * (gs * omegaA), L1_dist=gs / omegaA,
                   target_bearing=target_bearing, nav_bearing=navigation_heading,
                   crosstrack_error=z, bearing_error=Nu,
                   WPcircle=torch.zeros_like(st.WPcircle))


def l1_update_level_flight(st: L1State, yaw) -> L1State:
    """Hold-current-heading guidance."""
    z = torch.zeros_like(yaw)
    return L1State(L1_xtrack_i=st.L1_xtrack_i, last_Nu=st.last_Nu, Nu=st.Nu,
                   latAccDem=z, L1_dist=st.L1_dist, target_bearing=yaw, nav_bearing=yaw,
                   crosstrack_error=z, bearing_error=z,
                   WPcircle=torch.zeros_like(st.WPcircle))


def l1_nav_roll(cfg: L1Config, st: L1State, pitch) -> torch.Tensor:
    """Bank angle for the demanded lateral acceleration."""
    result = torch.cos(pitch) * torch.atan(st.latAccDem / cfg.gravity)
    return torch.clamp(result, -PI / 2, PI / 2)
