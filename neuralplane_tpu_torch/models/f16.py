"""F-16 vehicle model (counterpart of neuralplane_tpu/models/f16.py).

State transitions are functions of dataclasses of tensors: `reset` is a
masked select, `update` applies the actuator first-order lag then one
integrator step. Units: US (ft, ft/s, lbf, rad).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.atmosphere import atmos as _atmos, eas2tas as _eas2tas
from ..ops.dynamics import nlplant_f16
from ..ops.integrators import integrate, integrate_with_xdot
from ..utils.config import EnvConfig

GRAV = 32.174
THRUST_SCALE = 0.225 * 76300.0 / 0.3048
SURFACE_SCALE = 45.0


@dataclasses.dataclass
class F16State:
    s: torch.Tensor          # [n, 12] vehicle state
    u: torch.Tensor          # [n, 5] control (T, el, ail, rud, lef)
    recent_s: torch.Tensor   # state before the last update
    recent_u: torch.Tensor


@dataclasses.dataclass
class F16StateFM:
    """F16State stored feature-major, the step kernel's layout: sf [12, n],
    uf [5, n]. `s` and `u` are the agent-major views. `recent_*` is not
    carried (nothing on the fused control-task path reads it)."""
    sf: torch.Tensor
    uf: torch.Tensor

    @property
    def s(self) -> torch.Tensor:
        return self.sf.T

    @property
    def u(self) -> torch.Tensor:
        return self.uf.T

    @property
    def recent_s(self) -> torch.Tensor:
        raise NotImplementedError(
            "F16StateFM does not carry recent_s; the rollback consumers "
            "run on the agent-major F16State path")

    @property
    def recent_u(self) -> torch.Tensor:
        raise NotImplementedError("F16StateFM does not carry recent_u; see recent_s")


def to_fm(state) -> F16StateFM:
    """Agent-major state -> the fused path's feature-major layout."""
    if isinstance(state, F16StateFM):
        return state
    return F16StateFM(sf=state.s.T.contiguous(), uf=state.u.T.contiguous())


def from_fm(state) -> F16State:
    """Feature-major -> agent-major; the current state stands in for recent_*."""
    if isinstance(state, F16State):
        return state
    s, u = state.s.contiguous(), state.u.contiguous()
    return F16State(s=s, u=u, recent_s=s, recent_u=u)


class F16Model:
    """Stateless model ops; config and aero weights are fixed at construction."""

    num_states = 12
    num_controls = 5
    thrust_scale = THRUST_SCALE
    surface_scales = (SURFACE_SCALE, SURFACE_SCALE, SURFACE_SCALE)

    def __init__(self, config: EnvConfig, weights):
        self.config = config
        self.weights = weights
        self.dt = config.dt
        self.solver = config.solver
        self.airspeed = config.airspeed
        self._scales: Optional[torch.Tensor] = None

    def init_state(self, n: int, device) -> F16State:
        s = torch.zeros((n, self.num_states), dtype=torch.float32, device=device)
        u = torch.zeros((n, self.num_controls), dtype=torch.float32, device=device)
        return F16State(s=s, u=u, recent_s=s, recent_u=u)

    def reset(self, state: F16State, mask: torch.Tensor,
              generator: Optional[torch.Generator]) -> F16State:
        """Masked re-init: alt ~ U(min, max), vt ~ U(min, max), T = init_T,
        the rest zero (models/f16.py:131-152)."""
        n = state.s.shape[0]
        cfg = self.config
        dev = state.s.device
        s_new = torch.zeros_like(state.s)
        s_new[:, 2] = cfg.min_altitude + torch.rand(
            n, generator=generator, device=dev) * (cfg.max_altitude - cfg.min_altitude)
        s_new[:, 6] = cfg.min_vt + torch.rand(
            n, generator=generator, device=dev) * (cfg.max_vt - cfg.min_vt)
        u_new = torch.zeros_like(state.u)
        u_new[:, 0] = cfg.init_state.init_T
        m = mask[:, None]
        s = torch.where(m, s_new, state.s)
        u = torch.where(m, u_new, state.u)
        return F16State(s=s, u=u, recent_s=torch.where(m, s, state.recent_s),
                        recent_u=torch.where(m, u, state.recent_u))

    def dynamics(self, s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return nlplant_f16(self.weights, s, u)

    def _scale(self, like: torch.Tensor) -> torch.Tensor:
        """The action scales as a tensor on like's device, made once per
        device: a host-to-device copy in every step would make the host
        wait for the card."""
        if self._scales is None or self._scales.device != like.device:
            self._scales = torch.tensor([self.thrust_scale, *self.surface_scales],
                                        dtype=like.dtype, device=like.device)
        return self._scales

    def _lagged_controls(self, state: F16State, action: torch.Tensor) -> torch.Tensor:
        """u <- 0.9 u + 0.1 scale(action); lef pinned to 0."""
        a = torch.clamp(action, -1.0, 1.0)
        if a.shape[1] < 4:
            a = torch.cat([a, a.new_zeros((a.shape[0], 4 - a.shape[1]))], dim=1)
        u4 = 0.9 * state.u[:, :4] + 0.1 * a[:, :4] * self._scale(state.u)
        return torch.cat([u4, torch.zeros_like(state.u[:, 4:5])], dim=1)

    def update(self, state: F16State, action: torch.Tensor) -> F16State:
        u = self._lagged_controls(state, action)
        s = integrate(self.dynamics, state.s, u, self.dt, self.solver)
        return F16State(s=s, u=u, recent_s=state.s, recent_u=state.u)

    def update_with_xdot(self, state: F16State, action: torch.Tensor):
        u = self._lagged_controls(state, action)
        s, xdot = integrate_with_xdot(self.dynamics, state.s, u, self.dt,
                                      self.solver)
        return F16State(s=s, u=u, recent_s=state.s, recent_u=state.u), xdot

    def raw_control_update(self, state: F16State, u: torch.Tensor) -> F16State:
        """Integrate with an explicitly set control vector (the PID path of
        the combat envs)."""
        s = integrate(self.dynamics, state.s, u, self.dt, self.solver)
        return F16State(s=s, u=u, recent_s=state.s, recent_u=state.u)

    def extended_state(self, state: F16State) -> torch.Tensor:
        return self.dynamics(state.s, state.u)

    # --- getters ---
    def get_position(self, st):
        return st.s[:, 0], st.s[:, 1], st.s[:, 2]

    def get_posture(self, st):
        return st.s[:, 3], st.s[:, 4], st.s[:, 5]

    def get_vt(self, st):
        return st.s[:, 6]

    def get_TAS(self, st):
        return st.s[:, 6] + self.airspeed

    def get_EAS2TAS(self, st):
        return _eas2tas(st.s[:, 2])

    def get_EAS(self, st):
        return self.get_TAS(st) / self.get_EAS2TAS(st)

    def get_AOA(self, st):
        return st.s[:, 7]

    def get_AOS(self, st):
        return st.s[:, 8]

    def get_angular_velocity(self, st):
        return st.s[:, 9], st.s[:, 10], st.s[:, 11]

    def get_thrust(self, st):
        return st.u[:, 0]

    def get_control_surface(self, st):
        return st.u[:, 1], st.u[:, 2], st.u[:, 3], st.u[:, 4]

    def get_velocity(self, st):
        sa, ca = torch.sin(st.s[:, 7]), torch.cos(st.s[:, 7])
        sb, cb = torch.sin(st.s[:, 8]), torch.cos(st.s[:, 8])
        vt = st.s[:, 6]
        return vt * cb * ca, vt * sb, vt * cb * sa

    def get_ground_speed(self, st, xdot: torch.Tensor):
        return xdot[:, 0], xdot[:, 1]

    def get_climb_rate(self, st, xdot: torch.Tensor):
        return xdot[:, 2]

    def get_euler_angular_velocity(self, st, xdot: torch.Tensor):
        return xdot[:, 3], xdot[:, 4], xdot[:, 5]

    def _body_accel(self, st, xdot: torch.Tensor):
        s = st.s
        sa, ca = torch.sin(s[:, 7]), torch.cos(s[:, 7])
        sb, cb = torch.sin(s[:, 8]), torch.cos(s[:, 8])
        vt = s[:, 6]
        vel_u, vel_v, vel_w = vt * cb * ca, vt * sb, vt * cb * sa
        u_dot = cb * ca * xdot[:, 6] - vt * sb * ca * xdot[:, 8] - vt * cb * sa * xdot[:, 7]
        v_dot = sb * xdot[:, 6] + vt * cb * xdot[:, 8]
        w_dot = cb * sa * xdot[:, 6] - vt * sb * sa * xdot[:, 8] + vt * cb * ca * xdot[:, 7]
        return vel_u, vel_v, vel_w, u_dot, v_dot, w_dot

    def get_acceleration(self, st, xdot: torch.Tensor):
        vel_u, vel_v, vel_w, u_dot, v_dot, w_dot = self._body_accel(st, xdot)
        P, Q, R = st.s[:, 9], st.s[:, 10], st.s[:, 11]
        return (u_dot + Q * vel_w - R * vel_v, v_dot + R * vel_u - P * vel_w,
                w_dot + P * vel_v - Q * vel_u)

    def get_accels(self, st, xdot: torch.Tensor):
        """Load factors at cg (g units) incl. gravity projection."""
        vel_u, vel_v, vel_w, u_dot, v_dot, w_dot = self._body_accel(st, xdot)
        P, Q, R = st.s[:, 9], st.s[:, 10], st.s[:, 11]
        phi, theta = st.s[:, 3], st.s[:, 4]
        nx = (u_dot + Q * vel_w - R * vel_v) / GRAV + torch.sin(theta)
        ny = (v_dot + R * vel_u - P * vel_w) / GRAV - torch.cos(theta) * torch.sin(phi)
        nz = -(w_dot + P * vel_v - Q * vel_u) / GRAV + torch.cos(theta) * torch.cos(phi)
        return nx, ny, nz

    def get_G(self, st, xdot: torch.Tensor):
        nx, ny, nz = self.get_accels(st, xdot)
        return torch.sqrt(nx * nx + ny * ny + nz * nz)

    def get_atmos(self, st):
        return _atmos(st.s[:, 2], st.s[:, 6])
