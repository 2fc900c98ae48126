"""UAV point-mass vehicle model, SI inside and feet at the getter boundary
(counterpart of neuralplane_tpu/models/uav.py).

The state holds body-frame velocities directly (columns 6-8, m/s); the
controls are three body forces, actions scaled by 27000 N through the same
first-order lag as the F-16's controls; the getters convert SI to feet, so
that the tasks see one unit convention whatever the model. The dynamics
(`ops/dynamics.nlplant_uav`) are elementwise eager tensor ops: no kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.atmosphere import atmos as _atmos, eas2tas as _eas2tas
from ..ops.dynamics import nlplant_uav
from ..ops.integrators import integrate, integrate_with_xdot
from ..utils.config import EnvConfig
from .f16 import F16State

FT = 0.3048
GRAV = 32.174
FORCE_SCALE = 27000.0


class UAVModel:
    """The F-16's state container (s [n,12], u padded to 5)."""

    num_states = 12
    num_controls = 5   # storage width; only the first 3 (Fx, Fy, Fz) are live
    weights = None     # no aero surrogate, so no fused step

    def __init__(self, config: EnvConfig, weights=None):
        self.config = config
        self.dt = config.dt
        self.solver = config.solver
        self.airspeed = config.airspeed

    def init_state(self, n: int, device) -> F16State:
        s = torch.zeros((n, self.num_states), dtype=torch.float32, device=device)
        u = torch.zeros((n, self.num_controls), dtype=torch.float32, device=device)
        return F16State(s=s, u=u, recent_s=s, recent_u=u)

    def reset(self, state: F16State, mask: torch.Tensor,
              generator: Optional[torch.Generator]) -> F16State:
        """Masked re-init: alt and vt drawn in feet, stored in metres."""
        n = state.s.shape[0]
        cfg = self.config
        dev = state.s.device
        s_new = torch.zeros_like(state.s)
        s_new[:, 2] = (cfg.min_altitude + torch.rand(n, generator=generator, device=dev)
                       * (cfg.max_altitude - cfg.min_altitude)) * FT
        s_new[:, 6] = (cfg.min_vt + torch.rand(n, generator=generator, device=dev)
                       * (cfg.max_vt - cfg.min_vt)) * FT
        u_new = torch.zeros_like(state.u)
        u_new[:, 0] = cfg.init_state.init_T
        m = mask[:, None]
        s = torch.where(m, s_new, state.s)
        u = torch.where(m, u_new, state.u)
        return F16State(s=s, u=u, recent_s=torch.where(m, s, state.recent_s),
                        recent_u=torch.where(m, u, state.recent_u))

    def _lagged_controls(self, state: F16State, action: torch.Tensor) -> torch.Tensor:
        a = torch.clamp(action, -1.0, 1.0)
        u3 = 0.9 * state.u[:, :3] + 0.1 * a[:, :3] * FORCE_SCALE
        return torch.cat([u3, torch.zeros_like(state.u[:, 3:])], dim=1)

    @staticmethod
    def dynamics(s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return nlplant_uav(s, u[:, :3])

    def update(self, state: F16State, action: torch.Tensor) -> F16State:
        u = self._lagged_controls(state, action)
        s = integrate(self.dynamics, state.s, u, self.dt, self.solver)
        return F16State(s=s, u=u, recent_s=state.s, recent_u=state.u)

    def update_with_xdot(self, state: F16State, action: torch.Tensor):
        u = self._lagged_controls(state, action)
        s, xdot = integrate_with_xdot(self.dynamics, state.s, u, self.dt, self.solver)
        return F16State(s=s, u=u, recent_s=state.s, recent_u=state.u), xdot

    def extended_state(self, state: F16State) -> torch.Tensor:
        return self.dynamics(state.s, state.u)

    # --- getters (feet out) ---
    def get_position(self, st):
        return st.s[:, 0] / FT, st.s[:, 1] / FT, st.s[:, 2] / FT

    def get_posture(self, st):
        return st.s[:, 3], st.s[:, 4], st.s[:, 5]

    def get_vt(self, st):
        return torch.sqrt(st.s[:, 6] ** 2 + st.s[:, 7] ** 2 + st.s[:, 8] ** 2) / FT

    def get_TAS(self, st):
        return self.get_vt(st) + self.airspeed

    def get_EAS2TAS(self, st):
        return _eas2tas(st.s[:, 2] / FT)

    def get_EAS(self, st):
        return self.get_TAS(st) / self.get_EAS2TAS(st)

    def get_AOA(self, st):
        return torch.zeros_like(st.s[:, 0])

    def get_AOS(self, st):
        return torch.zeros_like(st.s[:, 0])

    def get_angular_velocity(self, st):
        return st.s[:, 9], st.s[:, 10], st.s[:, 11]

    def get_thrust(self, st):
        return torch.zeros_like(st.u[:, 0])

    def get_control_surface(self, st):
        z = torch.zeros_like(st.u[:, 0])
        return z, z, z, z

    def get_velocity(self, st):
        return st.s[:, 6] / FT, st.s[:, 7] / FT, st.s[:, 8] / FT

    def get_ground_speed(self, st, xdot):
        return xdot[:, 0] / FT, xdot[:, 1] / FT

    def get_climb_rate(self, st, xdot):
        return xdot[:, 2] / FT

    def get_euler_angular_velocity(self, st, xdot):
        return xdot[:, 3], xdot[:, 4], xdot[:, 5]

    def _body_accel(self, st, xdot):
        vel_u, vel_v, vel_w = self.get_velocity(st)
        u_dot, v_dot, w_dot = xdot[:, 6] / FT, xdot[:, 7] / FT, xdot[:, 8] / FT
        return vel_u, vel_v, vel_w, u_dot, v_dot, w_dot

    def get_acceleration(self, st, xdot):
        vel_u, vel_v, vel_w, u_dot, v_dot, w_dot = self._body_accel(st, xdot)
        P, Q, R = st.s[:, 9], st.s[:, 10], st.s[:, 11]
        return (u_dot + Q * vel_w - R * vel_v,
                v_dot + R * vel_u - P * vel_w,
                w_dot + P * vel_v - Q * vel_u)

    def get_accels(self, st, xdot):
        vel_u, vel_v, vel_w, u_dot, v_dot, w_dot = self._body_accel(st, xdot)
        P, Q, R = st.s[:, 9], st.s[:, 10], st.s[:, 11]
        phi, theta = st.s[:, 3], st.s[:, 4]
        nx = (u_dot + Q * vel_w - R * vel_v) / GRAV + torch.sin(theta)
        ny = (v_dot + R * vel_u - P * vel_w) / GRAV - torch.cos(theta) * torch.sin(phi)
        nz = -(w_dot + P * vel_v - Q * vel_u) / GRAV + torch.cos(theta) * torch.cos(phi)
        return nx, ny, nz

    def get_G(self, st, xdot):
        nx, ny, nz = self.get_accels(st, xdot)
        return torch.sqrt(nx * nx + ny * ny + nz * nz)

    def get_atmos(self, st):
        return _atmos(st.s[:, 2] / FT, self.get_vt(st))
