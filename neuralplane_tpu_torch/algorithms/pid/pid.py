"""Batched PID core as a state-transition function (counterpart of
neuralplane_tpu/algorithms/pid/pid.py).

`PIDState.initialized` is a 0-d bool tensor on the device, the reference's
reset latch inverted: it is shared by all rows, selected with torch.where
and never read by a Python `if` (that would make the host wait for the card
in every inner step). The anti-windup is the JAX package's one-sided rule:
the integrator grows when not output-limited or when error * dt < 0, then
clamps to +-Kimax.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .config import PIDGains


@dataclasses.dataclass
class PIDState:
    target: torch.Tensor       # [n]
    error: torch.Tensor        # [n]
    derivative: torch.Tensor   # [n]
    integrator: torch.Tensor   # [n]
    initialized: torch.Tensor  # [] bool

    def replace(self, **kw) -> "PIDState":
        return dataclasses.replace(self, **kw)


def pid_init(n: int, device="cuda") -> PIDState:
    z = torch.zeros(n, dtype=torch.float32, device=device)
    return PIDState(target=z, error=z, derivative=z, integrator=z,
                    initialized=torch.zeros((), dtype=torch.bool, device=device))


def pid_update_all(g: PIDGains, st: PIDState, target: torch.Tensor,
                   measurement: torch.Tensor, limit_I: torch.Tensor
                   ) -> Tuple[PIDState, torch.Tensor]:
    """One PID step. Returns (state, P + D + I); FF is `target * Kff`,
    read from the returned state via `pid_ff`."""
    error = target - measurement
    derivative = torch.where(st.initialized, (error - st.error) / g.dt, 0.0)
    if g.Ki != 0.0 and g.dt > 0.0:
        grow = (~limit_I) | (error * g.dt < 0.0)
        integrator = torch.clamp(st.integrator + error * g.Ki * g.dt * grow,
                                 -g.Kimax, g.Kimax)
    else:
        integrator = torch.zeros_like(st.integrator)
    new = PIDState(target=target, error=error, derivative=derivative,
                   integrator=integrator,
                   initialized=torch.ones_like(st.initialized))
    return new, error * g.Kp + derivative * g.Kd + integrator


def pid_ff(g: PIDGains, st: PIDState) -> torch.Tensor:
    return st.target * g.Kff
