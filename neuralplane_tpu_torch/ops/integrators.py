"""Fixed-step integrators (counterpart of neuralplane_tpu/ops/integrators.py)."""
from __future__ import annotations

from typing import Callable

import torch

DynamicsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def euler_step(f: DynamicsFn, s, u, dt: float):
    return s + dt * f(s, u)


def rk4_step(f: DynamicsFn, s, u, dt: float):
    return integrate_with_xdot(f, s, u, dt, "rk4")[0]


_SOLVERS = {"euler": euler_step, "rk4": rk4_step}


def integrate(f: DynamicsFn, s, u, dt: float, solver: str = "euler"):
    """One fixed integration step of the given solver."""
    try:
        step = _SOLVERS[solver]
    except KeyError:
        raise ValueError(f"Unknown solver {solver!r}; options: {sorted(_SOLVERS)}")
    return step(f, s, u, dt)


def integrate_with_xdot(f: DynamicsFn, s, u, dt: float, solver: str = "euler"):
    """One step, also returning the step-start derivative f(s, u)."""
    if solver == "euler":
        xdot = f(s, u)
        return s + dt * xdot, xdot
    if solver == "rk4":
        k1 = f(s, u)
        k2 = f(s + 0.5 * dt * k1, u)
        k3 = f(s + 0.5 * dt * k2, u)
        k4 = f(s + dt * k3, u)
        return s + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4), k1
    raise ValueError(f"Unknown solver {solver!r}; options: {sorted(_SOLVERS)}")
