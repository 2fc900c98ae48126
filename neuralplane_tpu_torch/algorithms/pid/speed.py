"""Speed controller: throttle from longitudinal-acceleration error
(counterpart of neuralplane_tpu/algorithms/pid/speed.py).

A PID on demanded vs measured longitudinal acceleration with the
speedcontroller gains (Kp 5, Ki 25, Kff 80, Kimax 100), anti-windup latched
on the +-100% throttle saturation, output in percent throttle.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .config import SpeedControllerConfig
from .pid import PIDState, pid_ff, pid_init, pid_update_all


@dataclasses.dataclass
class SpeedState:
    pid: PIDState
    last_out: torch.Tensor  # [n] percent, unclamped (anti-windup latch)

    def replace(self, **kw) -> "SpeedState":
        return dataclasses.replace(self, **kw)


def speed_init(n: int, device="cuda") -> SpeedState:
    return SpeedState(pid=pid_init(n, device),
                      last_out=torch.zeros(n, dtype=torch.float32, device=device))


def speed_throttle_out(cfg: SpeedControllerConfig, st: SpeedState,
                       desired_accel: torch.Tensor, accel_meas: torch.Tensor,
                       limit_pct: float = 100.0) -> Tuple[SpeedState, torch.Tensor]:
    """Throttle demand in percent from an acceleration error (ft/s^2)."""
    limit_I = torch.abs(st.last_out) >= limit_pct
    pid_st, pid_out = pid_update_all(cfg.gains, st.pid, desired_accel, accel_meas,
                                     limit_I)
    out = pid_out + pid_ff(cfg.gains, pid_st)
    return SpeedState(pid=pid_st, last_out=out), torch.clamp(out, -limit_pct, limit_pct)
