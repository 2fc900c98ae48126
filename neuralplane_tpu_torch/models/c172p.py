"""Cessna-172P vehicle model (counterpart of neuralplane_tpu/models/c172p.py).

It shares the F-16 model's state container, masked reset, actuator lag,
integrator plumbing and every getter (the same [n,12] wind-axis state and
US units); only the dynamics, the derivative table of
`ops/linear_aero.py`, and the control scales differ: thrust action [-1, 1]
-> 500 lbf, surface throws el +-25 deg, ail +-20 deg, rud +-16 deg. It has
no aero surrogate, so its env never takes the fused step and no kernel
runs: the build-up is eager elementwise tensor ops.
"""
from __future__ import annotations

import torch

from ..ops.linear_aero import C172P, nlplant_linear
from ..utils.config import EnvConfig
from .f16 import F16Model


class C172PModel(F16Model):
    thrust_scale = 500.0
    surface_scales = (25.0, 20.0, 16.0)

    def __init__(self, config: EnvConfig, weights=None):
        super().__init__(config, weights=None)

    def dynamics(self, s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return nlplant_linear(C172P, s, u)
