"""Angle wrapping (counterpart of neuralplane_tpu/utils/math.py:15-26).

`jnp.mod` is a floored modulo; `torch.remainder` is the same operation (the
result takes the divisor's sign), whereas C's `fmodf` truncates.
"""
from __future__ import annotations

import math

import torch

PI = math.pi


def wrap_2PI(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angle into [0, 2*pi)."""
    res = torch.remainder(angle, 2.0 * PI)
    return torch.where(res < 0.0, res + 2.0 * PI, res)


def wrap_PI(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angle into (-pi, pi]."""
    res = wrap_2PI(angle)
    return torch.where(res > PI, res - 2.0 * PI, res)
