"""Angle wrapping, combat geometry and reward shaping (counterpart of
neuralplane_tpu/utils/math.py).

`jnp.mod` is a floored modulo; `torch.remainder` is the same operation (the
result takes the divisor's sign), whereas C's `fmodf` truncates.
`torch.sign(0) == 0`, as `jnp.sign(0)`.
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


def _ao_ta_r(ego_pos, enm_pos, ego_vel, enm_vel, return_side: bool):
    ego_v = torch.linalg.vector_norm(ego_vel, dim=1)
    enm_v = torch.linalg.vector_norm(enm_vel, dim=1)
    delta_pos = enm_pos - ego_pos
    distance = torch.linalg.vector_norm(delta_pos, dim=1)
    proj = torch.sum(delta_pos * ego_vel, dim=1)
    ego_AO = torch.arccos(torch.clamp(proj / (distance * ego_v + 1e-8), -1.0, 1.0))
    proj = torch.sum(delta_pos * enm_vel, dim=1)
    ego_TA = torch.arccos(torch.clamp(proj / (distance * enm_v + 1e-8), -1.0, 1.0))
    if not return_side:
        return ego_AO, ego_TA, distance
    # z-component of (ego_vel_2d x delta_pos_2d)
    cross_z = ego_vel[:, 0] * delta_pos[:, 1] - ego_vel[:, 1] * delta_pos[:, 0]
    return ego_AO, ego_TA, distance, torch.sign(cross_z)


def get_AO_TA_R(ego_pos, enm_pos, ego_vel, enm_vel, return_side: bool = False):
    """Aspect and antenna-train angles and range of paired agents: positions
    and velocities [n, 3] -> (AO, TA, R[, side_flag]) each [n]."""
    return _ao_ta_r(ego_pos, enm_pos, ego_vel, enm_vel, return_side)


def get2d_AO_TA_R(ego_pos, enm_pos, ego_vel, enm_vel, return_side: bool = False):
    """Planar (drop-altitude) variant of :func:`get_AO_TA_R`."""
    return _ao_ta_r(ego_pos[:, :-1], enm_pos[:, :-1], ego_vel[:, :-1],
                    enm_vel[:, :-1], return_side)


def orientation_reward(AO, TA):
    """Posture-orientation shaping, the JAX package's version "v2" (the one
    the combat envs use)."""
    return (1.0 / (50.0 * AO / PI + 2.0) + 0.5
            + torch.clamp_max(
                torch.arctanh(1.0 - torch.clamp_min(1.9 * TA / PI, 1e-4)) / (2.0 * PI),
                0.0) + 0.5)


def range_reward(target_dist, R):
    """Range shaping toward a preferred engagement distance (km), the JAX
    package's version "v3" (the one the combat envs use)."""
    return (1.0 * (R < 5.0)
            + (R >= 5.0) * torch.clamp(-0.032 * R ** 2 + 0.284 * R + 0.38, 0.0, 1.0)
            + torch.clamp(torch.exp(-0.16 * R), 0.0, 0.2))


def orientation_fn(AO):
    """Blood-damage orientation factor: 1 at nose-on, linear to 0 at +-30
    deg, the negative branch exclusive of 0 (the JAX package's fix)."""
    in_pos = (AO >= 0.0) & (AO <= PI / 6.0)
    in_neg = (AO < 0.0) & (AO >= -PI / 6.0)
    return (1.0 - 6.0 * AO / PI) * in_pos + (1.0 + 6.0 * AO / PI) * in_neg


def distance_fn(R):
    """Blood-damage range factor: 1 inside 1 km, linear to 0 at 3 km."""
    return 1.0 * (R <= 1.0) + (3.0 - R) / 2.0 * ((R > 1.0) & (R <= 3.0))
