"""Shared task machinery (counterpart of neuralplane_tpu/envs/tasks/base.py):
the common 19-slot observation tail, sensor noise, the termination
combinator and the target-state plumbing of the three control tasks."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...utils.config import EnvConfig

FT = 0.3048
THRUST_NORM = 0.3048 / (0.225 * 76300.0)


def vehicle_obs_tail(model, mstate) -> torch.Tensor:
    """The 19 shared observation slots (indices 3..21). Returns [n, 19]."""
    _, _, altitude = model.get_position(mstate)
    roll, pitch, _ = model.get_posture(mstate)
    alpha, beta = model.get_AOA(mstate), model.get_AOS(mstate)
    P, Q, R = model.get_angular_velocity(mstate)
    el, ail, rud, lef = model.get_control_surface(mstate)
    return torch.stack([
        altitude * FT / 5000.0,
        torch.sin(roll), torch.cos(roll),
        torch.sin(pitch), torch.cos(pitch),
        model.get_EAS(mstate) * FT / 340.0,
        torch.sin(alpha), torch.cos(alpha),
        torch.sin(beta), torch.cos(beta),
        P, Q, R,
        model.get_thrust(mstate) * THRUST_NORM,
        el / 45.0, ail / 45.0, rud / 45.0, lef / 45.0,
        model.get_EAS2TAS(mstate),
    ], dim=1)


def add_sensor_noise(obs: torch.Tensor, generator: Optional[torch.Generator],
                     noise_scale: float) -> torch.Tensor:
    """Gaussian sensor noise on the whole observation."""
    if noise_scale == 0.0:
        return obs
    return obs + torch.randn(obs.shape, generator=generator, device=obs.device,
                             dtype=obs.dtype) * noise_scale


def uniform(n: int, like: torch.Tensor, generator) -> torch.Tensor:
    return torch.rand(n, generator=generator, device=like.device)


def control_task_termination(cfg, model, mstate, xdot, step_count,
                             unreach_name: str, unreach_cond):
    """OR the five safety conditions with the task's unreach condition and
    count each condition's triggers (order = ops/task.COND_NAMES)."""
    from .. import terminations

    conds = [
        ("overload", terminations.overload(cfg, model, mstate, xdot)),
        ("low_altitude", terminations.low_altitude(cfg, model, mstate)),
        ("high_speed", terminations.high_speed(cfg, model, mstate)),
        ("low_speed", terminations.low_speed(cfg, model, mstate)),
        ("extreme_state", terminations.extreme_state(cfg, model, mstate)),
        (unreach_name, unreach_cond),
    ]
    bad = torch.zeros_like(step_count, dtype=torch.bool)
    done = torch.zeros_like(bad)
    exceed = torch.zeros_like(bad)
    info = {}
    for name, (b, d, e) in conds:
        bad, done, exceed = bad | b, done | d, exceed | e
        info[f"termination/{name}"] = (b | d | e).sum().to(torch.int32)
    return done, bad, exceed, info


class BaseTask:
    """Config container + observation/action sizes. A subclass names its
    target fields (`state_cls`, fields in kernel row order) and its step
    kernel variant."""

    kernel_variant: Optional[str] = None
    state_cls = None

    def __init__(self, config: EnvConfig):
        self.config = config
        self.num_observation = config.num_observation
        self.num_actions = config.num_actions

    @classmethod
    def kernel_targets(cls, tstate):
        return tuple(getattr(tstate, f.name) for f in dataclasses.fields(tstate))

    @classmethod
    def state_from_kernel_targets(cls, t0, t1, t2):
        names = [f.name for f in dataclasses.fields(cls.state_cls)]
        return cls.state_cls(**dict(zip(names, (t0, t1, t2))))

    def init_state(self, n: int, device) -> object:
        z = torch.zeros(n, dtype=torch.float32, device=device)
        return self.state_from_kernel_targets(z, z, z)

    @staticmethod
    def _masked(mask, new, old):
        return tuple(torch.where(mask, a, b) for a, b in zip(new, old))

    def reset(self, model, mstate, tstate, mask, generator):
        """Resample the targets of masked rows from their (reset) state."""
        new = self.new_targets(model, mstate, generator)
        return self.state_from_kernel_targets(
            *self._masked(mask, new, self.kernel_targets(tstate)))

    def reset_from_init(self, tstate, mask, alt_init, vt_init, generator):
        """Target resample for the fused step: reset rows restart from the
        init state, so the targets follow from the init draws alone."""
        new = self.new_targets_from_init(alt_init, vt_init, generator)
        return self.state_from_kernel_targets(
            *self._masked(mask, new, self.kernel_targets(tstate)))

    def get_obs(self, model, mstate, tstate, generator):
        head = torch.stack(self.obs_head(model, mstate, tstate), dim=1)
        obs = torch.cat([head, vehicle_obs_tail(model, mstate)], dim=1)
        return add_sensor_noise(obs, generator, self.config.noise_scale)
