"""Heading task: reach (target altitude, heading, speed); targets resampled
on goal-reach (counterpart of neuralplane_tpu/envs/tasks/heading.py).

The reference hardcodes fixed target increments (dheading = 2pi/3,
dalt = 1000 ft, dvt = 0); `heading_random_increments: true` draws them."""
from __future__ import annotations

import dataclasses
import math

import torch

from ...utils.math import wrap_PI
from .. import rewards, terminations
from .base import FT, BaseTask, control_task_termination, uniform


@dataclasses.dataclass
class HeadingTaskState:
    target_altitude: torch.Tensor  # [n] ft
    target_heading: torch.Tensor   # [n] rad
    target_vt: torch.Tensor        # [n] ft/s


class HeadingTask(BaseTask):
    kernel_variant = "heading"
    state_cls = HeadingTaskState

    def _increments(self, like, generator):
        cfg = self.config
        if not cfg.heading_random_increments:
            return 2.0 * math.pi / 3.0, 1000.0, 0.0
        n = like.shape[0]
        d_hdg = (uniform(n, like, generator) - 0.5) * 2.0 * cfg.max_heading_increment
        d_alt = (uniform(n, like, generator) - 0.5) * 2.0 * cfg.max_altitude_increment
        d_vt = (uniform(n, like, generator) - 0.5) * 2.0 * cfg.max_velocities_u_increment
        return d_hdg, d_alt, d_vt

    def new_targets(self, model, mstate, generator):
        _, _, altitude = model.get_position(mstate)
        _, _, heading = model.get_posture(mstate)
        d_hdg, d_alt, d_vt = self._increments(altitude, generator)
        return altitude + d_alt, wrap_PI(heading + d_hdg), model.get_vt(mstate) + d_vt

    def new_targets_from_init(self, alt_init, vt_init, generator):
        d_hdg, d_alt, d_vt = self._increments(alt_init, generator)
        return (alt_init + d_alt, wrap_PI(torch.zeros_like(alt_init) + d_hdg),
                vt_init + d_vt)

    def obs_head(self, model, mstate, ts):
        _, _, altitude = model.get_position(mstate)
        _, _, heading = model.get_posture(mstate)
        vt = model.get_vt(mstate)
        return [(altitude - ts.target_altitude) * FT / 1000.0,
                wrap_PI(heading - ts.target_heading),
                (vt - ts.target_vt) * FT / 340.0]

    def get_reward(self, model, mstate, ts, is_done, bad_done):
        return (rewards.heading_reward(model, mstate, ts.target_altitude,
                                       ts.target_heading, ts.target_vt)
                + rewards.event_driven_reward(is_done, bad_done))

    def get_termination(self, model, mstate, xdot, step_count, ts):
        cfg = self.config
        return control_task_termination(
            cfg, model, mstate, xdot, step_count, "unreach_heading",
            terminations.unreach_heading(cfg, model, mstate, step_count,
                                         ts.target_altitude, ts.target_heading,
                                         ts.target_vt))
