"""Tracking task: fly to a 3-D point sampled on a sphere sector around the
aircraft (counterpart of neuralplane_tpu/envs/tasks/tracking.py)."""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import rewards, terminations
from .base import FT, BaseTask, control_task_termination, uniform


@dataclasses.dataclass
class TrackingTaskState:
    target_npos: torch.Tensor      # [n] ft
    target_epos: torch.Tensor      # [n] ft
    target_altitude: torch.Tensor  # [n] ft


class TrackingTask(BaseTask):
    kernel_variant = "tracking"
    state_cls = TrackingTaskState

    def _offsets(self, like, generator):
        cfg = self.config
        n = like.shape[0]
        distance = (uniform(n, like, generator) * (cfg.max_distance - cfg.min_distance)
                    + cfg.min_distance)
        theta1 = uniform(n, like, generator) * math.pi / 3.0 - math.pi / 6.0
        theta2 = uniform(n, like, generator) * math.pi / 3.0 - math.pi / 6.0
        return (distance * torch.cos(theta1) * torch.cos(theta2),
                distance * torch.cos(theta1) * torch.sin(theta2),
                distance * torch.sin(theta1))

    def new_targets(self, model, mstate, generator):
        npos, epos, altitude = model.get_position(mstate)
        d_n, d_e, d_a = self._offsets(npos, generator)
        return npos + d_n, epos + d_e, altitude + d_a

    def new_targets_from_init(self, alt_init, vt_init, generator):
        d_n, d_e, d_a = self._offsets(alt_init, generator)
        return d_n, d_e, alt_init + d_a

    def obs_head(self, model, mstate, ts):
        npos, epos, altitude = model.get_position(mstate)
        return [(npos - ts.target_npos) * FT / 1000.0,
                (epos - ts.target_epos) * FT / 1000.0,
                (altitude - ts.target_altitude) * FT / 1000.0]

    def get_reward(self, model, mstate, ts, is_done, bad_done):
        return (rewards.position_reward(model, mstate, ts.target_npos,
                                        ts.target_epos, ts.target_altitude)
                + rewards.event_driven_reward(is_done, bad_done))

    def get_termination(self, model, mstate, xdot, step_count, ts):
        cfg = self.config
        return control_task_termination(
            cfg, model, mstate, xdot, step_count, "unreach_target",
            terminations.unreach_target(cfg, model, mstate, step_count,
                                        ts.target_npos, ts.target_epos,
                                        ts.target_altitude))
