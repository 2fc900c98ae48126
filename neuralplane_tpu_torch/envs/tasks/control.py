"""Control (posture) task: reach (target pitch, heading, speed) with random
target increments (counterpart of neuralplane_tpu/envs/tasks/control.py)."""
from __future__ import annotations

import dataclasses

import torch

from ...utils.math import wrap_PI
from .. import rewards, terminations
from .base import FT, BaseTask, control_task_termination, uniform


@dataclasses.dataclass
class ControlTaskState:
    target_pitch: torch.Tensor    # [n] rad
    target_heading: torch.Tensor  # [n] rad
    target_vt: torch.Tensor       # [n] ft/s


class ControlTask(BaseTask):
    kernel_variant = "control"
    state_cls = ControlTaskState

    def _increments(self, like, generator):
        cfg = self.config
        n = like.shape[0]
        d_pitch = (uniform(n, like, generator) - 0.5) * 2.0 * cfg.max_pitch_increment
        d_hdg = (uniform(n, like, generator) - 0.5) * 2.0 * cfg.max_heading_increment
        d_vt = (uniform(n, like, generator) - 0.5) * 2.0 * cfg.max_velocities_u_increment
        return d_pitch, d_hdg, d_vt

    def new_targets(self, model, mstate, generator):
        _, pitch, heading = model.get_posture(mstate)
        d_pitch, d_hdg, d_vt = self._increments(pitch, generator)
        return (wrap_PI(pitch + d_pitch), wrap_PI(heading + d_hdg),
                model.get_vt(mstate) + d_vt)

    def new_targets_from_init(self, alt_init, vt_init, generator):
        d_pitch, d_hdg, d_vt = self._increments(alt_init, generator)
        return wrap_PI(d_pitch), wrap_PI(d_hdg), vt_init + d_vt

    def obs_head(self, model, mstate, ts):
        _, pitch, heading = model.get_posture(mstate)
        vt = model.get_vt(mstate)
        return [wrap_PI(pitch - ts.target_pitch),
                wrap_PI(heading - ts.target_heading),
                (vt - ts.target_vt) * FT / 340.0]

    def get_reward(self, model, mstate, ts, is_done, bad_done):
        return (rewards.posture_reward(model, mstate, ts.target_pitch,
                                       ts.target_heading, ts.target_vt)
                + rewards.event_driven_reward(is_done, bad_done))

    def get_termination(self, model, mstate, xdot, step_count, ts):
        cfg = self.config
        return control_task_termination(
            cfg, model, mstate, xdot, step_count, "unreach_posture",
            terminations.unreach_posture(cfg, model, mstate, step_count,
                                         ts.target_pitch, ts.target_heading,
                                         ts.target_vt))
