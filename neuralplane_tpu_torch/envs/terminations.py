"""Termination predicates of the control and combat tasks (counterpart of
neuralplane_tpu/envs/terminations.py). Each returns (bad_done, done,
exceed_time_limit) bool tensors [n]."""
from __future__ import annotations

import math

import torch

from ..utils.math import wrap_PI


def _none_like(x):
    return torch.zeros_like(x, dtype=torch.bool)


def overload(cfg, model, mstate, xdot):
    """|a| > acceleration_limit ft/s^2."""
    ax, ay, az = model.get_acceleration(mstate, xdot)
    bad = torch.sqrt(ax * ax + ay * ay + az * az) > cfg.acceleration_limit
    return bad, _none_like(bad), _none_like(bad)


def low_altitude(cfg, model, mstate):
    _, _, alt = model.get_position(mstate)
    bad = alt < cfg.altitude_limit
    return bad, _none_like(bad), _none_like(bad)


def high_speed(cfg, model, mstate):
    bad = model.get_TAS(mstate) * 0.3048 / 340.0 >= cfg.max_velocity
    return bad, _none_like(bad), _none_like(bad)


def low_speed(cfg, model, mstate):
    bad = model.get_TAS(mstate) * 0.3048 / 340.0 <= cfg.min_velocity
    return bad, _none_like(bad), _none_like(bad)


def extreme_state(cfg, model, mstate):
    r2d = 180.0 / math.pi
    alpha = model.get_AOA(mstate) * r2d
    beta = model.get_AOS(mstate) * r2d
    bad = ((alpha < cfg.min_alpha) | (alpha > cfg.max_alpha)
           | (beta < cfg.min_beta) | (beta > cfg.max_beta))
    return bad, _none_like(bad), _none_like(bad)


def unreach_heading(cfg, model, mstate, step_count, target_altitude,
                    target_heading, target_vt):
    """In tolerance inside the window -> done; past max_check_interval and
    off target -> bad_done."""
    _, _, heading = model.get_posture(mstate)
    _, _, altitude = model.get_position(mstate)
    vt = model.get_vt(mstate)
    over_max = step_count >= cfg.max_check_interval
    past_min = step_count >= cfg.min_check_interval
    off = ((torch.abs(wrap_PI(heading - target_heading)) >= math.pi / 36.0)
           | (torch.abs(altitude - target_altitude) >= 100.0)
           | (torch.abs(vt - target_vt) >= 20.0))
    return over_max & off, (~off) & (~over_max) & past_min, _none_like(off)


def unreach_posture(cfg, model, mstate, step_count, target_pitch,
                    target_heading, target_vt):
    """Control-task goal check (no minimum window). The pitch error is not
    wrapped here, as in the JAX portable path; the step kernel wraps it."""
    _, pitch, heading = model.get_posture(mstate)
    vt = model.get_vt(mstate)
    over_max = step_count >= cfg.max_check_interval
    off = ((torch.abs(wrap_PI(heading - target_heading)) >= math.pi / 36.0)
           | (torch.abs(pitch - target_pitch) >= math.pi / 36.0)
           | (torch.abs(vt - target_vt) >= 20.0))
    return over_max & off, (~off) & (~over_max), _none_like(off)


def unreach_target(cfg, model, mstate, step_count, target_npos, target_epos,
                   target_altitude):
    """Tracking-task goal check (no minimum window)."""
    npos, epos, altitude = model.get_position(mstate)
    over_max = step_count >= cfg.max_check_interval
    off = ((torch.abs(npos - target_npos) >= 100.0)
           | (torch.abs(epos - target_epos) >= 100.0)
           | (torch.abs(altitude - target_altitude) >= 100.0))
    return over_max & off, (~off) & (~over_max), _none_like(off)


def timeout(cfg, step_count):
    """step_count >= max_steps -> exceed_time_limit."""
    exceed = step_count >= cfg.max_steps
    return _none_like(exceed), _none_like(exceed), exceed


def crash(cfg, ego_pos, enm_pos):
    """Pairwise distance < distance_limit ft -> both crash."""
    bad = torch.linalg.vector_norm(enm_pos - ego_pos, dim=-1) < cfg.distance_limit
    return bad, _none_like(bad), _none_like(bad)


def shutdown(cfg, ego_blood, enm_blood):
    """Blood <= 0: ego dead -> bad_done (lose); enemy dead while ego alive ->
    done (win)."""
    bad = ego_blood <= 0.0
    return bad, (enm_blood <= 0.0) & ~bad, _none_like(bad)
