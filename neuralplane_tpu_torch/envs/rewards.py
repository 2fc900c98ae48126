"""Reward functions (counterpart of neuralplane_tpu/envs/rewards.py)."""
from __future__ import annotations

import math

from ..utils.math import wrap_PI

FT = 0.3048


def heading_reward(model, mstate, target_altitude, target_heading, target_vt):
    """-(dalt km)^2 - (dheading/pi)^2 - (dvt Mach)^2."""
    _, _, altitude = model.get_position(mstate)
    _, _, heading = model.get_posture(mstate)
    vt = model.get_vt(mstate)
    d_alt = (altitude - target_altitude) * FT / 1000.0
    d_hdg = wrap_PI(heading - target_heading) / math.pi
    d_vt = (vt - target_vt) * FT / 340.0
    return -(d_alt ** 2) - (d_hdg ** 2) - (d_vt ** 2)


def posture_reward(model, mstate, target_pitch, target_heading, target_vt):
    """Same shape on (pitch, heading, vt)."""
    _, pitch, heading = model.get_posture(mstate)
    vt = model.get_vt(mstate)
    d_pitch = wrap_PI(pitch - target_pitch) / math.pi
    d_hdg = wrap_PI(heading - target_heading) / math.pi
    d_vt = (vt - target_vt) * FT / 340.0
    return -(d_pitch ** 2) - (d_hdg ** 2) - (d_vt ** 2)


def position_reward(model, mstate, target_npos, target_epos, target_altitude):
    """0.1 * (-dn^2 - de^2 - dalt^2) in km."""
    npos, epos, altitude = model.get_position(mstate)
    d_n = (npos - target_npos) * FT / 1000.0
    d_e = (epos - target_epos) * FT / 1000.0
    d_a = (altitude - target_altitude) * FT / 1000.0
    return 0.1 * (-(d_n ** 2) - (d_e ** 2) - (d_a ** 2))


def event_driven_reward(is_done, bad_done):
    """+200 on goal-reach, -200 on failure."""
    return 200.0 * is_done.float() - 200.0 * bad_done.float()
