"""Batched proportional-navigation missiles (counterpart of
neuralplane_tpu/ops/missile.py).

A constant-speed, pure-PN point-mass missile, batched over [n, K] (n
shooters x K missile slots); units feet and seconds, as the F-16 state:

- constant `speed`; pure PN steering a = N' * Omega x v_m with
  Omega = (r x dv) / |r|^2 the line-of-sight rate, clamped to `g_max` g of
  lateral acceleration, the velocity renormalized to `speed` after each
  update;
- a continuous (segment) hit test per step: the miss distance is taken at
  the closest point of approach within the step, so a fast missile cannot
  tunnel through the kill radius between samples;
- lifetime `duration` seconds, deactivation on hit or expiry.

Every function is elementwise over [n, K] (the JAX package's has no
`pallas_call`): eager PyTorch is its port, with no read back to the host.
The `_EPS` floors sit where the JAX package's do.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

G0_FTPS2 = 32.17405  # standard gravity, ft/s^2

_EPS = 1e-6


@dataclasses.dataclass
class MissileState:
    """Per-shooter missile slots."""
    pos: torch.Tensor      # [n, K, 3] (npos, epos, alt) ft
    vel: torch.Tensor      # [n, K, 3] ft/s
    active: torch.Tensor   # [n, K] bool
    age: torch.Tensor      # [n, K] s

    def replace(self, **kw) -> "MissileState":
        return dataclasses.replace(self, **kw)


def init_missiles(n: int, max_missiles: int, device="cuda") -> MissileState:
    z3 = torch.zeros((n, max_missiles, 3), dtype=torch.float32, device=device)
    return MissileState(pos=z3, vel=z3.clone(),
                        active=torch.zeros((n, max_missiles), dtype=torch.bool, device=device),
                        age=torch.zeros((n, max_missiles), dtype=torch.float32, device=device))


def clear_missiles(m: MissileState, mask: torch.Tensor) -> MissileState:
    """Deactivate every slot of the shooters where mask [n] is True."""
    return m.replace(active=m.active & ~mask[:, None])


def segment_min_dist(rel_pos: torch.Tensor, rel_vel: torch.Tensor, dt: float) -> torch.Tensor:
    """Minimum |rel_pos + t * rel_vel| over t in [0, dt] (closed form):
    t* = -<r, v> / <v, v> clamped into the step. `rel_pos` is target minus
    missile at the start of the step, `rel_vel` held over the step."""
    rv = (rel_pos * rel_vel).sum(-1)
    vv = (rel_vel * rel_vel).sum(-1)
    t_star = torch.clamp(-rv / (vv + _EPS), 0.0, dt)
    return torch.linalg.vector_norm(rel_pos + t_star[..., None] * rel_vel, dim=-1)


def step_missiles(m: MissileState, target_pos: torch.Tensor, target_vel: torch.Tensor, *,
                  dt: float, speed: float, nav_gain: float, g_max: float, duration: float,
                  hit_radius: float, fuse_outer: float = 0.0
                  ) -> Tuple[MissileState, torch.Tensor, torch.Tensor]:
    """Advance every missile one env step toward its target.

    target_pos / target_vel are [n, 3] (one target per shooter) or
    [n, K, 3] (per-slot targets locked at launch). Returns (new state,
    hits [n, K] bool, pk [n, K] float32).

    Fuse modes: binary (fuse_outer == 0): a hit when an active missile
    passes within `hit_radius` during the step, pk 1. Graded proximity fuse
    (fuse_outer > hit_radius): detonation at the closest point of approach
    (the unclamped t* < dt) within `fuse_outer`, or whenever inside
    `hit_radius`; pk ramps linearly from 1 at `hit_radius` to 0 at
    `fuse_outer`. Detonated missiles deactivate either way.
    """
    if target_pos.dim() == 2:
        target_pos, target_vel = target_pos[:, None, :], target_vel[:, None, :]
    rel_pos = target_pos - m.pos                       # [n, K, 3]
    rel_vel = target_vel - m.vel

    # continuous collision over the step (pre-update kinematics)
    miss = segment_min_dist(rel_pos, rel_vel, dt)
    if fuse_outer > 0.0:
        assert fuse_outer > hit_radius, "graded fuse needs outer > inner"
        rv = (rel_pos * rel_vel).sum(-1)
        vv = (rel_vel * rel_vel).sum(-1)
        cpa_in_step = -rv / (vv + _EPS) < dt           # passes CPA this step
        hits = m.active & (miss < fuse_outer) & (cpa_in_step | (miss < hit_radius))
        pk = (torch.clamp((fuse_outer - miss) / (fuse_outer - hit_radius), 0.0, 1.0)
              * hits.float())
    else:
        hits = m.active & (miss < hit_radius)
        pk = hits.float()

    # pure PN: Omega = (r x dv) / |r|^2 ; a = N' * Omega x v_m
    r2 = (rel_pos * rel_pos).sum(-1, keepdim=True)
    omega = torch.cross(rel_pos, rel_vel, dim=-1) / (r2 + _EPS)
    acc = nav_gain * torch.cross(omega, m.vel, dim=-1)
    a_norm = torch.linalg.vector_norm(acc, dim=-1, keepdim=True)
    a_max = g_max * G0_FTPS2
    # clamp |a| <= a_max (the _EPS floor keeps 0/0 out of a_norm == a_max == 0)
    acc = acc * (a_max / torch.clamp_min(a_norm, max(a_max, _EPS)))

    vel_new = m.vel + acc * dt
    vel_new = vel_new * (speed / (torch.linalg.vector_norm(vel_new, dim=-1, keepdim=True)
                                  + _EPS))
    pos_new = m.pos + m.vel * dt                       # pre-update velocity
    age_new = m.age + dt

    keep = m.active[..., None]
    return MissileState(pos=torch.where(keep, pos_new, m.pos),
                        vel=torch.where(keep, vel_new, m.vel),
                        active=m.active & ~hits & (age_new < duration),
                        age=torch.where(m.active, age_new, m.age)), hits, pk


def launch_missiles(m: MissileState, slot: torch.Tensor, fire: torch.Tensor,
                    shooter_pos: torch.Tensor, shooter_vel: torch.Tensor, *,
                    speed: float) -> MissileState:
    """Arm slot `slot[n]` of the shooters with fire[n] True: the missile
    separates at the shooter's position along its velocity at `speed` (a
    stationary shooter launches north)."""
    k = m.active.shape[1]
    sel = fire[:, None] & (torch.arange(k, device=slot.device)[None, :] == slot[:, None])
    v_norm = torch.linalg.vector_norm(shooter_vel, dim=-1, keepdim=True)
    north = torch.zeros_like(shooter_vel)
    north[:, 0] = 1.0
    head = torch.where(v_norm > _EPS, shooter_vel / (v_norm + _EPS), north)
    sel3 = sel[..., None]
    return MissileState(pos=torch.where(sel3, shooter_pos[:, None, :], m.pos),
                        vel=torch.where(sel3, (head * speed)[:, None, :], m.vel),
                        active=m.active | sel,
                        age=torch.where(sel, 0.0, m.age))
