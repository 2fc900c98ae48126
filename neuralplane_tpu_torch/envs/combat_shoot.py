"""Combat with missiles, 1v1 and team against team (counterpart of
neuralplane_tpu/envs/combat_shoot.py).

- **action** = ShootTuple((throttle_bins, attitude_bins x 3)) + shoot bit,
  float [n, 5]: the four discrete indices decode to the [-1, 1] demands the
  guns-only envs take (the same smoothing and PID loop), the bit fires;
- **missiles**: up to `max_missiles` constant-speed pure-PN missiles per
  agent (`ops/missile.py`), launched along the shooter's velocity; a launch
  needs the bit, the weapon engagement zone (|AO| <= wez_max_ao_deg and
  R <= wez_max_range), ammo and an expired cooldown. A new missile flies
  from the next step on. In the 1v1 game it homes on the shooter's
  opponent; in the team game it locks the nearest alive enemy at launch
  and homes on it by stored in-group index (fire and forget: the shooter's
  death does not disarm it), dead agents cannot fire and a hit on a corpse
  deals nothing;
- **obs** = the guns-only layout + [ammo fraction, incoming-missile alert,
  nearest incoming range (10 km units, 0 when clear)], + [sin, cos of the
  nearest incoming missile's bearing off the heading, its closure (mach)]
  with `missile_threat_obs`;
- **reward**, 1v1: posture shaping - `missile_shoot_cost` per launch + 200
  on done - 200 on bad_done (+ `blood_shaping` * (damage dealt - taken));
  team: the guns-only team reward with missile damage in the dealt / taken
  terms and the launch cost shared by the team (summed over its launches,
  / h);
- **evadable variants** (`*_evadable`): `missile_fuse_outer` > 0 switches
  the warhead to the graded proximity fuse (pk ramps from 1 inside
  `missile_hit_radius` to 0 at `fuse_outer`).

As in envs/combat.py, nothing reads a value back to the host: the missile
arrays are [n, K] state fields, `info["shoot/launches"]`, `["shoot/hits"]`
and `["shoot/pk_sum"]` are 0-d device tensors, and `["shoot/fire_vec"]`
(who fired) and `["shoot/pk_dealt_vec"]` (the pk each agent's missiles
delivered) stay on the device. The xdot launches per step are those of the
guns-only envs: 11 for 1v1, 3 for the team game.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..algorithms.utils.spaces import ShootTuple
from ..ops.missile import (MissileState, clear_missiles, init_missiles, launch_missiles,
                           step_missiles)
from ..utils.config import EnvConfig
from ..utils.math import distance_fn, orientation_fn, wrap_PI
from .combat import FT, CombatState, MultipleCombatEnv, SingleCombatEnv
from .types import StepOutput


def decode_shoot_action(action: torch.Tensor, nvec: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ShootTuple [n, 5] (discrete indices + shoot bit) -> ([n, 4] demands
    in [-1, 1], fire [n] bool)."""
    idx = torch.minimum(torch.round(action[:, :4]).clamp_min(0.0), nvec - 1.0)
    return idx / (nvec - 1.0) * 2.0 - 1.0, action[:, 4] > 0.5


@dataclasses.dataclass
class ShootCombatState(CombatState):
    ammo: torch.Tensor            # [n] int32 missiles remaining
    cooldown: torch.Tensor        # [n] float32 s until the next launch
    missiles: MissileState        # [n, K] slots


@dataclasses.dataclass
class TeamShootCombatState(ShootCombatState):
    missile_target: torch.Tensor  # [n, K] int32 in-group victim of each slot


def _extend(state, cls, **extra):
    """`state`'s fields and `extra` as a `cls` (a dataclass subclass)."""
    return cls(**{f.name: getattr(state, f.name) for f in dataclasses.fields(state)}, **extra)


class _Weapons:
    """What both missile envs share: the action space, the decode, the WEZ
    threshold, the missile state fields and their masked reset."""

    def _init_weapons(self) -> None:
        cfg = self.config
        self.action_space = ShootTuple((cfg.throttle_bins,) + (cfg.attitude_bins,) * 3)
        self.num_actions = self.action_space.dim          # 4 controls + shoot
        self._nvec = torch.tensor(self.action_space.nvec, dtype=torch.float32,
                                  device=self.device)
        # the JAX package's float32 deg2rad of the WEZ angle
        self._wez_ao = float(np.float32(cfg.wez_max_ao_deg) * np.float32(np.pi / 180.0))
        self._dt_e = self.inner_steps * cfg.dt

    def init_state(self) -> ShootCombatState:
        cfg, n, dev = self.config, self.n, self.device
        return _extend(super().init_state(), ShootCombatState,
                       ammo=torch.full((n,), cfg.max_missiles, dtype=torch.int32, device=dev),
                       cooldown=torch.zeros(n, dtype=torch.float32, device=dev),
                       missiles=init_missiles(n, cfg.max_missiles, dev))

    def _reset_extras(self, state, mask: torch.Tensor):
        return state.replace(ammo=torch.where(mask, self.config.max_missiles, state.ammo),
                             cooldown=torch.where(mask, 0.0, state.cooldown),
                             missiles=clear_missiles(state.missiles, mask))

    def _decode(self, action: torch.Tensor):
        return decode_shoot_action(action, self._nvec)

    def _step_missiles(self, missiles: MissileState, target_pos, target_vel):
        cfg = self.config
        return step_missiles(missiles, target_pos, target_vel, dt=self._dt_e,
                             speed=cfg.missile_speed, nav_gain=cfg.missile_nav_gain,
                             g_max=cfg.missile_g_max, duration=cfg.missile_duration,
                             hit_radius=cfg.missile_hit_radius,
                             fuse_outer=cfg.missile_fuse_outer)

    def _rearm(self, state, fire: torch.Tensor):
        """(ammo, cooldown) after the launches `fire` [n]."""
        ammo = state.ammo - fire.to(torch.int32)
        cooldown = torch.where(fire, self.config.missile_cooldown,
                               torch.clamp_min(state.cooldown - self._dt_e, 0.0))
        return ammo, cooldown

    def _missile_cols(self, ammo, keyed, inc_pos, inc_vel, my_pos, my_vel, heading):
        """The appended obs columns from the incoming missiles' ranges
        `keyed` [..., S] (+inf for slots that are not incoming), their
        positions and velocities [..., S, 3], and my position, velocity
        [..., 3] and heading [...]."""
        cfg = self.config
        nearest = keyed.amin(dim=-1)
        alert = torch.isfinite(nearest)
        alert_f = alert.float()
        cols = [ammo.float() / cfg.max_missiles, alert_f,
                torch.where(alert, nearest, 0.0) * FT / 10000.0]
        if cfg.missile_threat_obs:
            # the nearest incoming missile's bearing off my heading (which
            # side to break toward) and its closure (when to break)
            slot = keyed.argmin(dim=-1, keepdim=True)[..., None].expand(
                *keyed.shape[:-1], 1, 3)
            mpos = torch.gather(inc_pos, -2, slot)[..., 0, :]
            mvel = torch.gather(inc_vel, -2, slot)[..., 0, :]
            dpos = mpos - my_pos
            rel_brg = wrap_PI(torch.atan2(dpos[..., 1], dpos[..., 0]) - heading)
            los_range = torch.clamp_min(torch.linalg.vector_norm(dpos, dim=-1), 1.0)
            closure = -((mvel - my_vel) * dpos).sum(-1) / los_range   # ft/s, > 0 inbound
            cols += [torch.sin(rel_brg) * alert_f, torch.cos(rel_brg) * alert_f,
                     closure * FT / 340.0 * alert_f]
        return torch.stack(cols, dim=-1)


class SingleCombatShootEnv(_Weapons, SingleCombatEnv):
    """1v1 combat with missiles; the action space is the ShootTuple."""

    def __init__(self, num_envs: int = 1, config: str | EnvConfig = "selfplay_shoot",
                 aero_backend: str = "auto", device="cuda"):
        super().__init__(num_envs, config, aero_backend=aero_backend, device=device)
        assert self.num_agents == 2, "shoot combat is 1v1"
        self._init_weapons()
        # 15 base dims + [ammo, alert, range] (+ [sin brg, cos brg, closure])
        self.num_observation = 21 if self.config.missile_threat_obs else 18
        # AO / R slots of the Beta launch prior (the 1v1 layout's 11 / 13)
        self.shoot_prior_slots = (11, 13)

    def _obs(self, state: ShootCombatState, xdot: torch.Tensor) -> torch.Tensor:
        opp, mis = self._opp, state.missiles
        my_pos = state.model.s[:, :3]
        inc_pos = mis.pos[opp]                                  # [n, K, 3]
        rng = torch.linalg.vector_norm(inc_pos - my_pos[:, None, :], dim=-1)
        keyed = torch.where(mis.active[opp], rng, torch.inf)
        extra = self._missile_cols(state.ammo, keyed, inc_pos, mis.vel[opp], my_pos,
                                   xdot[:, :3], state.model.s[:, 5])
        return torch.cat([super()._obs(state, xdot), extra], dim=1)

    @torch.no_grad()
    def step(self, state: ShootCombatState, action: torch.Tensor
             ) -> Tuple[ShootCombatState, StepOutput]:
        if self.generator is None:
            raise RuntimeError("call reset(seed) before step()")
        cfg, opp = self.config, self._opp
        state = self._masked_reset(state)
        demands, fire_bit = self._decode(action)
        mstate, cst = self._inner_fdm(demands, state.model, state.controller)
        xdot = self.model.extended_state(mstate)

        # missile flight and the continuous hit test (each missile homes on
        # its shooter's opponent); pk grades the kill under the graded fuse
        missiles, hits, pk = self._step_missiles(state.missiles, mstate.s[opp, :3],
                                                 xdot[opp, :3])
        # launches: WEZ, ammo and cooldown; the new missile flies next step
        AO, TA, R, _ = self._pair_geometry(mstate, xdot, planar=False)
        wez = (AO <= self._wez_ao) & (R <= cfg.wez_max_range)
        fire = fire_bit & wez & (state.ammo > 0) & (state.cooldown <= 0.0)
        missiles = launch_missiles(missiles, cfg.max_missiles - state.ammo, fire,
                                   mstate.s[:, :3], xdot[:, :3], speed=cfg.missile_speed)
        ammo, cooldown = self._rearm(state, fire)

        # blood: the gun damage plus missile_damage per (pk-weighted) hit
        dmg = orientation_fn(AO) * distance_fn(R * FT / 1000.0)
        pk_dealt = pk.sum(dim=1)                                # [n]
        mis_dealt = cfg.missile_damage * pk_dealt
        blood = state.blood - dmg[opp] - mis_dealt[opp]
        new_state = state.replace(model=mstate, controller=cst, blood=blood,
                                  step_count=state.step_count + 1, ammo=ammo,
                                  cooldown=cooldown, missiles=missiles)
        obs = self._obs(new_state, xdot)
        done, bad, exceed, info = self._termination(new_state, xdot)
        # posture shaping - launch cost + the +-200 events on any done or
        # bad_done (dying by crash or terrain costs what being shot down does)
        reward = (self._posture_reward(AO, TA, R) - cfg.missile_shoot_cost * fire.float()
                  + 200.0 * done.float() - 200.0 * bad.float())
        if cfg.blood_shaping:
            dealt = dmg + mis_dealt
            reward = reward + cfg.blood_shaping * (dealt - dealt[opp])
        info.update({"shoot/launches": fire.sum(), "shoot/hits": hits.sum(),
                     # the effectiveness counter under the graded fuse, whose
                     # hits count pk ~ 0 detonations too
                     "shoot/pk_sum": pk.sum(), "shoot/fire_vec": fire,
                     "shoot/pk_dealt_vec": pk_dealt})
        new_state = new_state.replace(is_done=done, bad_done=bad, exceed_time_limit=exceed)
        return new_state, StepOutput(obs=obs, reward=reward, done=done, bad_done=bad,
                                     exceed_time_limit=exceed, info=info)


class MultipleCombatShootEnv(_Weapons, MultipleCombatEnv):
    """nvn team combat with missiles, through the team game's hooks
    (`_split_action` reaches `_decode`, `_weapon_phase`); "incoming" in the
    obs means active missiles locked on me."""

    def __init__(self, num_envs: int = 1, config: str | EnvConfig = "multiple_selfplay_shoot",
                 aero_backend: str = "auto", device="cuda"):
        super().__init__(num_envs, config, aero_backend=aero_backend, device=device)
        self._init_weapons()
        # +3 missile dims, +3 threat dims with missile_threat_obs
        self.num_observation += 6 if self.config.missile_threat_obs else 3
        # the Beta launch prior keys on the lock target, the nearest alive
        # enemy: the first enemy block (at 9 + 7 (h - 1)), AO at +2, R at +4
        enemy0 = 9 + 7 * (self.half - 1)
        self.shoot_prior_slots = (enemy0 + 2, enemy0 + 4)

    def init_state(self) -> TeamShootCombatState:
        return _extend(super().init_state(), TeamShootCombatState,
                       missile_target=torch.zeros((self.n, self.config.max_missiles),
                                                  dtype=torch.int32, device=self.device))

    def _reset_extras(self, state: TeamShootCombatState, mask: torch.Tensor):
        state = super()._reset_extras(state, mask)
        return state.replace(missile_target=torch.where(mask[:, None], 0, state.missile_target))

    def _weapon_phase(self, state: TeamShootCombatState, mstate, xdot: torch.Tensor,
                      alive_g: torch.Tensor, fire, perm, key_sorted, AO_t):
        cfg = self.config
        E, m, h = self.num_envs, self.num_agents, self.half
        n, K = self.n, cfg.max_missiles
        alive = alive_g.reshape(-1)
        # flight toward the locked victims (stored in-group indices)
        tgt = state.missile_target.reshape(E, m * K).long()
        tgt3 = tgt[..., None].expand(E, m * K, 3)
        tgt_pos = torch.gather(self._group(mstate.s[:, :3]), 1, tgt3).reshape(n, K, 3)
        tgt_vel = torch.gather(self._group(xdot[:, :3]), 1, tgt3).reshape(n, K, 3)
        missiles, hits, pk = self._step_missiles(state.missiles, tgt_pos, tgt_vel)

        # launch at the nearest alive enemy (the step's perm[:, :, 0], toward
        # which AO_t is taken): alive shooters inside the WEZ only
        has_target = torch.isfinite(key_sorted[:, :, 0]).reshape(-1)
        R_l = torch.where(has_target, key_sorted[:, :, 0].reshape(-1), torch.inf)
        wez = (AO_t.reshape(-1) <= self._wez_ao) & (R_l <= cfg.wez_max_range)
        can = fire & alive & has_target & wez & (state.ammo > 0) & (state.cooldown <= 0.0)
        slot = cfg.max_missiles - state.ammo
        missiles = launch_missiles(missiles, slot, can, mstate.s[:, :3], xdot[:, :3],
                                   speed=cfg.missile_speed)
        sel = can[:, None] & (torch.arange(K, device=self.device)[None, :] == slot[:, None])
        missile_target = torch.where(sel, perm[:, :, :1].reshape(n, 1).to(torch.int32),
                                     state.missile_target)
        ammo, cooldown = self._rearm(state, can)

        # damage over the locked victims (the targets before this step's
        # launches: a missile cannot hit on its launch step); corpses take
        # nothing; pk grades the warhead under the proximity fuse
        victim_alive = torch.gather(alive_g, 1, tgt).reshape(n, K)
        eff = hits & victim_alive
        pk_eff = pk * victim_alive                                     # [n, K]
        victim = tgt.reshape(E, m, K, 1) == torch.arange(m, device=self.device)
        w_incoming = cfg.missile_damage * (victim * pk_eff.reshape(E, m, K, 1)).sum(dim=(1, 2))
        pk_dealt = pk_eff.sum(dim=1)                                   # [n]
        w_dealt = cfg.missile_damage * pk_dealt.reshape(E, m)
        # the launch cost is shared by the team (teammates' rewards stay equal)
        r_adj = -cfg.missile_shoot_cost * self._team_sum(can.reshape(E, m).float()) / h
        info = {"shoot/launches": can.sum(), "shoot/hits": eff.sum(),
                "shoot/pk_sum": pk_eff.sum(), "shoot/fire_vec": can,
                "shoot/pk_dealt_vec": pk_dealt}
        state = state.replace(missiles=missiles, ammo=ammo, cooldown=cooldown,
                              missile_target=missile_target)
        return state, (w_incoming, w_dealt, r_adj, info)

    def _team_obs(self, state: TeamShootCombatState, xdot: torch.Tensor,
                  alive_g: torch.Tensor, geom=None) -> torch.Tensor:
        base = super()._team_obs(state, xdot, alive_g, geom)
        E, m = self.num_envs, self.num_agents
        mis = state.missiles
        K = mis.active.shape[1]
        pos_g = mis.pos.reshape(E, m * K, 3)
        my_pos = self._group(state.model.s[:, :3])                     # [E, m, 3]
        d = torch.linalg.vector_norm(pos_g[:, None] - my_pos[:, :, None], dim=-1)  # [E, m, mK]
        # (victim, shooter x slot): active missiles locked on the victim
        targeting = (mis.active.reshape(E, 1, m * K)
                     & (state.missile_target.reshape(E, 1, m * K)
                        == torch.arange(m, device=self.device)[None, :, None]))
        keyed = torch.where(targeting, d, torch.inf)
        extra = self._missile_cols(state.ammo.reshape(E, m), keyed, pos_g[:, None].expand(
            E, m, m * K, 3), mis.vel.reshape(E, 1, m * K, 3).expand(E, m, m * K, 3), my_pos,
            self._group(xdot[:, :3]), self._group(state.model.s[:, 5]))
        return torch.cat([base, extra.reshape(self.n, -1)], dim=1)
