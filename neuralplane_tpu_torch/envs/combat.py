"""Self-play combat environments, 1v1 and team against team (counterpart of
neuralplane_tpu/envs/combat.py).

  step(action [n, 4]) =
    env-group masked auto-reset (draws from the env's generator)
    -> inner_steps x { demand smoothing -> PID stabilize -> throttle lag
                       -> raw_control_update (Euler) }      (5 for 1v1, 1 nvn)
    -> extended_state once more; blood damage, obs, reward, terminations

Each inner step evaluates the state derivative twice (the controller's
measurements, then the integration), and the step once more after the
loop: on a fused aero backend that is 2 * inner_steps + 1 launches of the
xdot kernel per step (11 for 1v1, 3 for the team game), and never the
control envs' step kernel. `jax.lax.scan` over the inner steps is a Python
loop; nothing in the step reads a value back to the host (the `info`
counts are 0-d device tensors, the index tables are made once per env on
its device).

Team layout: within each env group of M agents, the first M/2 are the ego
team and the last M/2 the enemy team; agent i pairs with agent i + M/2
(for M = 2 the reference's even/odd interleave). The team game's one-hot
contractions over the group axis of the JAX package are gathers here: a
one-hot product selects exactly, so the selections agree bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..algorithms.pid import Controller, ControllerState, flight_data
from ..models.f16 import F16Model, F16State, THRUST_SCALE
from ..ops.aero import select_aero_weights
from ..utils.config import EnvConfig, load_config
from ..utils.math import (PI, distance_fn, get2d_AO_TA_R, get_AO_TA_R, orientation_fn,
                          orientation_reward, range_reward, wrap_PI)
from . import terminations as X
from .types import StepOutput

FT = 0.3048


@dataclasses.dataclass
class CombatState:
    model: F16State
    controller: ControllerState
    blood: torch.Tensor               # [n]
    step_count: torch.Tensor          # [n] int32
    is_done: torch.Tensor
    bad_done: torch.Tensor
    exceed_time_limit: torch.Tensor

    def replace(self, **kw) -> "CombatState":
        return dataclasses.replace(self, **kw)


def _combine(conds):
    """OR the (bad, done, exceed) triples; count each condition's rows."""
    bad = functools.reduce(torch.logical_or, [c[0] for _, c in conds])
    done = functools.reduce(torch.logical_or, [c[1] for _, c in conds])
    exceed = functools.reduce(torch.logical_or, [c[2] for _, c in conds])
    info = {f"termination/{name}": (b | d | e).sum() for name, (b, d, e) in conds}
    return done, bad, exceed, info


def _tree_from_jax(like, jtree, t):
    """A port state with the structure of `like` (nested dataclasses) from
    the JAX struct of the same field names, its leaves through `t`."""
    if dataclasses.is_dataclass(like):
        return type(like)(**{f.name: _tree_from_jax(getattr(like, f.name),
                                                     getattr(jtree, f.name), t)
                             for f in dataclasses.fields(like)})
    return t(jtree).to(like.dtype)


class SingleCombatEnv:
    """1v1 self-play combat; `MultipleCombatEnv` subclasses it for nvn."""

    inner_steps = 5  # FDM steps per env step

    def __init__(self, num_envs: int = 1, config: str | EnvConfig = "selfplay",
                 aero_backend: str = "auto", device="cuda"):
        self.device = torch.device(device)
        self.config = config if isinstance(config, EnvConfig) else load_config(config)
        self.num_envs = num_envs
        self.num_agents = self.config.num_agents
        assert self.num_agents % 2 == 0, "combat needs an even team split"
        self.n = num_envs * self.num_agents
        self.model = F16Model(self.config, select_aero_weights(aero_backend, self.device))
        self.controller = Controller(dt=self.config.dt)
        self.num_observation = self.config.num_observation  # 15
        self.num_actions = self.config.num_actions          # 4
        self.generator: Optional[torch.Generator] = None
        m, dev = self.num_agents, self.device
        base = torch.arange(num_envs, device=dev)[:, None] * m
        # each agent's paired opponent, and whether it is on the ego team
        self._opp = (base + (torch.arange(m, device=dev) + m // 2) % m).reshape(-1)
        self._is_ego = (torch.arange(self.n, device=dev) % m) < (m // 2)
        self._u_init = torch.zeros((1, self.model.num_controls), device=dev)
        self._u_init[0, 0] = self.config.init_T

    # --- lifecycle ---
    def init_state(self) -> CombatState:
        n, dev = self.n, self.device
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        return CombatState(
            model=self.model.init_state(n, dev),
            controller=self.controller.init_state(n, dev),
            blood=torch.full((n,), self.config.max_blood, dtype=torch.float32, device=dev),
            step_count=torch.zeros(n, dtype=torch.int32, device=dev),
            is_done=ones, bad_done=ones, exceed_time_limit=ones)

    def _masked_reset(self, state: CombatState) -> CombatState:
        """Whole-group reset of every env group with a raised flag: uniform
        draws of north, east, altitude, heading and speed for every row,
        selected where the group is flagged."""
        cfg, n, gen, dev = self.config, self.n, self.generator, self.device
        any_flag = state.is_done | state.bad_done | state.exceed_time_limit
        group = any_flag.reshape(self.num_envs, self.num_agents).any(dim=1)
        mask = group[:, None].expand(-1, self.num_agents).reshape(-1)

        def U(lo, hi):
            return lo + torch.rand(n, generator=gen, device=dev) * (hi - lo)
        npos, epos = U(cfg.min_npos, cfg.max_npos), U(cfg.min_epos, cfg.max_epos)
        alt, hdg = U(cfg.min_altitude, cfg.max_altitude), U(cfg.min_heading, cfg.max_heading)
        vt = U(cfg.min_vt, cfg.max_vt)
        z = torch.zeros_like(npos)
        s_new = torch.stack([npos, epos, alt, z, z, hdg, vt, z, z, z, z, z], dim=1)
        m = mask[:, None]
        s = torch.where(m, s_new, state.model.s)
        u = torch.where(m, self._u_init, state.model.u)
        mstate = F16State(s=s, u=u, recent_s=torch.where(m, s, state.model.recent_s),
                          recent_u=torch.where(m, u, state.model.recent_u))
        zeros = torch.zeros_like(state.is_done)
        # replace() keeps a subclass's extra fields; _reset_extras resets them
        new = state.replace(
            model=mstate, controller=self.controller.reset(state.controller, mask),
            blood=torch.where(mask, self.config.max_blood, state.blood),
            step_count=torch.where(mask, 0, state.step_count),
            is_done=zeros, bad_done=zeros, exceed_time_limit=zeros)
        return self._reset_extras(new, mask)

    def _reset_extras(self, state: CombatState, mask: torch.Tensor) -> CombatState:
        """Subclass hook: reset a subclass's per-agent state on the masked
        rows (the missile envs' ammo, cooldown and missiles)."""
        return state

    def reset(self, seed: int = 0) -> Tuple[CombatState, torch.Tensor]:
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        state = self._masked_reset(self.init_state())
        return state, self._obs(state, self.model.extended_state(state.model))

    # --- observation ---
    def _pair_geometry(self, mstate, xdot: torch.Tensor, planar: bool):
        """(AO, TA, R, side) of each agent against its opponent; enemy rows
        get the reference's role-swapped side flag unless the config asks
        for the symmetric one (AO and TA need no swap: pi - TA_e == AO)."""
        opp = self._opp
        pos, vel = mstate.s[:, :3], xdot[:, :3]
        fn = get2d_AO_TA_R if planar else get_AO_TA_R
        AO, TA, R, side = fn(pos, pos[opp], vel, vel[opp], return_side=True)
        if self.config.symmetric_side_flag:
            return AO, TA, R, side
        dpos = pos[opp] - pos
        cross_z_opp = vel[opp][:, 0] * dpos[:, 1] - vel[opp][:, 1] * dpos[:, 0]
        return AO, TA, R, torch.where(self._is_ego, side, torch.sign(cross_z_opp))

    def _obs(self, state: CombatState, xdot: torch.Tensor) -> torch.Tensor:
        s = state.model.s
        opp = self._opp
        vu, vv, vw = self.model.get_velocity(state.model)
        AO, TA, R, side = self._pair_geometry(state.model, xdot, planar=True)
        return torch.stack([
            s[:, 2] * FT / 5000.0,
            torch.sin(s[:, 3]), torch.cos(s[:, 3]),
            torch.sin(s[:, 4]), torch.cos(s[:, 4]),
            vu * FT / 340.0, vv * FT / 340.0, vw * FT / 340.0,
            s[:, 6] * FT / 340.0,
            (vu[opp] - vu) * FT / 340.0,
            (s[opp, 2] - s[:, 2]) * FT / 1000.0,
            AO, TA,
            R * FT / 10000.0,
            side,
        ], dim=1)

    def _posture_reward(self, AO, TA, R) -> torch.Tensor:
        return 0.01 * orientation_reward(AO, TA) * range_reward(self.config.target_dist,
                                                                 R * FT / 1000.0)

    def _termination(self, state: CombatState, xdot: torch.Tensor):
        cfg, model, mstate = self.config, self.model, state.model
        opp = self._opp
        return _combine([
            ("overload", X.overload(cfg, model, mstate, xdot)),
            ("low_altitude", X.low_altitude(cfg, model, mstate)),
            ("high_speed", X.high_speed(cfg, model, mstate)),
            ("low_speed", X.low_speed(cfg, model, mstate)),
            ("extreme_state", X.extreme_state(cfg, model, mstate)),
            ("crash", X.crash(cfg, mstate.s[:, :3], mstate.s[opp, :3])),
            ("timeout", X.timeout(cfg, state.step_count)),
            ("shutdown", X.shutdown(cfg, state.blood, state.blood[opp])),
        ])

    # --- inner FDM/PID loop (shared by the 1v1 and nvn steps) ---
    def _inner_fdm(self, action: torch.Tensor, mstate: F16State, cst: ControllerState):
        """inner_steps of demand smoothing -> PID stabilize -> throttle lag
        -> Euler step. The yaw-rate demand stays 0: the rudder loop damps
        the yaw rate (the reference sets a yaw_dem it never reads)."""
        model = self.model
        for _ in range(self.inner_steps):
            xdot = model.extended_state(mstate)
            data = flight_data(model, mstate, xdot)
            cst = cst.replace(
                roll_dem=0.9 * cst.roll_dem + 0.1 * action[:, 1] * 4 * PI / 9,
                pitch_dem=0.9 * cst.pitch_dem + 0.1 * action[:, 2] * PI / 12,
                yaw_dem=wrap_PI(mstate.s[:, 5] + action[:, 3] * PI / 60))
            cst = self.controller.stabilize(cst, data)
            T = 0.9 * mstate.u[:, 0] + 0.1 * action[:, 0] * THRUST_SCALE
            u = torch.stack([T, -cst.el, -cst.ail, -cst.rud, torch.zeros_like(T)], dim=1)
            mstate = model.raw_control_update(mstate, u)
        return mstate, cst

    # --- action decode (a subclass hook) ---
    def _decode(self, action: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(flight demands [n, 4] in [-1, 1], fire bits [n] or None); the
        guns-only envs clamp the continuous action and have no fire bit."""
        return torch.clamp(action, -1.0, 1.0), None

    # --- step ---
    @torch.no_grad()
    def step(self, state: CombatState, action: torch.Tensor
             ) -> Tuple[CombatState, StepOutput]:
        if self.generator is None:
            raise RuntimeError("call reset(seed) before step()")
        state = self._masked_reset(state)
        action, _ = self._decode(action)
        mstate, cst = self._inner_fdm(action, state.model, state.controller)
        xdot = self.model.extended_state(mstate)

        # blood: the damage each agent deals (its own AO) comes off its opponent
        AO, TA, R, _ = self._pair_geometry(mstate, xdot, planar=False)
        dmg = orientation_fn(AO) * distance_fn(R * FT / 1000.0)
        new_state = state.replace(model=mstate, controller=cst,
                                  blood=state.blood - dmg[self._opp],
                                  step_count=state.step_count + 1)
        obs = self._obs(new_state, xdot)
        done, bad, exceed, info = self._termination(new_state, xdot)
        reward = self._posture_reward(AO, TA, R)
        new_state = new_state.replace(is_done=done, bad_done=bad, exceed_time_limit=exceed)
        return new_state, StepOutput(obs=obs, reward=reward, done=done, bad_done=bad,
                                     exceed_time_limit=exceed, info=info)

    def state_from_jax(self, jstate) -> CombatState:
        """Carry a JAX CombatState, its leaves as numpy (e.g.
        `jax.tree.map(np.asarray, state)`), into the port on this env's
        device; the PRNG key stays behind. For tests; the runtime does not
        use it."""
        return _tree_from_jax(self.init_state(), jstate,
                              lambda a: torch.as_tensor(np.array(a)).to(self.device))


class MultipleCombatEnv(SingleCombatEnv):
    """nvn team combat, guns only (the JAX package's team game):

    - obs [9 + 7*(h-1) + 7*h] for team size h = num_agents/2: the 1v1 ego
      block (9 dims), then a 7-dim block per teammate (fixed order) and per
      enemy (nearest alive first): [delta_v_body_x, delta_alt, AO, TA, R,
      side_flag, alive], dead blocks zeroed with alive = 0;
    - blood <= 0 freezes that agent where it died; the episode runs until a
      whole team is wiped; `StepOutput.active` carries liveness;
    - each alive agent damages its nearest alive enemy;
    - the reward is shared by a team: mean alive-masked posture toward each
      agent's nearest alive enemy, + 0.1/h * (damage dealt - taken), +-200
      on a team wipe;
    - physical terminations and crash apply to alive agents; shutdown is the
      team-wipe win/lose split.

    Geometry is group-local ([E, m, m] all pairs). `_split_action` and
    `_weapon_phase` are the hooks of the missile team game
    (envs/combat_shoot.py); here they decode nothing and add nothing.
    """

    inner_steps = 1

    def __init__(self, num_envs: int = 1, config: str | EnvConfig = "multiple_selfplay",
                 aero_backend: str = "auto", device="cuda"):
        super().__init__(num_envs, config, aero_backend=aero_backend, device=device)
        m = self.num_agents
        h = self.half = m // 2
        # 9 ego dims + 7 per teammate + 7 per enemy
        self.num_observation = 9 + 7 * (h - 1) + 7 * h
        mates = [[j for j in (range(h) if i < h else range(h, m)) if j != i]
                 for i in range(m)]
        enemies = [list(range(h, m) if i < h else range(h)) for i in range(m)]
        dev = self.device
        self._mates = torch.tensor(mates, dtype=torch.long, device=dev).reshape(m, h - 1)
        self._enemies = torch.tensor(enemies, dtype=torch.long, device=dev)
        self._own_rows = torch.arange(m, device=dev) < h          # [m]
        self._off_diag = ~torch.eye(m, dtype=torch.bool, device=dev)

    def _group(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.num_envs, self.num_agents, *x.shape[1:])

    def _obs(self, state: CombatState, xdot: torch.Tensor) -> torch.Tensor:
        """Team obs from the current liveness (reset() calls this)."""
        return self._team_obs(state, xdot, self._group(state.blood > 0.0))

    @staticmethod
    def _all_pairs_both(pos_g: torch.Tensor, vel_g: torch.Tensor):
        """Planar and 3-D all-pairs geometry over one shared delta: entry
        (i, j) is agent i's geometry toward agent j. Returns
        ((AO2, TA2, R2, side), (AO3, TA3, R3)), each [E, m, m]."""
        delta = pos_g[:, None, :, :] - pos_g[:, :, None, :]   # [E,m,m,3]
        d2 = delta[..., 0] ** 2 + delta[..., 1] ** 2
        R2 = torch.sqrt(d2)
        R3 = torch.sqrt(d2 + delta[..., 2] ** 2)
        v2 = torch.sqrt(vel_g[..., 0] ** 2 + vel_g[..., 1] ** 2)
        v3 = torch.linalg.vector_norm(vel_g, dim=-1)

        def angles(d, v_g, R, v):
            AO = torch.arccos(torch.clamp(
                (d * v_g[:, :, None, :]).sum(-1) / (R * v[:, :, None] + 1e-8), -1.0, 1.0))
            TA = torch.arccos(torch.clamp(
                (d * v_g[:, None, :, :]).sum(-1) / (R * v[:, None, :] + 1e-8), -1.0, 1.0))
            return AO, TA

        AO2, TA2 = angles(delta[..., :2], vel_g[..., :2], R2, v2)
        AO3, TA3 = angles(delta, vel_g, R3, v3)
        cross = vel_g[:, :, None, 0] * delta[..., 1] - vel_g[:, :, None, 1] * delta[..., 0]
        return (AO2, TA2, R2, torch.sign(cross)), (AO3, TA3, R3)

    def _nearest_enemy_perm(self, R: torch.Tensor, alive_g: torch.Tensor):
        """Per-agent enemy order, nearest alive first: [E, m, h] in-group
        enemy indices and the sorted keys (dead enemies at +inf). For h <= 4
        a compare-exchange network with strict-less swaps (a stable sort, as
        the JAX package's), beyond that a stable torch.sort."""
        h = self.half
        E = R.shape[0]
        R_en = torch.cat([R[:, :h, h:], R[:, h:, :h]], dim=1)          # [E, m, h]
        alive_en = torch.cat([alive_g[:, None, h:].expand(E, h, h),
                              alive_g[:, None, :h].expand(E, h, h)], dim=1)
        key = torch.where(alive_en, R_en, torch.inf)
        idx = self._enemies[None].expand(key.shape)
        if h <= 4:
            ks = [key[..., i] for i in range(h)]
            vs = [idx[..., i] for i in range(h)]
            for end in range(h - 1, 0, -1):
                for i in range(end):
                    swap = ks[i + 1] < ks[i]
                    ks[i], ks[i + 1] = (torch.where(swap, ks[i + 1], ks[i]),
                                        torch.where(swap, ks[i], ks[i + 1]))
                    vs[i], vs[i + 1] = (torch.where(swap, vs[i + 1], vs[i]),
                                        torch.where(swap, vs[i], vs[i + 1]))
            return torch.stack(vs, dim=-1), torch.stack(ks, dim=-1)
        key_sorted, order = torch.sort(key, dim=-1, stable=True)
        return torch.gather(idx, -1, order), key_sorted

    def _team_sum(self, x: torch.Tensor) -> torch.Tensor:
        """[E, m] -> each agent's team total, [E, m]."""
        h, own = self.half, self._own_rows[None, :]
        return x[:, :h].sum(1)[:, None] * own + x[:, h:].sum(1)[:, None] * ~own

    # --- subclass hooks (weapons) ---
    def _split_action(self, action: torch.Tensor):
        """(flight demands [n, 4] in [-1, 1], fire bits [n] or None); the
        guns-only team game has no fire bit."""
        return self._decode(action)

    def _weapon_phase(self, state: CombatState, mstate, xdot: torch.Tensor,
                      alive_g: torch.Tensor, fire, perm, key_sorted, AO_t):
        """Between the FDM step and the blood accounting: `AO_t` [E, m] is
        each agent's angle-off toward its nearest alive enemy
        (`perm[:, :, 0]`). Returns (state, weapon): weapon is None when the
        game has no weapons beyond the guns, else (extra damage taken [E, m],
        extra damage dealt [E, m], reward adjustment [E, m], info dict)."""
        return state, None

    def _wiped(self, alive_g: torch.Tensor):
        """(own team wiped, enemy team wiped), each [E, m] from every
        agent's side."""
        h, own = self.half, self._own_rows[None, :]
        own_wiped = ~alive_g[:, :h].any(dim=1)[:, None]
        enm_wiped = ~alive_g[:, h:].any(dim=1)[:, None]
        return (torch.where(own, own_wiped, enm_wiped),
                torch.where(own, enm_wiped, own_wiped))

    @torch.no_grad()
    def step(self, state: CombatState, action: torch.Tensor
             ) -> Tuple[CombatState, StepOutput]:
        if self.generator is None:
            raise RuntimeError("call reset(seed) before step()")
        state = self._masked_reset(state)
        action, fire = self._split_action(action)
        h = self.half
        alive_pre = state.blood > 0.0                                  # [n]

        mstate, cst = self._inner_fdm(action, state.model, state.controller)
        # dead agents are frozen where they died (no flight, no actuator)
        keep = alive_pre[:, None]
        mstate = dataclasses.replace(mstate, s=torch.where(keep, mstate.s, state.model.s),
                                     u=torch.where(keep, mstate.u, state.model.u))
        xdot = self.model.extended_state(mstate)

        alive_g = self._group(alive_pre)
        planar_pack, (AO3, TA3, R3) = self._all_pairs_both(
            self._group(mstate.s[:, :3]), self._group(xdot[:, :3]))
        perm, key_sorted = self._nearest_enemy_perm(R3, alive_g)

        # nearest-alive-threat damage (pre-step liveness on both sides)
        target = perm[:, :, :1]                                        # [E, m, 1]
        has_target = torch.isfinite(key_sorted[:, :, 0])
        AO_t = torch.gather(AO3, 2, target)[..., 0]                    # [E, m]
        TA_t = torch.gather(TA3, 2, target)[..., 0]
        R_t = torch.gather(R3, 2, target)[..., 0]
        dmg = orientation_fn(AO_t) * distance_fn(R_t * FT / 1000.0) * alive_g * has_target
        # damage to each victim, summed over its attackers in agent order
        victim = target == torch.arange(self.num_agents, device=self.device)
        incoming = (victim * dmg[:, :, None]).sum(dim=1)              # [E, m]
        dealt = dmg
        state, weapon = self._weapon_phase(state, mstate, xdot, alive_g, fire, perm,
                                           key_sorted, AO_t)
        if weapon is not None:
            w_incoming, w_dealt, r_adj, w_info = weapon
            incoming, dealt = incoming + w_incoming, dmg + w_dealt
        blood = state.blood - incoming.reshape(-1)
        alive_post = blood > 0.0
        alive_post_g = self._group(alive_post)

        new_state = state.replace(model=mstate, controller=cst, blood=blood,
                                  step_count=state.step_count + 1)
        obs = self._team_obs(new_state, xdot, alive_post_g, geom=(planar_pack, R3))
        done, bad, exceed, info = self._team_termination(new_state, xdot, alive_post_g,
                                                         dist=R3)
        # team-shared reward
        posture = self._posture_reward(AO_t, TA_t, R_t) * alive_g * has_target
        wiped_own, wiped_enm = self._wiped(alive_post_g)
        team = (self._team_sum(posture) + 0.1 * (self._team_sum(dealt)
                                                 - self._team_sum(incoming))) / h
        if weapon is not None:
            team = team + r_adj
            info.update(w_info)
        reward = (team + 200.0 * (wiped_enm & ~wiped_own) - 200.0 * wiped_own).reshape(-1)

        new_state = new_state.replace(is_done=done, bad_done=bad, exceed_time_limit=exceed)
        return new_state, StepOutput(obs=obs, reward=reward, done=done, bad_done=bad,
                                     exceed_time_limit=exceed, info=info,
                                     active=alive_post.float())

    def _team_obs(self, state: CombatState, xdot: torch.Tensor, alive_g: torch.Tensor,
                  geom=None) -> torch.Tensor:
        """Team obs; `geom` = ((AO, TA, R, side) planar, R3) from step(),
        computed here for reset()."""
        E, m, h = self.num_envs, self.num_agents, self.half
        s = state.model.s
        vu, vv, vw = self.model.get_velocity(state.model)
        ego = torch.stack([
            s[:, 2] * FT / 5000.0,
            torch.sin(s[:, 3]), torch.cos(s[:, 3]),
            torch.sin(s[:, 4]), torch.cos(s[:, 4]),
            vu * FT / 340.0, vv * FT / 340.0, vw * FT / 340.0,
            s[:, 6] * FT / 340.0,
        ], dim=1).reshape(E, m, 9)
        if geom is None:
            planar, (_, _, R3) = self._all_pairs_both(self._group(s[:, :3]),
                                                      self._group(xdot[:, :3]))
            geom = (planar, R3)
        (AO, TA, R, side), R3 = geom
        vu_g, alt_g = self._group(vu), self._group(s[:, 2])
        dvx = (vu_g[:, None, :] - vu_g[:, :, None]) * FT / 340.0       # [E,m,m]
        dalt = (alt_g[:, None, :] - alt_g[:, :, None]) * FT / 1000.0
        feats_all = torch.stack([dvx, dalt, AO, TA, R * FT / 10000.0, side], dim=-1)
        alive_f = alive_g.float()

        def block(idx):
            """idx [E, m, k] in-group agent indices -> [E, m, k*7] relative
            blocks, dead blocks zeroed."""
            k = idx.shape[-1]
            feats = torch.gather(feats_all, 2, idx[..., None].expand(E, m, k, 6))
            a_f = torch.gather(alive_f, 1, idx.reshape(E, m * k)).reshape(E, m, k, 1)
            return torch.cat([feats * a_f, a_f], dim=-1).reshape(E, m, k * 7)

        parts = [ego]
        if h > 1:
            parts.append(block(self._mates[None].expand(E, m, h - 1)))
        perm, _ = self._nearest_enemy_perm(R3, alive_g)
        parts.append(block(perm))
        return torch.cat(parts, dim=-1).reshape(self.n, -1)

    def _team_termination(self, state: CombatState, xdot: torch.Tensor,
                          alive_g: torch.Tensor, dist=None):
        cfg, model, mstate = self.config, self.model, state.model
        alive = alive_g.reshape(-1)

        def masked(cond):
            b, d, e = cond
            return b & alive, d & alive, e

        conds = [
            ("overload", masked(X.overload(cfg, model, mstate, xdot))),
            ("low_altitude", masked(X.low_altitude(cfg, model, mstate))),
            ("high_speed", masked(X.high_speed(cfg, model, mstate))),
            ("low_speed", masked(X.low_speed(cfg, model, mstate))),
            ("extreme_state", masked(X.extreme_state(cfg, model, mstate))),
            ("timeout", X.timeout(cfg, state.step_count)),
        ]
        # crash: any alive pair of a group closer than distance_limit
        if dist is None:
            pos_g = self._group(mstate.s[:, :3])
            dist = torch.linalg.vector_norm(pos_g[:, None] - pos_g[:, :, None], dim=-1)
        pair_alive = alive_g[:, :, None] & alive_g[:, None, :]
        close = (dist < cfg.distance_limit) & pair_alive & self._off_diag[None]
        crash_bad = close.any(dim=2).reshape(-1)
        z = torch.zeros_like(crash_bad)
        conds.append(("crash", (crash_bad, z, z)))
        # shutdown: team-wipe win/lose split (the pairwise rule at h = 1)
        wiped_own, wiped_enm = self._wiped(alive_g)
        bad_sd = wiped_own.reshape(-1)
        conds.append(("shutdown", (bad_sd, wiped_enm.reshape(-1) & ~bad_sd, z)))
        return _combine(conds)
