"""Hierarchical planning env: high-level targets flown by a frozen low-level
control policy (counterpart of neuralplane_tpu/envs/planning.py:37-155).

The high-level action (d_pitch, d_heading, d_vt) in [-1, 1] sets targets
around the state after the masked reset: pitch + 0.3 a0, heading + 0.3 a1,
vt + 30 a2. An inner Python loop then runs `low_level_steps` (default 50)
control steps, each one:
  1. the noise-free 22-dim control observation (wrapped pitch and heading
     errors, the speed error as Mach, then the shared vehicle tail);
  2. the frozen GRU actor's deterministic mean (masks of ones);
  3. `model.update` (on the F-16, one xdot kernel per Euler step);
  4. rows flagged earlier in the loop rolled back to their previous s and u
     and frozen (recent_* come from the new state, as in the JAX package);
  5. step_count + 1;
  6. `model.extended_state` (a second xdot at the post-step state) and the
     tracking task's termination checks, ORed into the flags.
Then one observation and one reward of the tracking task. Nothing in the
loop reads a value back to the host.

The state is an agent-major F16State with recent_*: the planning step never
takes the fused step kernel, whatever the backend. The low-level actor is
the port's Actor on the env's device, with requires_grad off, run under
torch.no_grad(). Its parameters come from `low_level_params` (a JAX param
tree, a port state_dict, or a whole checkpoint's contents), else from
`config.low_level_ckpt` (a JAX pickle or a port `.pt`), else a random init
from a torch.Generator seeded 0 (its values differ from the JAX package's
`init_actor(PRNGKey(0))`, as every random stream of the port does).
"""
from __future__ import annotations

import dataclasses
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..algorithms.networks import (Actor, NetSpec, first_mismatch, init_rnn_state,
                                   params_from_jax)
from ..algorithms.rl_config import RLConfig
from ..utils.checkpoint import load_checkpoint, load_jax_pickle
from ..utils.config import EnvConfig
from ..utils.math import wrap_PI
from .base import Env
from .tasks.base import vehicle_obs_tail
from .types import EnvState, StepOutput

FT = 0.3048


@dataclasses.dataclass
class PlanningState:
    env: EnvState
    h_low: torch.Tensor   # the low-level actor's GRU state [n, layers, H]


def actor_state_dict(params) -> Dict[str, torch.Tensor]:
    """The low-level actor's state_dict from what a caller or a checkpoint
    holds: a JAX actor param tree, a JAX {"actor", "critic"} tree, a JAX
    checkpoint ({"train_state": TrainState}, `train.py:184-194`), a port
    actor state_dict, a port policy state_dict ("actor.*" keys) or a port
    checkpoint ({"policy": ...})."""
    if isinstance(params, dict) and "train_state" in params:
        params = params["train_state"].params["actor"]
    elif isinstance(params, dict) and "policy" in params:
        params = params["policy"]
    elif isinstance(params, dict) and isinstance(params.get("actor"), dict):
        params = params["actor"]
    if all(isinstance(v, torch.Tensor) for v in params.values()):
        if any(k.startswith("actor.") for k in params):
            return {k[len("actor."):]: v for k, v in params.items()
                    if k.startswith("actor.")}
        return dict(params)
    return params_from_jax(params)


def load_low_level_ckpt(path: str) -> Dict[str, torch.Tensor]:
    """The actor of a checkpoint file: a port `.pt` (torch.save) or a JAX
    package pickle, read without JAX."""
    blob = load_checkpoint(path) if zipfile.is_zipfile(path) else load_jax_pickle(path)
    return actor_state_dict(blob)


class PlanningEnv(Env):
    """Tracking task driven by (d_pitch, d_heading, d_vt) high-level actions."""

    def __init__(self, num_envs: int = 1, config: str | EnvConfig = "tracking",
                 model: str = "F16", low_level_params=None,
                 low_level_cfg: Optional[RLConfig] = None, aero_backend: str = "auto",
                 device="cuda"):
        super().__init__(num_envs, config=config, task="tracking", model=model,
                         aero_backend=aero_backend, device=device)
        self.low_level_steps = self.config.low_level_steps
        self.low_spec = NetSpec.from_config(low_level_cfg or RLConfig(), obs_dim=22,
                                            act_dim=4)
        if low_level_params is None and self.config.low_level_ckpt:
            low_level_params = load_low_level_ckpt(self.config.low_level_ckpt)
        actor = Actor(self.low_spec, torch.Generator().manual_seed(0))
        if low_level_params is not None:
            params = actor_state_dict(low_level_params)
            bad = first_mismatch(params, actor.state_dict())
            if bad is not None:
                raise ValueError("low-level parameters do not match the low-level "
                                 f"actor ({self.low_spec}): first difference at {bad}")
            actor.load_state_dict(params)
        self.low_actor = actor.to(self.device).requires_grad_(False)

    @property
    def fused(self) -> bool:
        """Never: the frozen actor runs between the xdot evaluations."""
        return False

    @property
    def num_actions(self) -> int:
        return 3   # (d_pitch, d_heading, d_vt)

    def init_planning_state(self) -> PlanningState:
        return PlanningState(env=self.init_state(),
                             h_low=init_rnn_state(self.n, self.low_spec, self.device))

    def reset(self, seed: int = 0) -> Tuple[PlanningState, torch.Tensor]:
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        fresh = self.init_planning_state()
        state = self._masked_reset(fresh.env)
        obs = self.task.get_obs(self.model, state.model, state.task, self.generator)
        return PlanningState(env=state, h_low=fresh.h_low), obs

    def _low_level_obs(self, mstate, target_pitch, target_heading, target_vt):
        """The 22-dim control observation, noise-free (planning.py:90-101)."""
        _, pitch, heading = self.model.get_posture(mstate)
        vt = self.model.get_vt(mstate)
        head = torch.stack([wrap_PI(pitch - target_pitch),
                            wrap_PI(heading - target_heading),
                            (vt - target_vt) * FT / 340.0], dim=1)
        return torch.cat([head, vehicle_obs_tail(self.model, mstate)], dim=1)

    @torch.no_grad()
    def step(self, state: PlanningState, action: torch.Tensor
             ) -> Tuple[PlanningState, StepOutput]:
        if self.generator is None:
            raise RuntimeError("call reset(seed) before step()")
        model, task = self.model, self.task
        prev = state.env
        estate = self._masked_reset(prev)
        # fresh low-level memory for re-initialized rows
        reset_mask = prev.is_done | prev.bad_done | prev.exceed_time_limit
        h_low = state.h_low * (~reset_mask).float()[:, None, None]

        action = torch.clamp(action, -1.0, 1.0)
        _, pitch, yaw = model.get_posture(estate.model)
        vt = model.get_vt(estate.model)
        target_pitch = pitch + action[:, 0] * 0.3
        target_heading = yaw + action[:, 1] * 0.3
        target_vt = vt + action[:, 2] * 30.0

        mstate, step_count = estate.model, estate.step_count
        done = torch.zeros_like(estate.is_done)
        bad, exceed = done.clone(), done.clone()
        ones = torch.ones((self.n, 1), dtype=torch.float32, device=self.device)
        for _ in range(self.low_level_steps):
            obs_low = self._low_level_obs(mstate, target_pitch, target_heading, target_vt)
            mean, _, h_low = self.low_actor.step(obs_low, h_low, ones)
            new = model.update(mstate, mean)
            # roll back and freeze rows flagged earlier in the loop
            frozen = (done | bad | exceed)[:, None]
            mstate = dataclasses.replace(new, s=torch.where(frozen, mstate.s, new.s),
                                         u=torch.where(frozen, mstate.u, new.u))
            step_count = step_count + 1
            xdot = model.extended_state(mstate)
            d, b, e, _ = task.get_termination(model, mstate, xdot, step_count,
                                              estate.task)
            done, bad, exceed = done | d, bad | b, exceed | e

        obs = task.get_obs(model, mstate, estate.task, self.generator)
        reward = task.get_reward(model, mstate, estate.task, done, bad)
        new_env = EnvState(model=mstate, task=estate.task, step_count=step_count,
                           is_done=done, bad_done=bad, exceed_time_limit=exceed)
        out = StepOutput(obs=obs, reward=reward, done=done, bad_done=bad,
                         exceed_time_limit=exceed)
        return PlanningState(env=new_env, h_low=h_low), out

    def state_from_jax(self, jstate) -> PlanningState:
        """Carry a JAX PlanningState (leaves as numpy) into the port; see
        Env.state_from_jax."""
        return PlanningState(env=super().state_from_jax(jstate.env),
                             h_low=torch.as_tensor(np.array(jstate.h_low)).to(self.device))
