"""MAPPO self-play runner: a centralized critic over the ego team
(counterpart of neuralplane_tpu/runner/mappo.py).

The ego team's observations, concatenated per env and tiled back to each
agent, are the critic's input (share_obs); the active masks follow each
agent's liveness (the team env's `StepOutput.active`: a shot-down agent is
inactive while its group flies on, and a group reset revives everyone); the
batch is a SharedRolloutBatch for the MAPPO trainer, its bootstrap value
taken on the centralized obs. The pool, the ELO eval, the collect loop and
the mesh (`mesh=`) are SelfplayRunner's; the trainer all-reduces the
count of active agents.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..algorithms.mappo import MAPPOPolicy, MAPPOTrainer, SharedRolloutBatch
from ..algorithms.rl_config import RLConfig
from .selfplay import SelfplayCarry, SelfplayRunner, team_split


class MAPPOSelfplayRunner(SelfplayRunner):
    _LAST_ROW = SelfplayRunner._LAST_ROW + ("share_obs", "active_masks")

    def _build_policy(self, env, cfg: RLConfig):
        half = env.num_agents // 2
        policy = MAPPOPolicy(cfg, env.num_observation, env.num_observation * half,
                             env.num_actions, act_space=getattr(env, "action_space", None),
                             prior_slots=getattr(env, "shoot_prior_slots", (11, 13)),
                             device=self.device)
        return policy, MAPPOTrainer(cfg, policy, self.mesh)

    def init_carry(self, seed: int) -> SelfplayCarry:
        carry = super().init_carry(seed)
        carry.active_masks = torch.ones((self.n_ego, 1), dtype=torch.float32,
                                        device=self.device)
        return carry

    def _share_obs(self, ego_obs: torch.Tensor) -> torch.Tensor:
        """The ego team's obs concatenated per env, tiled back per agent."""
        cent = ego_obs.reshape(self.num_envs, 1, -1)
        return cent.expand(self.num_envs, self.half, cent.shape[-1]).reshape(self.n_ego, -1)

    def _ego_actions(self, carry: SelfplayCarry):
        cent_obs = self._share_obs(carry.ego_obs)
        return self.policy.get_actions(cent_obs, carry.ego_obs, carry.h_actor, carry.h_critic,
                                       carry.ego_masks, self.generator) + (
            {"share_obs": cent_obs, "active_masks": carry.active_masks},)

    def _next_active(self, carry: SelfplayCarry, out, reset_env) -> torch.Tensor:
        """Each ego agent's liveness at the next obs (1 - agent done); an env
        group's reset revives everyone. Envs without `active` keep all ones."""
        if out.active is None:
            return torch.ones_like(carry.active_masks)
        return torch.maximum(team_split(self.env, out.active[:, None])[0], reset_env.float())

    def _last_rows(self, carry: SelfplayCarry) -> Dict[str, torch.Tensor]:
        cent = self._share_obs(carry.ego_obs)
        return {"obs": carry.ego_obs, "masks": carry.ego_masks, "bad_masks": carry.bad_masks,
                "share_obs": cent, "active_masks": carry.active_masks,
                "value_preds": self.policy.get_values(cent, carry.h_critic, carry.ego_masks)}

    def _batch(self, steps: Dict[str, torch.Tensor], h0_a, h0_c) -> SharedRolloutBatch:
        return SharedRolloutBatch(**steps, rnn_states_actor=h0_a, rnn_states_critic=h0_c)
