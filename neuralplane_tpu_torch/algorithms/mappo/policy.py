"""MAPPO policy: a decentralized actor and a centralized critic
(counterpart of neuralplane_tpu/algorithms/mappo/policy.py).

The actor is the PPO policy's, of every action space it supports (the Box
actor, or HeadActor with the shoot head and its Beta launch prior); the
critic reads the centralized observation (share_obs, the concatenation of
the ego team's observations). The state_dict is "actor.*" / "critic.*", so a
JAX MAPPO TrainState maps through `networks.params_from_jax`, and its actor
alone is the same tree as a PPO actor's.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ppo.policy import PPOPolicy
from ..rl_config import RLConfig


class MAPPOPolicy(PPOPolicy):
    def __init__(self, cfg: RLConfig, obs_dim: int, share_obs_dim: int,
                 act_dim: Optional[int] = None, act_space=None, prior_slots=(11, 13),
                 device="cuda"):
        super().__init__(cfg, obs_dim, act_dim, act_space, prior_slots, device,
                         critic_obs_dim=share_obs_dim)

    # ---- rollout ----
    def get_actions(self, cent_obs, obs, h_actor, h_critic, masks,
                    generator: torch.Generator):
        """Returns (values, actions, action_log_probs, h_actor, h_critic)."""
        dist, h_actor = self.actor.dist_step(obs, h_actor, masks)
        actions = dist.sample(generator)
        logp = dist.log_prob(actions)
        values, h_critic = self.critic.step(cent_obs, h_critic, masks)
        return values, actions, logp, h_actor, h_critic

    def get_values(self, cent_obs, h_critic, masks) -> torch.Tensor:
        return self.critic.step(cent_obs, h_critic, masks)[0]

    # ---- training ----
    def evaluate_actions(self, cent_obs, obs, h0_actor, h0_critic, actions, masks):
        """Chunk tensors [L, N, ...]; returns (values, action_log_probs,
        dist_entropy), each [L, N, 1]."""
        dist = self.actor.dist_seq(obs, h0_actor, masks)
        values, _ = self.critic.seq(cent_obs, h0_critic, masks)
        return values, dist.log_prob(actions), dist.entropy()
