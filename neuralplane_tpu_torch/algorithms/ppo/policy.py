"""PPO policy: actor and critic modules with the rollout and training
forwards (counterpart of neuralplane_tpu/algorithms/ppo/policy.py:52-146).

The same entry points (init_actor_params / init_params / init_rnn_states /
get_actions / get_values / act / evaluate_actions). The modules hold the
parameters; sampling takes an explicit torch.Generator on the policy's
device. The joint Adam over actor and critic belongs to PPOTrainer, as in
the JAX package.

Action spaces: Box (DiagGaussian) is `networks.Actor`, the fused
mean-and-log_std actor; Discrete / MultiBinary / MultiDiscrete / ShootTuple
are `heads.HeadActor` (trunk, act_mlp, generic head), with the Beta launch
prior of the shoot head when `cfg.use_prior` is set, keyed on the obs slots
`prior_slots` (the env's `shoot_prior_slots`). Both actors return their
distribution from `dist_step` / `dist_seq`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .. import networks as nets
from ..heads import HeadActor
from ..rl_config import RLConfig
from ..utils.spaces import Box, ShootTuple
from ...utils.profiling import span


class PPOPolicy(nn.Module):
    """`actor` and `critic` modules; state_dict keys "actor.*", "critic.*"
    (the layout of the JAX package's {"actor": ..., "critic": ...} params).
    `critic_obs_dim` is the critic's input width: obs_dim, unless a
    centralized critic reads another input (MAPPOPolicy's share_obs)."""

    def __init__(self, cfg: RLConfig, obs_dim: int, act_dim: Optional[int] = None,
                 act_space=None, prior_slots=(11, 13), device="cuda",
                 critic_obs_dim: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.act_space = act_space if act_space is not None else Box((act_dim,))
        self.is_box = isinstance(self.act_space, Box)
        self.use_prior = cfg.use_prior and isinstance(self.act_space, ShootTuple)
        # (AO, R) obs slots of the Beta launch prior: layout-dependent (1v1
        # 11 / 13, the team game's nearest-enemy block), so the runners pass
        # the env's `shoot_prior_slots`
        self.prior_slots = tuple(prior_slots)
        self.device = torch.device(device)
        self.spec = nets.NetSpec.from_config(cfg, obs_dim, self.act_space.dim)
        self.critic_spec = (self.spec if critic_obs_dim is None else
                            nets.NetSpec.from_config(cfg, critic_obs_dim, self.act_space.dim))
        g = torch.Generator().manual_seed(cfg.seed)
        self.actor = self.init_actor_params(g)
        self.critic = nets.Critic(self.critic_spec, g)
        self.to(self.device)

    # ---- lifecycle ----
    def init_actor_params(self, generator: torch.Generator) -> nn.Module:
        """A new actor module alone, drawn from `generator` (on the CPU; move
        it with `.to`): `networks.Actor` for a Box space, else HeadActor. The
        self-play runner's frozen opponents are actors of this kind."""
        if self.is_box:
            return nets.Actor(self.spec, generator)
        return HeadActor(self.spec, self.act_space, generator, self.use_prior,
                         self.prior_slots)

    def init_params(self, generator: torch.Generator) -> None:
        """Draw fresh parameters from a CPU generator (the same values on
        every device)."""
        self.actor.init_(generator)
        self.critic.init_(generator)

    def init_rnn_states(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        h = nets.init_rnn_state(n, self.spec, self.device)
        return h, h.clone()

    # ---- rollout ----
    def get_actions(self, obs, h_actor, h_critic, masks, generator: torch.Generator):
        """Returns (values, actions, action_log_probs, h_actor, h_critic)."""
        with span("policy.act"):
            dist, h_actor = self.actor.dist_step(obs, h_actor, masks)
            actions = dist.sample(generator)
            logp = dist.log_prob(actions)
            values, h_critic = self.critic.step(obs, h_critic, masks)
        return values, actions, logp, h_actor, h_critic

    def get_values(self, obs, h_critic, masks) -> torch.Tensor:
        return self.critic.step(obs, h_critic, masks)[0]

    def act(self, obs, h_actor, masks, generator: Optional[torch.Generator] = None,
            deterministic: bool = True):
        """Returns (actions, h_actor); deterministic -> the distribution's mode."""
        dist, h_actor = self.actor.dist_step(obs, h_actor, masks)
        if deterministic:
            return dist.mode(), h_actor
        return dist.sample(generator), h_actor

    # ---- training (sequence mode over recurrent chunks) ----
    def evaluate_actions(self, obs, h0_actor, h0_critic, actions, masks):
        """Chunk tensors are [L, N, ...]; h0 are [N, layers, hidden].

        Returns (values, action_log_probs, dist_entropy), each [L, N, 1].
        """
        dist = self.actor.dist_seq(obs, h0_actor, masks)
        values, _ = self.critic.seq(obs, h0_critic, masks)
        return values, dist.log_prob(actions), dist.entropy()
