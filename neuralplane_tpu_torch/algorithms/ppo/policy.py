"""PPO policy: actor and critic modules with the rollout and training
forwards (counterpart of neuralplane_tpu/algorithms/ppo/policy.py:52-146).

The same entry points (init_params / init_rnn_states / get_actions /
get_values / act / evaluate_actions). The modules hold the parameters;
sampling takes an explicit torch.Generator on the policy's device. The joint
Adam over actor and critic belongs to PPOTrainer, as in the JAX package.

Action spaces: Box (DiagGaussian, the control default). The other spaces
need the generic heads of neuralplane_tpu/algorithms/heads.py, which the
port does not have yet (ROADMAP.md section 1, item 7, with Slice E); they
raise NotImplementedError.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .. import networks as nets
from ..rl_config import RLConfig
from ..utils.distributions import DiagGaussian
from ..utils.spaces import Box


class PPOPolicy(nn.Module):
    """`actor` and `critic` modules; state_dict keys "actor.*", "critic.*"
    (the layout of the JAX package's {"actor": ..., "critic": ...} params)."""

    def __init__(self, cfg: RLConfig, obs_dim: int, act_dim: Optional[int] = None,
                 act_space=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.act_space = act_space if act_space is not None else Box((act_dim,))
        if not isinstance(self.act_space, Box):
            raise NotImplementedError(
                f"action space {self.act_space!r}: the port has the Box "
                "(DiagGaussian) head only; the discrete and shoot heads "
                "(algorithms/heads.py) are ROADMAP.md section 1, item 7, ported "
                "with Slice E")
        self.device = torch.device(device)
        self.spec = nets.NetSpec.from_config(cfg, obs_dim, self.act_space.dim)
        g = torch.Generator().manual_seed(cfg.seed)
        self.actor = nets.Actor(self.spec, g)
        self.critic = nets.Critic(self.spec, g)
        self.to(self.device)

    # ---- lifecycle ----
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
        mean, log_std, h_actor = self.actor.step(obs, h_actor, masks)
        dist = DiagGaussian(mean, log_std)
        actions = dist.sample(generator)
        logp = dist.log_prob(actions)
        values, h_critic = self.critic.step(obs, h_critic, masks)
        return values, actions, logp, h_actor, h_critic

    def get_values(self, obs, h_critic, masks) -> torch.Tensor:
        return self.critic.step(obs, h_critic, masks)[0]

    def act(self, obs, h_actor, masks, generator: Optional[torch.Generator] = None,
            deterministic: bool = True):
        """Returns (actions, h_actor); deterministic -> the distribution's mode."""
        mean, log_std, h_actor = self.actor.step(obs, h_actor, masks)
        dist = DiagGaussian(mean, log_std)
        if deterministic:
            return dist.mode(), h_actor
        return dist.sample(generator), h_actor

    # ---- training (sequence mode over recurrent chunks) ----
    def evaluate_actions(self, obs, h0_actor, h0_critic, actions, masks):
        """Chunk tensors are [L, N, ...]; h0 are [N, layers, hidden].

        Returns (values, action_log_probs, dist_entropy), each [L, N, 1].
        """
        mean, log_std, _ = self.actor.seq(obs, h0_actor, masks)
        dist = DiagGaussian(mean, log_std)
        values, _ = self.critic.seq(obs, h0_critic, masks)
        return values, dist.log_prob(actions), dist.entropy()
