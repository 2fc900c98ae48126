"""MAPPO trainer: the PPO update over shared-buffer chunks, the entropy
term weighted by the active masks (counterpart of
neuralplane_tpu/algorithms/mappo/trainer.py).

The rollout batch adds share_obs and active_masks; the clipped surrogate
and the value loss are PPO's, and only the entropy term is averaged over
the active (alive) agents; over a mesh, over the active agents of every
rank.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ...parallel.mesh import all_reduce_sum
from ..ppo.buffer import RolloutBatch
from ..ppo.trainer import PPOTrainer


@dataclasses.dataclass
class SharedRolloutBatch(RolloutBatch):
    share_obs: torch.Tensor     # [T+1, N, share_obs_dim]
    active_masks: torch.Tensor  # [T+1, N, 1], 1 while the agent is alive


class MAPPOTrainer(PPOTrainer):
    """A minibatch sample is PPO's with (share_obs, active) before the two
    initial rnn states."""

    def _chunk_arrays(self, batch: SharedRolloutBatch, returns, advantages) -> Tuple:
        L = self.cfg.data_chunk_length
        base = super()._chunk_arrays(batch, returns, advantages)
        T, N = batch.actions.shape[:2]

        def to_chunks(x):
            x = x[:-1].transpose(0, 1)
            return x.reshape(N * (T // L), L, *x.shape[2:])
        return base[:7] + (to_chunks(batch.share_obs), to_chunks(batch.active_masks)) + base[7:]

    def _evaluate(self, sample: Tuple):
        obs, actions, masks, *_, share_obs, _, h0_actor, h0_critic = sample
        return self.policy.evaluate_actions(share_obs, obs, h0_actor, h0_critic, actions, masks)

    def _entropy_loss(self, entropy: torch.Tensor, sample: Tuple) -> torch.Tensor:
        """-sum(entropy * active) / sum(active) over the global minibatch.
        Ranks hold different numbers of live agents, so over a mesh the
        denominator is all-reduced and the local numerator scaled by the
        world size: the mean of the ranks' gradients is then the global
        ratio's."""
        active = sample[8]
        den = active.sum()
        all_reduce_sum([den], self.mesh)
        world = self.mesh.size if self.mesh is not None else 1
        return -(entropy * active).sum() * world / den.clamp_min(1.0)
