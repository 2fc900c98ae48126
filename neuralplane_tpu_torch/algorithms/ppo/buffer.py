"""Rollout storage, GAE and recurrent chunking on the device (counterpart of
neuralplane_tpu/algorithms/ppo/buffer.py).

Index convention (as the JAX package's):
  obs[t]            observation the policy saw at step t        (T+1 entries)
  masks[t]          1 - done_env[t-1]: obs[t] begins a fresh episode if 0
  bad_masks[t]      1 - bad_done_env[t-1] (proper-time-limits variant)
  actions/rewards/action_log_probs[t]   step-t data              (T entries)
  value_preds[t]    V(obs[t])                                    (T+1 entries)
  rnn_states_*[t]   hidden state *input* to step t               (T entries,
                    or T/L: the input of each chunk's first step)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ...parallel.mesh import Mesh, all_reduce_sum


@dataclasses.dataclass
class RolloutBatch:
    obs: torch.Tensor                # [T+1, N, obs_dim]
    actions: torch.Tensor            # [T, N, act_dim]
    rewards: torch.Tensor            # [T, N, 1]
    masks: torch.Tensor              # [T+1, N, 1]
    bad_masks: torch.Tensor          # [T+1, N, 1]
    action_log_probs: torch.Tensor   # [T, N, 1]
    value_preds: torch.Tensor        # [T+1, N, 1]  (V(obs[T]) = bootstrap)
    rnn_states_actor: torch.Tensor   # [T, N, L, H] or [T/chunk, N, L, H]
    rnn_states_critic: torch.Tensor


def compute_returns(batch: RolloutBatch, gamma: float, gae_lambda: float,
                    use_gae: bool = True,
                    use_proper_time_limits: bool = False) -> torch.Tensor:
    """Returns [T, N, 1]: a reverse loop over T, the four variants of
    buffer.py:42-70."""
    rewards, values = batch.rewards, batch.value_preds
    masks, bad_masks = batch.masks, batch.bad_masks
    T = rewards.shape[0]
    returns = torch.empty_like(rewards)
    if use_gae:
        gae = torch.zeros_like(rewards[0])
        for t in reversed(range(T)):
            delta = (rewards[t] + gamma * values[t + 1] * masks[t + 1]
                     - values[t])
            gae = delta + gamma * gae_lambda * masks[t + 1] * gae
            if use_proper_time_limits:
                gae = gae * bad_masks[t + 1]
            returns[t] = gae + values[t]
        return returns
    ret = values[-1]
    for t in reversed(range(T)):
        ret = ret * gamma * masks[t + 1] + rewards[t]
        if use_proper_time_limits:
            ret = (ret * bad_masks[t + 1]
                   + (1.0 - bad_masks[t + 1]) * values[t])
        returns[t] = ret
    return returns


def compute_advantages(returns: torch.Tensor, value_preds: torch.Tensor,
                       mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Whole-buffer-normalized advantages (buffer.py:73-77); the standard
    deviation is the population one, as jnp.std's. Both come from sums,
    which over a mesh are all-reduced: the whole buffer is then every
    rank's share."""
    adv = returns - value_preds[:-1]
    total = torch.stack([adv.sum(), adv.new_tensor(float(adv.numel()))])
    all_reduce_sum([total], mesh)
    mean = total[0] / total[1]
    sq = ((adv - mean) ** 2).sum()
    all_reduce_sum([sq], mesh)
    return (adv - mean) / ((sq / total[1]).sqrt() + 1e-5)


def make_chunks(batch: RolloutBatch, returns: torch.Tensor,
                advantages: torch.Tensor, chunk_length: int) -> Tuple:
    """Split [T, N, ...] tensors into C = N*T//L recurrent chunks of length L
    (buffer.py:80-122): agent-major sequences cut into contiguous windows;
    each chunk's initial rnn state is the stored input state of its first
    step. Requires T % L == 0.

    Returns (obs, actions, masks, old_logp, advantages, returns, value_preds)
    each [C, L, ...] plus (h0_actor, h0_critic) each [C, layers, H].
    """
    T, N = batch.actions.shape[:2]
    if T % chunk_length != 0:
        raise ValueError(f"buffer_size {T} must be divisible by "
                         f"data_chunk_length {chunk_length}")
    n_chunks = N * (T // chunk_length)

    def to_chunks(x):  # [T, N, ...] -> [C, L, ...]
        x = x.transpose(0, 1)                           # [N, T, ...]
        return x.reshape(n_chunks, chunk_length, *x.shape[2:])

    def h0_chunks(h):
        if h.shape[0] == T // chunk_length:
            # recorded at chunk starts only ([T/L, N, layers, H]); the same
            # chunk order as to_chunks(...)[:, 0]
            return h.transpose(0, 1).reshape(n_chunks, *h.shape[2:])
        return to_chunks(h)[:, 0]

    return (to_chunks(batch.obs[:-1]), to_chunks(batch.actions),
            to_chunks(batch.masks[:-1]), to_chunks(batch.action_log_probs),
            to_chunks(advantages), to_chunks(returns),
            to_chunks(batch.value_preds[:-1]),
            h0_chunks(batch.rnn_states_actor), h0_chunks(batch.rnn_states_critic))
