"""F16Sim runner: rollout collection on the device and the PPO update
(counterpart of neuralplane_tpu/runner/f16sim.py:42-238).

The JAX package collects in one `lax.scan`; here a host loop over the
buffer's steps launches the policy forward and one env step per step (on the
fused path one `env_step` kernel) and writes into preallocated device
tensors. Nothing in the loop reads a value back to the host: the done, bad
and `termination/*` counts stay tensors until `run` logs them, once per
episode.

Mask construction (F16sim_runner.insert:138-154, f16sim.py:80-114):
  dones_env      = any-over-agents done      -> masks[t+1] = 0 (whole env)
  bad_dones_env  = any-over-agents bad_done  -> bad_masks[t+1] = 0
  reset_env      = any-over-agents any flag  -> rnn states zeroed
(`exceed_time_limit` is all zero on the fused path, as in the JAX package.)

Over a mesh (JAX :53-68) the env is this rank's share, `n` rows of the
global `n * world` (scripts/train.py:make_env splits the global count and
checks that it divides, as the JAX assert at :59-60 does): episode counts
and `total_num_steps` are global, and the logged reward sums, episode ends
and `termination/*` counts are summed over the ranks in one all-reduce
before `log_info`, as are the eval's.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional, Tuple

import torch

from ..algorithms.ppo.buffer import RolloutBatch
from ..algorithms.rl_config import RLConfig
from ..parallel.mesh import Mesh, all_reduce_sum
from ..utils.profiling import span
from .base import Runner


@dataclasses.dataclass
class RolloutCarry:
    env_state: object
    obs: torch.Tensor        # [n, obs_dim]
    h_actor: torch.Tensor    # [n, layers, H]
    h_critic: torch.Tensor   # [n, layers, H]
    masks: torch.Tensor      # [n, 1]
    bad_masks: torch.Tensor  # [n, 1]


class F16SimRunner(Runner):
    """PPO on the single-agent control envs (heading / control / tracking)
    and the planning env. The env's device is the runner's; `mesh` makes
    the runner one rank of a data-parallel run."""

    def __init__(self, env, cfg: RLConfig, run_dir: str = "runs/debug",
                 eval_env=None, model_dir: Optional[str] = None,
                 use_tensorboard: bool = False, mesh: Optional[Mesh] = None):
        super().__init__(env, cfg, run_dir, eval_env, model_dir, use_tensorboard,
                         mesh=mesh)
        self.num_envs = env.num_envs
        self.num_agents = env.num_agents
        self.n = env.n

    # ---- rollout ----
    def init_carry(self, seed: int) -> RolloutCarry:
        env_state, obs = self.env.reset(seed)
        h_a, h_c = self.policy.init_rnn_states(self.n)
        ones = torch.ones((self.n, 1), dtype=torch.float32, device=self.device)
        return RolloutCarry(env_state=env_state, obs=obs, h_actor=h_a, h_critic=h_c,
                            masks=ones, bad_masks=ones.clone())

    def _env_flags(self, done, bad, exceed) -> Tuple[torch.Tensor, torch.Tensor,
                                                     torch.Tensor]:
        """Per-env any-over-agents reductions, broadcast back to [n, 1]."""
        def env_any(x):
            per_env = x.reshape(self.num_envs, self.num_agents).any(dim=1)
            return per_env[:, None].expand(-1, self.num_agents).reshape(-1, 1)
        return env_any(done), env_any(bad), env_any(done | bad | exceed)

    def _collect_step(self, carry: RolloutCarry):
        values, actions, logp, h_a, h_c = self.policy.get_actions(
            carry.obs, carry.h_actor, carry.h_critic, carry.masks, self.generator)
        env_state, out = self.env.step(carry.env_state, actions)

        dones_env, bad_env, reset_env = self._env_flags(
            out.done, out.bad_done, out.exceed_time_limit)
        keep = 1.0 - reset_env.float()
        step_data = dict(
            obs=carry.obs, actions=actions, rewards=out.reward[:, None],
            masks=carry.masks, bad_masks=carry.bad_masks,
            action_log_probs=logp, value_preds=values,
            done_count=out.done.sum(), bad_count=out.bad_done.sum(),
            info=out.info if out.info is not None else {})
        new_carry = RolloutCarry(
            env_state=env_state, obs=out.obs, h_actor=h_a * keep[:, :, None],
            h_critic=h_c * keep[:, :, None], masks=1.0 - dones_env.float(),
            bad_masks=1.0 - bad_env.float())
        return new_carry, step_data

    def collect(self, carry: RolloutCarry
                ) -> Tuple[RolloutCarry, RolloutBatch, Tuple[torch.Tensor, Dict]]:
        """Roll buffer_size steps; returns (carry, batch, (episodes_finished,
        counters)), counts as device tensors.

        Two nested loops, over the T/L recurrent chunks and the L steps of a
        chunk: the rnn states are recorded once per chunk (the input state
        of the chunk's first step, all the update reads), so the batch's
        rnn_states_* are [T/L, n, layers, H]."""
        with span("runner.collect"), torch.no_grad():
            T, L = self.cfg.buffer_size, self.cfg.data_chunk_length
            if T % L != 0:
                raise ValueError(f"buffer_size {T} % data_chunk_length {L} != 0")
            n, dev = self.n, self.device

            def buf(rows, *shape):
                return torch.empty((rows, n, *shape), dtype=torch.float32, device=dev)
            obs = buf(T + 1, carry.obs.shape[1])
            actions = buf(T, self.policy.spec.act_dim)
            rewards, logp = buf(T, 1), buf(T, 1)
            masks, bad_masks, values = buf(T + 1, 1), buf(T + 1, 1), buf(T + 1, 1)
            h0_a = buf(T // L, *carry.h_actor.shape[1:])
            h0_c = buf(T // L, *carry.h_critic.shape[1:])
            done_total = torch.zeros((), dtype=torch.int64, device=dev)
            bad_total = torch.zeros((), dtype=torch.int64, device=dev)
            counters: Dict[str, torch.Tensor] = {}

            for c in range(T // L):
                h0_a[c], h0_c[c] = carry.h_actor, carry.h_critic
                for t in range(c * L, (c + 1) * L):
                    carry, d = self._collect_step(carry)
                    obs[t], actions[t], rewards[t] = d["obs"], d["actions"], d["rewards"]
                    masks[t], bad_masks[t] = d["masks"], d["bad_masks"]
                    logp[t], values[t] = d["action_log_probs"], d["value_preds"]
                    done_total += d["done_count"]
                    bad_total += d["bad_count"]
                    for k, v in d["info"].items():
                        counters[k] = v + counters[k] if k in counters else v
            obs[T], masks[T], bad_masks[T] = carry.obs, carry.masks, carry.bad_masks
            values[T] = self.policy.get_values(carry.obs, carry.h_critic, carry.masks)
            batch = RolloutBatch(obs=obs, actions=actions, rewards=rewards, masks=masks,
                                 bad_masks=bad_masks, action_log_probs=logp,
                                 value_preds=values, rnn_states_actor=h0_a,
                                 rnn_states_critic=h0_c)
            counters["episodes_reached_target"] = done_total
            counters["episodes_failed"] = bad_total
            return carry, batch, (done_total + bad_total, counters)

    # ---- main loop ----
    def run(self) -> Dict[str, float]:
        cfg = self.cfg
        carry = self.init_carry(self.next_seed())
        total_steps_per_episode = cfg.buffer_size * self.n * self.world
        episodes = max(1, int(cfg.num_env_steps) // total_steps_per_episode)
        start = time.time()
        train_infos: Dict[str, float] = {}

        for episode in range(episodes):
            carry, batch, (_, counters) = self.collect(carry)
            train_infos = self.train(batch)
            total_num_steps = (episode + 1) * total_steps_per_episode

            if episode % cfg.log_interval == 0:
                # avg episode reward = sum(rewards) / #episode-ends
                # (F16sim_runner.py:98-99), both summed over the ranks
                ends = ((batch.masks[1:] == 0).sum()
                        + (batch.bad_masks[1:] == 0).sum())
                sums = torch.stack([batch.rewards.sum(), ends.float()]
                                   + [v.float() for v in counters.values()])
                all_reduce_sum([sums], self.mesh)
                avg_rew = sums[0] / sums[1].clamp_min(1)
                names = ["average_episode_rewards", *counters]
                train_infos.update(zip(names, torch.cat([avg_rew[None], sums[2:]]).tolist()))
                fps = int(total_num_steps / (time.time() - start))
                logging.info(
                    "episode %d/%d steps %d FPS %d avg_episode_reward %.3f",
                    episode, episodes, total_num_steps, fps,
                    train_infos["average_episode_rewards"])
                train_infos["fps"] = fps
                self.log_info(train_infos, total_num_steps)

            if cfg.use_eval and episode % cfg.eval_interval == 0 and episode:
                self.log_info(self.eval(), total_num_steps)

            if episode % cfg.save_interval == 0 or episode == episodes - 1:
                self.save("latest")
                self.save(f"ep{episode}")
        return train_infos

    # ---- evaluation (deterministic rollout; F16sim_runner.py:156-193) ----
    @torch.no_grad()
    def eval(self, num_steps: Optional[int] = None) -> Dict[str, float]:
        env = self.eval_env if self.eval_env is not None else self.env
        steps = num_steps or self.env.config.max_steps
        state, obs = env.reset(self.next_seed())
        h_a, _ = self.policy.init_rnn_states(env.n)
        masks = torch.ones((env.n, 1), dtype=torch.float32, device=self.device)
        total_rew = torch.zeros((), dtype=torch.float32, device=self.device)
        total_done = torch.zeros((), dtype=torch.int64, device=self.device)
        for _ in range(steps):
            actions, h_a = self.policy.act(obs, h_a, masks, deterministic=True)
            state, out = env.step(state, actions)
            reset = out.done | out.bad_done | out.exceed_time_limit
            masks = 1.0 - out.done.float()[:, None]
            h_a = h_a * (1.0 - reset.float())[:, None, None]
            total_rew += out.reward.sum()
            total_done += reset.sum()
            obs = out.obs
        all_reduce_sum([total_rew, total_done], self.mesh)
        return {"eval_average_episode_rewards":
                float(total_rew / total_done.clamp_min(1))}
