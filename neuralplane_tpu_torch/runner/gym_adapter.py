"""Generic gym-environment runner (counterpart of
neuralplane_tpu/runner/gym_adapter.py:26-159).

Trains the recurrent PPO stack on any host-stepped environment with the
gym contract reset() -> obs, step(a) -> (obs, reward, done, info) or the
5-tuple (obs, reward, terminated, truncated, info): external simulators,
classic-control tasks, or this package's GymVecEnv. The env steps on the
host; the policy forward and the update run on the runner's device. Each
step moves the actions to the host once and the observations to the device
once.

The batch is a RolloutBatch of device tensors laid out as the port's
collect lays it out (runner/f16sim.py): the rnn states are recorded once per
recurrent chunk, [T/L, n, layers, H], which is what the trainer reads.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..algorithms.ppo.buffer import RolloutBatch
from ..algorithms.rl_config import RLConfig
from .base import Runner


class GymEnvAdapter:
    """Duck-typing shim: normalizes the 4-tuple and the 5-tuple
    (terminated / truncated) step results to one contract."""

    def __init__(self, env):
        self.env = env
        self.num_observation = int(np.prod(env.observation_space.shape))
        self.num_actions = int(np.prod(env.action_space.shape))
        # config shim, for Runner defaults that read max_steps
        self.config = type("C", (), {"max_steps": 1000})()

    def reset(self) -> np.ndarray:
        out = self.env.reset()
        obs = out[0] if isinstance(out, tuple) else out
        return np.asarray(obs, np.float32).reshape(-1)

    def step(self, action: np.ndarray):
        out = self.env.step(action)
        if len(out) == 5:   # gymnasium: obs, r, terminated, truncated, info
            obs, r, term, trunc, info = out
            return (np.asarray(obs, np.float32).reshape(-1), float(r),
                    bool(term), bool(trunc), info)
        obs, r, done, info = out
        trunc = bool(info.get("TimeLimit.truncated", False))
        return (np.asarray(obs, np.float32).reshape(-1), float(r),
                bool(done) and not trunc, trunc, info)


class GymRunner(Runner):
    """PPO on a list of host-stepped single-agent envs."""

    def __init__(self, envs, cfg: RLConfig, run_dir: str = "runs/gym",
                 model_dir: Optional[str] = None, use_tensorboard: bool = False,
                 device="cuda"):
        self.adapters = [e if isinstance(e, GymEnvAdapter) else GymEnvAdapter(e)
                         for e in envs]
        super().__init__(self.adapters[0], cfg, run_dir, None, model_dir,
                         use_tensorboard, device=device)
        self.n = len(self.adapters)

    def _step_envs(self, actions: torch.Tensor):
        """One host step of every env: (obs, rewards, masks, bad_masks,
        reset) as numpy rows."""
        a = actions.cpu().numpy()
        n, d_obs = self.n, self.env.num_observation
        obs = np.empty((n, d_obs), np.float32)
        rewards = np.empty((n, 1), np.float32)
        masks = np.ones((n, 1), np.float32)
        bad_masks = np.ones((n, 1), np.float32)
        reset = np.zeros(n, bool)
        for i, adapter in enumerate(self.adapters):
            o, r, done, trunc, _ = adapter.step(a[i])
            rewards[i, 0] = r
            masks[i, 0] = 0.0 if (done or trunc) else 1.0
            # proper-time-limits convention (buffer.compute_returns):
            # bad_masks = 0 marks a time-limit end whose return is replaced
            # by V(s); a true terminal keeps 1 so that its reward survives
            bad_masks[i, 0] = 0.0 if (trunc and not done) else 1.0
            if done or trunc:
                o = adapter.reset()
                reset[i] = True
            obs[i] = o
        return obs, rewards, masks, bad_masks, reset

    def run(self) -> Dict[str, float]:
        cfg = self.cfg
        T, L, n, dev = cfg.buffer_size, cfg.data_chunk_length, self.n, self.device
        if T % L != 0:
            raise ValueError(f"buffer_size {T} % data_chunk_length {L} != 0")
        d_obs, d_act = self.env.num_observation, self.env.num_actions
        episodes = max(1, int(cfg.num_env_steps) // (T * n))

        def to_dev(x: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(x).to(dev)

        obs = to_dev(np.stack([a.reset() for a in self.adapters]))
        h_a, h_c = self.policy.init_rnn_states(n)
        masks = torch.ones((n, 1), dtype=torch.float32, device=dev)
        bad_masks = masks.clone()
        start = time.time()
        train_infos: Dict[str, float] = {}

        for episode in range(episodes):
            def buf(rows, *shape):
                return torch.empty((rows, n, *shape), dtype=torch.float32, device=dev)
            b_obs, b_masks, b_bad = buf(T + 1, d_obs), buf(T + 1, 1), buf(T + 1, 1)
            b_values = buf(T + 1, 1)
            b_actions, b_logp = buf(T, d_act), buf(T, 1)
            h0_a, h0_c = buf(T // L, *h_a.shape[1:]), buf(T // L, *h_c.shape[1:])
            rewards = np.zeros((T, n, 1), np.float32)
            ends = 0

            for c in range(T // L):
                h0_a[c], h0_c[c] = h_a, h_c
                for t in range(c * L, (c + 1) * L):
                    b_obs[t], b_masks[t], b_bad[t] = obs, masks, bad_masks
                    with torch.no_grad():
                        values, actions, logp, h_a, h_c = self.policy.get_actions(
                            obs, h_a, h_c, masks, self.generator)
                    b_values[t], b_actions[t], b_logp[t] = values, actions, logp
                    o, rewards[t], m, bm, reset = self._step_envs(actions)
                    ends += int((m == 0).sum())
                    keep = to_dev((~reset).astype(np.float32))[:, None, None]
                    h_a, h_c = h_a * keep, h_c * keep
                    obs, masks, bad_masks = to_dev(o), to_dev(m), to_dev(bm)

            b_obs[T], b_masks[T], b_bad[T] = obs, masks, bad_masks
            with torch.no_grad():
                b_values[T] = self.policy.get_values(obs, h_c, masks)
            batch = RolloutBatch(obs=b_obs, actions=b_actions, rewards=to_dev(rewards),
                                 masks=b_masks, bad_masks=b_bad, action_log_probs=b_logp,
                                 value_preds=b_values, rnn_states_actor=h0_a,
                                 rnn_states_critic=h0_c)
            train_infos = self.train(batch)

            total = (episode + 1) * T * n
            if episode % cfg.log_interval == 0:
                # every episode end (terminal or truncation) zeroes masks;
                # bad_masks marks a subset (truncations), so masks alone counts
                train_infos["average_episode_rewards"] = float(
                    rewards.sum() / max(ends, 1))
                train_infos["fps"] = int(total / (time.time() - start))
                logging.info("gym episode %d/%d avg_reward %.2f", episode, episodes,
                             train_infos["average_episode_rewards"])
                self.log_info(train_infos, total)
            if episode % cfg.save_interval == 0 or episode == episodes - 1:
                self.save("latest")
        return train_infos
