"""Host-side vectorized-env adapter (counterpart of
neuralplane_tpu/envs/wrappers.py:20-62).

Gives an env a stateful numpy interface shaped [num_envs, num_agents, dim]
for host training loops and gym-style callers. The env state stays on the
env's device between calls; arrays cross to numpy only at the boundary.
The training path (runner/f16sim.py) does not use it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .base import ControlEnv, Env


class GymVecEnv:
    """Stateful wrapper: holds the env state, numpy in and out. Each reset
    gives the env a new seed, drawn from a numpy generator seeded `seed`."""

    def __init__(self, env: Env, seed: int = 0):
        self.env = env
        self.num_envs = env.num_envs
        self.num_agents = env.num_agents
        self._seeds = np.random.default_rng(seed)
        self._state = None

    @property
    def num_observation(self) -> int:
        return self.env.num_observation

    @property
    def num_actions(self) -> int:
        return self.env.num_actions

    def _split(self, x: torch.Tensor) -> np.ndarray:
        arr = x.cpu().numpy()
        return arr.reshape(self.num_envs, self.num_agents, *arr.shape[1:])

    def reset(self) -> np.ndarray:
        self._state, obs = self.env.reset(int(self._seeds.integers(2 ** 31 - 1)))
        return self._split(obs)

    def step(self, actions: np.ndarray) -> Tuple[np.ndarray, ...]:
        if self._state is None:
            raise RuntimeError("call reset() first")
        flat = torch.as_tensor(np.asarray(actions, dtype=np.float32),
                               device=self.env.device).reshape(
            self.num_envs * self.num_agents, -1)
        self._state, out = self.env.step(self._state, flat)
        return (self._split(out.obs),
                self._split(out.reward[:, None]),
                self._split(out.done[:, None]),
                self._split(out.bad_done[:, None]),
                self._split(out.exceed_time_limit[:, None]),
                {})


def make_control_vec_env(num_envs: int, scenario: str = "heading", model: str = "F16",
                         seed: int = 0, aero_backend: str = "auto",
                         device="cuda") -> GymVecEnv:
    return GymVecEnv(ControlEnv(num_envs, config=scenario, model=model,
                                aero_backend=aero_backend, device=device), seed=seed)
