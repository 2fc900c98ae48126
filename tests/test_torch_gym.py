"""The port's gym-style adapters on the CPU (envs/wrappers.py,
runner/gym_adapter.py): GymVecEnv's [num_envs, num_agents, dim] shapes and
the smoke test of tests/test_env.py:105-122, the adapter's 4- and 5-tuple
normalization, and GymRunner learning the toy chase of
tests/test_gym_adapter.py (late episodes beat early ones by 0.5)."""
import json

import numpy as np
import pytest
import torch

from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.envs import ControlEnv, GymVecEnv, make_control_vec_env
from neuralplane_tpu_torch.runner import GymEnvAdapter, GymRunner


def test_gym_vec_env_smoke():
    """Random actions until any done flag fires (the reference's
    test_env.py:11-33)."""
    venv = GymVecEnv(ControlEnv(num_envs=8, config="heading", device="cpu"), seed=0)
    obs = venv.reset()
    assert obs.shape == (8, 1, 22) and obs.dtype == np.float32
    rng = np.random.default_rng(0)
    fired = False
    for _ in range(50):
        actions = rng.uniform(-1, 1, (8, 1, 4)).astype(np.float32)
        obs, reward, done, bad, exceed, info = venv.step(actions)
        assert obs.shape == (8, 1, 22) and reward.shape == (8, 1, 1)
        assert done.shape == bad.shape == exceed.shape == (8, 1, 1) and info == {}
        if done.any() or bad.any():
            fired = True
            break
    # random full-range actions drive the F-16 out of its envelope quickly
    assert fired


def test_vec_env_reseeds_each_reset_and_takes_other_models():
    venv = make_control_vec_env(4, scenario="tracking", model="UAV", seed=3, device="cpu")
    assert venv.num_observation == 22 and venv.num_actions == 3
    first, second = venv.reset(), venv.reset()
    assert first.shape == (4, 1, 22) and not np.array_equal(first, second)
    again = make_control_vec_env(4, scenario="tracking", model="UAV", seed=3, device="cpu")
    np.testing.assert_array_equal(again.reset(), first)
    obs, reward, *_ = venv.step(np.zeros((4, 1, 3), np.float32))
    assert np.isfinite(obs).all() and np.isfinite(reward).all()
    with pytest.raises(RuntimeError, match="reset"):
        make_control_vec_env(2, device="cpu").step(np.zeros((2, 1, 4), np.float32))


class _Space:
    def __init__(self, shape):
        self.shape = shape


class ToyEnv:
    """Point-mass chase: reward = -|x - target|; the 4-tuple gym API."""

    observation_space = _Space((3,))
    action_space = _Space((1,))

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)
        self.t = 0

    def reset(self):
        self.x = self.rng.uniform(-1, 1)
        self.target = self.rng.uniform(-1, 1)
        self.t = 0
        return self._obs()

    def _obs(self):
        return np.array([self.x, self.target, self.target - self.x], np.float32)

    def step(self, action):
        self.x += 0.1 * float(np.clip(action[0], -1, 1))
        self.t += 1
        reward = -abs(self.x - self.target)
        done = self.t >= 20
        return self._obs(), reward, done, {"TimeLimit.truncated": done}


class ToyEnv5(ToyEnv):
    """The same env on the gymnasium API: reset -> (obs, info), 5-tuples."""

    def reset(self):
        return super().reset(), {}

    def step(self, action):
        obs, reward, done, _ = super().step(action)
        return obs, reward, False, done, {}


def test_adapter_normalizes_both_apis():
    for env in (ToyEnv(1), ToyEnv5(1)):
        a = GymEnvAdapter(env)
        assert a.num_observation == 3 and a.num_actions == 1
        assert a.reset().shape == (3,)
        for t in range(20):
            obs, r, done, trunc, _ = a.step(np.zeros(1, np.float32))
        # a time limit is a truncation, not a terminal
        assert not done and trunc and isinstance(r, float) and obs.dtype == np.float32


def test_gym_runner_trains(tmp_path):
    cfg = RLConfig(buffer_size=20, data_chunk_length=5, ppo_epoch=4, num_mini_batch=1,
                   hidden_sizes=(16,), act_hidden_sizes=(), recurrent_hidden_size=8,
                   num_env_steps=20 * 8 * 25, log_interval=1, save_interval=1000, lr=5e-3)
    envs = [ToyEnv(seed=i) for i in range(8)]
    runner = GymRunner(envs, cfg, run_dir=str(tmp_path), device="cpu")
    assert runner.device.type == "cpu" and runner.n == 8
    infos = runner.run()
    runner.close()
    assert np.isfinite(infos["policy_loss"])
    assert np.isfinite(infos["average_episode_rewards"])
    assert (tmp_path / "checkpoints" / "state_latest.pt").exists()
    # PPO must learn the chase: late episodes beat early ones
    with open(tmp_path / "metrics.jsonl", encoding="utf-8") as f:
        rew = [json.loads(line)["average_episode_rewards"] for line in f]
    early, late = np.mean(rew[:3]), np.mean(rew[-3:])
    assert late > early + 0.5, f"no learning: {early:.2f} -> {late:.2f}"


def test_gym_runner_batch_layout(tmp_path, monkeypatch):
    """The batch the trainer gets: device tensors, rnn states once per
    chunk ([T/L, n, layers, H]), masks 0 exactly after each episode end."""
    cfg = RLConfig(buffer_size=20, data_chunk_length=5, ppo_epoch=1, num_mini_batch=1,
                   hidden_sizes=(8,), act_hidden_sizes=(), recurrent_hidden_size=4,
                   num_env_steps=20 * 3)
    runner = GymRunner([ToyEnv5(seed=i) for i in range(3)], cfg, run_dir=str(tmp_path),
                       device="cpu")
    seen = []
    monkeypatch.setattr(runner, "train", lambda batch: seen.append(batch) or {})
    runner.run()
    runner.close()
    b = seen[0]
    assert b.obs.shape == (21, 3, 3) and b.actions.shape == (20, 3, 1)
    assert b.rnn_states_actor.shape == (4, 3, 1, 4) and isinstance(b.rewards, torch.Tensor)
    # each toy episode lasts 20 steps and ends by truncation
    assert b.masks[20].eq(0).all() and b.masks[:20].eq(1).all()
    assert b.bad_masks[20].eq(0).all()
