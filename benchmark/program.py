"""The system under test, as the benchmark builds and watches it: the
port's control env and PPO runner, built from a configuration's file, and
snapshots of what its timed path reads and produces at chosen steps.

Only this module and the drivers import the program
(`neuralplane_tpu_torch`); the reference imports none of it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

WEIGHT_CLASSES = {"nets43": "GroupedAeroWeights", "distilled": "DistilledAeroWeights"}


def make_env(config: dict, n: int, device, env_class=None):
    """The configuration's env of n aircraft on `device`: its scenario
    values as stated in its file, its task and its aero backend, passed
    explicitly. Refuses an env that would not run the fused step on the
    configuration's surrogate."""
    from neuralplane_tpu_torch.envs import ControlEnv
    from neuralplane_tpu_torch.utils.config import config_from_dict
    cls = env_class or ControlEnv
    env = cls(num_envs=n, config=config_from_dict(config["scenario"]), task=config["task"],
              aero_backend=config["aero_backend"], device=device)
    want = WEIGHT_CLASSES[config["surrogate"]["kind"]]
    got = type(env.model.weights).__name__
    if got != want:
        raise RuntimeError(f"aero backend {config['aero_backend']!r} gave {got}, "
                           f"the configuration states {want}")
    if not env.fused:
        raise RuntimeError("the env does not run the fused step the configuration states")
    return env


def recording_env_class():
    """ControlEnv with a span around `step`: at the step indices in
    `armed` it keeps what the step read and produced (`records`)."""
    from neuralplane_tpu_torch.envs import ControlEnv

    class RecordingEnv(ControlEnv):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.step_index = 0
            self.armed: set = set()
            self.rows: Optional[torch.Tensor] = None
            self.records: list = []

        def step(self, state, action):
            k = self.step_index
            self.step_index += 1
            if k not in self.armed:
                return super().step(state, action)
            x = snap_inputs(self, state, action, self.rows)
            new_state, out = super().step(state, action)
            self.records.append((k, x, snap_outputs(self, new_state, out, self.rows)))
            return new_state, out
    return RecordingEnv


def snap_inputs(env, state, action, rows: torch.Tensor) -> Dict:
    """What one step reads, at `rows`: the state before the step, the
    action, and the env generator's state (its draws follow from it)."""
    tg = env.task.kernel_targets(state.task)
    x = {"sf": state.model.sf[:, rows], "uf": state.model.uf[:, rows],
         "action": action[rows], "step_count": state.step_count[rows],
         "is_done": state.is_done[rows], "bad_done": state.bad_done[rows],
         "exceed": state.exceed_time_limit[rows]}
    x.update({f"tg{i}": tg[i][rows] for i in range(3)})
    return {"x": x, "gen_state": env.generator.get_state()}


def snap_outputs(env, new_state, out, rows: torch.Tensor) -> Dict:
    tg = env.task.kernel_targets(new_state.task)
    y = {"sf": new_state.model.sf[:, rows], "uf": new_state.model.uf[:, rows],
         "step_count": new_state.step_count[rows], "obs": out.obs[rows],
         "reward": out.reward[rows], "done": out.done[rows], "bad": out.bad_done[rows]}
    y.update({f"tg{i}": tg[i][rows] for i in range(3)})
    return y


def rl_config(config: dict, seed: int):
    """The runner's RLConfig from the configuration's file: its training
    settings and network widths; logging, saving and evaluation off."""
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    fields = {f.name for f in dataclasses.fields(RLConfig)}
    values = {k: v for k, v in config.items() if k in fields}
    values.update({k: (tuple(v) if isinstance(v, list) else v)
                   for k, v in config["networks"].items() if k in fields})
    values.update(seed=seed, use_eval=False, log_interval=1 << 30, save_interval=1 << 30)
    return RLConfig(**values)
