"""Environment core (counterpart of neuralplane_tpu/envs/base.py).

    reset(seed)          -> (EnvState, obs)
    step(state, action)  -> (EnvState, StepOutput)

The env owns a torch.Generator on its device, seeded by `reset(seed)`; every
random draw of the env comes from it (on the card, the step kernel's Philox
draws are keyed by two seed words drawn from it on the device each step).

`model` is one of MODELS: the F-16 (aero surrogate), the UAV point mass or
the Cessna-172P (derivative table). Only the F-16 has aero weights, so only
its envs can fuse; the other two always run the portable branch, on eager
tensor ops.

`aero_backend` picks the F-16's aero surrogate (`ops/aero.select_aero_weights`):
"distilled" (and "auto") the consolidated trunk, "pallas" the 43-net
ensemble in the fused CUDA kernels (the JAX package's name for its fused
kernels, kept so that the counterpart is found), "stacked" the same 43 nets
in plain float32 tensor ops on any device.

With the heading/control/tracking tasks, the Euler solver, the step-start
xdot reused for the checks (the configs' defaults) and a fused backend
("distilled" or "pallas"), a step is one launch of the whole-step kernel
(`ops/step_cuda.env_step`), state kept feature-major between steps.
Otherwise the portable branch runs the model, task, termination and reward
functions on tensors, with the state derivative from
`ops/dynamics.nlplant_f16` (one fused xdot kernel per derivative on the
fused backends).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.c172p import C172PModel
from ..models.f16 import F16Model, F16State, F16StateFM, to_fm
from ..models.uav import UAVModel
from ..ops.aero import (DistilledAeroWeights, GroupedAeroWeights,
                        select_aero_weights)
from ..ops.step_cuda import env_step
from ..ops.task import COND_NAMES
from ..utils.config import EnvConfig, load_config
from ..utils.profiling import span
from .tasks import TASKS
from .tasks.base import add_sensor_noise
from .types import EnvState, StepOutput

MODELS = {"F16": F16Model, "UAV": UAVModel, "C172P": C172PModel}


class Env:
    """Config + model + task bound together."""

    def __init__(self, num_envs: int, config: str | EnvConfig = "heading",
                 task: str = "heading", model: str = "F16",
                 aero_backend: str = "auto", device="cuda"):
        if model not in MODELS:
            raise ValueError(f"model must be one of {sorted(MODELS)}, got {model!r}")
        self.device = torch.device(device)
        self.config = config if isinstance(config, EnvConfig) else load_config(config)
        self.num_envs = num_envs
        self.num_agents = self.config.num_agents
        self.n = self.num_envs * self.num_agents
        weights = (select_aero_weights(aero_backend, self.device)
                   if model == "F16" else None)
        self.model = MODELS[model](self.config, weights)
        self.task = TASKS[task](self.config)
        self.generator: Optional[torch.Generator] = None

    @property
    def fused(self) -> bool:
        """Whether step() runs as the single step kernel: a fused aero
        backend (not the stacked one, and no airframe without aero weights)
        and the config's fused settings."""
        cfg = self.config
        return (isinstance(self.model.weights,
                           (GroupedAeroWeights, DistilledAeroWeights))
                and self.task.kernel_variant is not None and cfg.fused_task_kernel
                and cfg.solver == "euler" and cfg.reuse_step_xdot)

    @property
    def num_observation(self) -> int:
        return self.task.num_observation

    @property
    def num_actions(self) -> int:
        return self.task.num_actions

    def init_state(self) -> EnvState:
        """All-done initial state; the first masked reset re-inits every row."""
        n, dev = self.n, self.device
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        return EnvState(model=self.model.init_state(n, dev),
                        task=self.task.init_state(n, dev),
                        step_count=torch.zeros(n, dtype=torch.int32, device=dev),
                        is_done=ones, bad_done=ones, exceed_time_limit=ones)

    def _masked_reset(self, state: EnvState) -> EnvState:
        """Re-init rows whose any done flag is set; zero flags and counters."""
        mask = state.is_done | state.bad_done | state.exceed_time_limit
        mstate = self.model.reset(state.model, mask, self.generator)
        tstate = self.task.reset(self.model, mstate, state.task, mask,
                                 self.generator)
        zeros = torch.zeros_like(state.is_done)
        return EnvState(model=mstate, task=tstate,
                        step_count=torch.where(mask, 0, state.step_count),
                        is_done=zeros, bad_done=zeros, exceed_time_limit=zeros)

    def reset(self, seed: int = 0) -> Tuple[EnvState, torch.Tensor]:
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        state = self._masked_reset(self.init_state())
        obs = self.task.get_obs(self.model, state.model, state.task,
                                self.generator)
        if self.fused:
            state = state.replace(model=to_fm(state.model))
        return state, obs

    def step(self, state: EnvState, action: torch.Tensor
             ) -> Tuple[EnvState, StepOutput]:
        if self.generator is None:
            raise RuntimeError("call reset(seed) before step()")
        with span("env.step"):
            if self.fused:
                return self._step_fused(state, action)
            return self._step_portable(state, action)

    def _step_portable(self, state: EnvState, action: torch.Tensor
                       ) -> Tuple[EnvState, StepOutput]:
        state = self._masked_reset(state)
        if self.config.reuse_step_xdot:
            mstate, xdot = self.model.update_with_xdot(state.model, action)
        else:
            mstate = self.model.update(state.model, action)
        step_count = state.step_count + 1
        obs = self.task.get_obs(self.model, mstate, state.task, self.generator)
        if not self.config.reuse_step_xdot:
            xdot = self.model.extended_state(mstate)
        done, bad, exceed, info = self.task.get_termination(
            self.model, mstate, xdot, step_count, state.task)
        reward = self.task.get_reward(self.model, mstate, state.task, done, bad)
        new_state = EnvState(model=mstate, task=state.task, step_count=step_count,
                             is_done=done, bad_done=bad, exceed_time_limit=exceed)
        return new_state, StepOutput(obs=obs, reward=reward, done=done,
                                     bad_done=bad, exceed_time_limit=exceed,
                                     info=info)

    def _step_fused(self, state: EnvState, action: torch.Tensor
                    ) -> Tuple[EnvState, StepOutput]:
        """The whole step as one env_step call (envs/base.py:161-250)."""
        cfg = self.config
        gen = self.generator
        n, dev = self.n, self.device
        mask = state.is_done | state.bad_done | state.exceed_time_limit
        kernel_noise = cfg.noise_scale > 0 and cfg.kernel_obs_noise
        kernel_draws = cfg.kernel_reset_draws
        if kernel_draws:
            alt_init = vt_init = None
            tstate = None
            targets_in = self.task.kernel_targets(state.task)
        else:
            alt_init = cfg.min_altitude + torch.rand(n, generator=gen, device=dev) \
                * (cfg.max_altitude - cfg.min_altitude)
            vt_init = cfg.min_vt + torch.rand(n, generator=gen, device=dev) \
                * (cfg.max_vt - cfg.min_vt)
            tstate = self.task.reset_from_init(state.task, mask, alt_init,
                                               vt_init, gen)
            targets_in = self.task.kernel_targets(tstate)
        step_count = torch.where(mask, 0, state.step_count) + 1

        a = action
        if a.shape[1] < 4:  # narrow action spaces (tracking's 3)
            a = torch.cat([a, a.new_zeros((a.shape[0], 4 - a.shape[1]))], dim=1)
        seed = None
        if kernel_noise or kernel_draws:
            seed = torch.randint(0, 2 ** 31 - 1, (2,), generator=gen, device=dev,
                                 dtype=torch.int32)
        fm = to_fm(state.model)
        outs = env_step(self.task.kernel_variant, cfg, self.model.weights,
                        fm.sf, fm.uf, a[:, :4], mask, alt_init, vt_init,
                        targets_in, step_count, noise_seed=seed,
                        noise_scale=float(cfg.noise_scale) if kernel_noise else 0.0,
                        reset_draws=kernel_draws, generator=gen)
        sf_new, uf_new, obs, done, bad, reward, counts = outs[:7]
        if kernel_draws:
            tstate = self.task.state_from_kernel_targets(*outs[7:10])
        if not kernel_noise:
            obs = add_sensor_noise(obs, gen, cfg.noise_scale)
        exceed = torch.zeros_like(done)
        info = {f"termination/{nm}": counts[i]
                for i, nm in enumerate(COND_NAMES[self.task.kernel_variant])}
        new_state = EnvState(model=F16StateFM(sf=sf_new, uf=uf_new), task=tstate,
                             step_count=step_count, is_done=done, bad_done=bad,
                             exceed_time_limit=exceed)
        return new_state, StepOutput(obs=obs, reward=reward, done=done,
                                     bad_done=bad, exceed_time_limit=exceed,
                                     info=info)

    def state_from_jax(self, jstate) -> EnvState:
        """Carry a JAX EnvState, its leaves as numpy (e.g.
        `jax.tree.map(np.asarray, state)`), into the port on this env's
        device: model (feature-major, or agent-major as every UAV and C172P
        state is), targets, step count and flags. The PRNG key stays behind.
        For tests; the runtime does not use it."""
        dev = self.device

        def t(a):
            return torch.as_tensor(np.array(a)).to(dev)

        jm = jstate.model
        if hasattr(jm, "sf"):   # F16StateFM, sublane-padded [16,n] / [8,n]
            model = F16StateFM(sf=t(jm.sf)[:self.model.num_states].contiguous(),
                               uf=t(jm.uf)[:self.model.num_controls].contiguous())
        else:
            model = F16State(s=t(jm.s), u=t(jm.u), recent_s=t(jm.recent_s),
                             recent_u=t(jm.recent_u))
        task = self.task.state_cls(**{
            f.name: t(getattr(jstate.task, f.name))
            for f in dataclasses.fields(self.task.state_cls)})
        return EnvState(model=model, task=task,
                        step_count=t(jstate.step_count).to(torch.int32),
                        is_done=t(jstate.is_done).bool(),
                        bad_done=t(jstate.bad_done).bool(),
                        exceed_time_limit=t(jstate.exceed_time_limit).bool())


class ControlEnv(Env):
    """Single-agent control env: task in {heading, control, tracking},
    inferred from the scenario name when not given."""

    def __init__(self, num_envs: int = 10, config: str | EnvConfig = "heading",
                 model: str = "F16", aero_backend: str = "auto",
                 task: Optional[str] = None, device="cuda"):
        if task is None:
            if not isinstance(config, str):
                raise ValueError(
                    "ControlEnv(config=<EnvConfig>) needs an explicit task=; "
                    "the task can only be inferred from a scenario name")
            task = os.path.splitext(os.path.basename(config))[0].split("_")[0]
        if task not in TASKS:
            raise ValueError(f"cannot infer task from scenario {config!r} "
                             f"(got {task!r}); pass task= explicitly, one of "
                             f"{sorted(TASKS)}")
        super().__init__(num_envs, config=config, task=task, model=model,
                         aero_backend=aero_backend, device=device)
