"""Environment state and step outputs (counterpart of neuralplane_tpu/envs/types.py).

The JAX EnvState carries its PRNG key; here the env owns a torch.Generator
on its device, seeded by `Env.reset(seed)`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class EnvState:
    model: Any                        # F16State or F16StateFM
    task: Any                         # task target dataclass
    step_count: torch.Tensor          # [n] int32
    is_done: torch.Tensor             # [n] bool - goal reached
    bad_done: torch.Tensor            # [n] bool - constraint violation
    exceed_time_limit: torch.Tensor   # [n] bool - truncation

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class StepOutput:
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    bad_done: torch.Tensor
    exceed_time_limit: torch.Tensor
    info: Any = None   # {"termination/<name>": 0-d int tensor on the device}
    # per-agent liveness after the step (float [n]); the team combat env
    # sets it (MAPPO's active masks, the ELO event scoring), None elsewhere
    active: Any = None
