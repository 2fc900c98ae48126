"""Throughput of the env step (counterpart of neuralplane_tpu/measure.py:21-66).

A host loop around `env.step` with a fixed near-trim action (full throttle
command, neutral surfaces), after one warm-up step and a synchronize. On the
card the time is taken with CUDA events and the peak of
`torch.cuda.max_memory_allocated()` is recorded; there is no CPU fallback
for device="cuda".
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from .envs import ControlEnv


def measure_env_step(n: int, steps: int = 500, scenario: str = "heading",
                     model: str = "F16", aero_backend: str = "auto",
                     device="cuda", seed: int = 0) -> Dict:
    """Time `steps` env steps at batch size n. Returns a timing dict; the
    env and its final state are under "env" and "state"."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    env = ControlEnv(num_envs=n, config=scenario, model=model,
                     aero_backend=aero_backend, device=dev)
    state, _ = env.reset(seed)
    action = torch.zeros((env.n, env.num_actions), dtype=torch.float32, device=dev)
    action[:, 0] = 1.0

    state, out = env.step(state, action)   # warm-up
    if cuda:
        torch.cuda.synchronize(dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, out = env.step(state, action)
    if cuda:
        end.record()
        torch.cuda.synchronize(dev)
        elapsed = start.elapsed_time(end) / 1e3
    else:
        elapsed = time.perf_counter() - t0
    return {
        "n": env.n,
        "steps": steps,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "elapsed_s": elapsed,
        "s_per_step": elapsed / steps,
        "agent_steps_per_s": env.n * steps / elapsed,
        "peak_mem_mb": (torch.cuda.max_memory_allocated(dev) / 2 ** 20
                        if cuda else None),
        "env": env,
        "state": state,
        "out": out,
    }
