"""Throughput harness (counterpart of neuralplane_tpu/measure.py).

Times the env step at batch sizes n = 10^0 .. 10^6 (the heading env) and
the four combat envs at n = 10^1 .. 10^6 aircraft: a host loop around
`env.step` with a fixed action, after one warm-up step and a synchronize.
On the card the span is taken with CUDA events recorded after a
synchronize and read after another, so it covers the host's dispatch as the
JAX package's wall clock does; the host wall time of the same span is
`wall_s`, and the two differ by what the host adds after the card's last
kernel. The peak of `torch.cuda.max_memory_allocated()` is reset per row.
There is no CPU fallback for device="cuda".

`measure_env_step` returns the env, its final state and the last step's
output under "env", "state" and "out"; `measure_combat_step`, whose "env" is
the env's name as in the JAX row, returns the env under "env_obj". The
sweeps are generators that yield rows without them (JSON-ready, as the JAX
package's rows are printed), so that each env is released before the next
is built.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator

import torch

from .envs import (ControlEnv, MultipleCombatEnv, MultipleCombatShootEnv, SingleCombatEnv,
                   SingleCombatShootEnv)
from .utils.config import load_config

# env name -> (class, scenario, whether the shoot bit is held high)
_COMBAT = {
    "SingleCombat": (SingleCombatEnv, "selfplay", False),
    "SingleCombatShoot": (SingleCombatShootEnv, "selfplay_shoot", True),
    "MultipleCombat": (MultipleCombatEnv, "multiple_selfplay", False),
    "MultipleCombatShoot": (MultipleCombatShootEnv, "multiple_selfplay_shoot", True),
}


def _tensors(obj, seen):
    """Every tensor reachable from obj through objects' attributes (a
    weight container's packed image too), dicts, lists and tuples; each
    object visited once."""
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v, seen)
    elif hasattr(obj, "__dict__"):
        for v in vars(obj).values():
            yield from _tensors(v, seen)


def _resident_mb(*roots) -> float:
    """MiB of the distinct storages that the tensors under `roots` hold
    (counterpart of the JAX row's nbytes over state, obs and weights)."""
    storages = {}
    seen = set()
    for root in roots:
        for t in _tensors(root, seen):
            st = t.untyped_storage()
            storages[(t.device, st.data_ptr())] = st.nbytes()
    return sum(storages.values()) / 2 ** 20


def _timed(env, state, action, steps: int, dev: torch.device) -> Dict:
    """One warm-up step, a synchronize, then `steps` timed steps: the loop's
    span (CUDA events on the card, the host clock on the CPU), its host
    wall time, and the final state and output."""
    cuda = dev.type == "cuda"
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
    wall = time.perf_counter() - t0
    elapsed = start.elapsed_time(end) / 1e3 if cuda else wall
    return {"elapsed_s": elapsed, "wall_s": wall, "state": state, "out": out}


def _start(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _memory(dev: torch.device, env, state, out) -> Dict:
    """The row's memory figures: the allocator's bytes in use now and its
    peak since `_start` (NaN and None on the CPU), and the resident bytes of
    the state, the obs and the aero weights."""
    cuda = dev.type == "cuda"
    return {
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "device_mem_mb": torch.cuda.memory_allocated(dev) / 2 ** 20 if cuda else float("nan"),
        "peak_mem_mb": torch.cuda.max_memory_allocated(dev) / 2 ** 20 if cuda else None,
        "resident_state_mb": _resident_mb(state, out.obs, env.model.weights),
        "finite": bool(torch.isfinite(state.model.s).all() and torch.isfinite(out.obs).all()),
    }


def measure_env_step(n: int, steps: int = 500, scenario: str = "heading",
                     model: str = "F16", aero_backend: str = "auto",
                     device="cuda", seed: int = 0) -> Dict:
    """Time `steps` env steps at batch size n with a near-trim action (full
    throttle command, neutral surfaces). Returns the timing row; the env
    and its final state and output are under "env", "state" and "out"."""
    dev = torch.device(device)
    _start(dev)
    env = ControlEnv(num_envs=n, config=scenario, model=model,
                     aero_backend=aero_backend, device=dev)
    state, _ = env.reset(seed)
    action = torch.zeros((env.n, env.num_actions), dtype=torch.float32, device=dev)
    action[:, 0] = 1.0
    t = _timed(env, state, action, steps, dev)
    return {
        "n": env.n,
        "steps": steps,
        "elapsed_s": t["elapsed_s"],
        "wall_s": t["wall_s"],
        "s_per_step": t["elapsed_s"] / steps,
        "agent_steps_per_s": env.n * steps / t["elapsed_s"],
        **_memory(dev, env, t["state"], t["out"]),
        "env": env,
        "state": t["state"],
        "out": t["out"],
    }


def _json_row(row: Dict) -> Dict:
    """The row without the env, its state and its output: its numbers,
    names and flags."""
    return {k: v for k, v in row.items()
            if v is None or isinstance(v, (str, int, float, bool))}


def _sweep_row(measure, dev: torch.device, **kw) -> Dict:
    """One JSON-ready row of a sweep. A size the card cannot hold becomes a
    row with the error and the peak MiB reached, and the sweep goes on."""
    try:
        return _json_row(measure(device=dev, **kw))
    except torch.cuda.OutOfMemoryError as e:
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        torch.cuda.empty_cache()
        named = {"env": kw["env_name"]} if "env_name" in kw else {}
        return {**named, "n": kw["n"], "steps": kw["steps"],
                "error": str(e).splitlines()[0], "peak_mem_mb": peak}


def measure_sweep(max_exp: int = 6, steps: int = 500, device="cuda") -> Iterator[Dict]:
    """The heading step at n = 10^0 .. 10^max_exp, one JSON-ready row per
    size as it finishes."""
    dev = torch.device(device)
    for e in range(max_exp + 1):
        yield _sweep_row(measure_env_step, dev, n=10 ** e, steps=steps)


def measure_combat_step(n: int, steps: int = 500, env_name: str = "SingleCombat",
                        aero_backend: str = "auto", device="cuda") -> Dict:
    """Time the combat-family env step at about n agents.

    The same protocol as measure_env_step on the four combat envs: the gun
    1v1 (5 PID-stabilised FDM steps per env step), the team game (1 step
    and all-pairs geometry) and their missile variants, with the shoot bit
    held high (mid-bin demands [20, 20, 20, 20, 1]) so that launch gating,
    PN flight and hit tests all run; the guns-only envs get the near-trim
    action. n is rounded down to a whole number of env groups;
    `aero_backend` goes to the 1v1 envs only, as in the JAX package."""
    cls, config, shoot = _COMBAT[env_name]
    dev = torch.device(device)
    _start(dev)
    num_envs = max(1, n // load_config(config).num_agents)
    kw = {} if env_name.startswith("Multiple") else {"aero_backend": aero_backend}
    env = cls(num_envs=num_envs, config=config, device=dev, **kw)
    row = [20.0, 20.0, 20.0, 20.0, 1.0] if shoot else [1.0, 0.0, 0.0, 0.0]
    action = torch.tensor([row], dtype=torch.float32, device=dev).repeat(env.n, 1)
    state, _ = env.reset(0)
    t = _timed(env, state, action, steps, dev)
    return {
        "env": env_name,
        "n": env.n,
        "num_envs": num_envs,
        "steps": steps,
        "elapsed_s": t["elapsed_s"],
        "wall_s": t["wall_s"],
        "s_per_step": t["elapsed_s"] / steps,
        "agent_steps_per_s": env.n * steps / t["elapsed_s"],
        "inner_fdm_steps": env.inner_steps,
        **_memory(dev, env, t["state"], t["out"]),
        "env_obj": env,
        "state": t["state"],
        "out": t["out"],
    }


def measure_combat_sweep(max_exp: int = 6, steps: int = 200,
                         device="cuda") -> Iterator[Dict]:
    """The four combat envs at n = 10^1 .. 10^max_exp total agents, one
    JSON-ready row per size as it finishes."""
    dev = torch.device(device)
    for env_name in _COMBAT:
        for e in range(1, max_exp + 1):
            yield _sweep_row(measure_combat_step, dev, n=10 ** e, steps=steps,
                             env_name=env_name)
