"""The task layer on its own: the Hopper kernel and its plain version
(counterpart of neuralplane_tpu/ops/task_pallas.py:238-291,
`task_step_pallas`).

`task_step(...)` launches `csrc/task_step.cu` on CUDA tensors (a failure
raises) and runs `task_step_plain` on CPU tensors; nothing else.
`task_step.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build
from .task import N_CND, N_OBS, VARIANTS, task_consts, task_rows

N_S, N_U = 12, 5


def task_step_plain(variant: str, cfg, s: torch.Tensor, u: torch.Tensor,
                    xdot: torch.Tensor, targets: Tuple,
                    step_count: torch.Tensor) -> Tuple:
    """Plain PyTorch twin of the kernel: `ops/task.py:task_rows` plus the
    stacking and the counts."""
    obs_rows, done, bad, reward, conds = task_rows(
        variant, task_consts(cfg), tuple(s[:, i] for i in range(N_S)),
        tuple(u[:, i] for i in range(N_U)), tuple(xdot[:, i] for i in range(N_S)),
        tuple(targets), step_count)
    counts = torch.stack([c.sum() for c in conds]).to(torch.int32)
    return torch.stack(obs_rows, dim=1), done, bad, reward, counts


class TaskParams(ctypes.Structure):
    """Scalars of one launch; must match `struct TaskParams` in
    csrc/task_step.cu field for field."""
    _fields_ = [
        ("n", ctypes.c_int), ("variant", ctypes.c_int),
        ("max_check", ctypes.c_int), ("min_check", ctypes.c_int),
        ("airspeed", ctypes.c_float), ("acc_limit", ctypes.c_float),
        ("alt_limit", ctypes.c_float), ("max_mach", ctypes.c_float),
        ("min_mach", ctypes.c_float), ("min_alpha", ctypes.c_float),
        ("max_alpha", ctypes.c_float), ("min_beta", ctypes.c_float),
        ("max_beta", ctypes.c_float),
    ]


def _lib():
    lib = cuda_build.load("task_step")
    if not getattr(lib, "_np_typed", False):
        p = ctypes.c_void_p
        # s u xdot tg0 tg1 tg2 sc | params | obs done bad reward counts | stream
        lib.np_task_step.argtypes = [p] * 7 + [TaskParams] + [p] * 5 + [p]
        lib.np_task_step.restype = ctypes.c_int
        lib._np_typed = True
    return lib


def task_step(variant: str, cfg, s: torch.Tensor, u: torch.Tensor,
              xdot: torch.Tensor, targets: Tuple, step_count: torch.Tensor,
              device="cuda") -> Tuple:
    """Fused task layer with the contract of task_step_pallas: the
    post-step s [n,12] and u [n,5], the step-start xdot [n,12], three [n]
    targets and the post-reset step count. Returns (obs [n,22] noiseless,
    done bool[n], bad bool[n], reward f32[n], counts int32[6] in COND_NAMES
    order for the variant).

    Runs on `device`, where the tensors must already lie: the card by
    default; the tests pass CPU tensors and device="cpu"."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    n = s.shape[0]
    if s.shape != (n, N_S) or u.shape != (n, N_U) or xdot.shape != (n, N_S):
        raise ValueError(f"want s [n,12], u [n,5], xdot [n,12]; got {tuple(s.shape)}, "
                         f"{tuple(u.shape)}, {tuple(xdot.shape)}")
    dev = s.device
    if torch.device(device).type != dev.type:
        raise ValueError(f"device={device!r} but the state is on {dev}")
    f32 = [s, u, xdot, *targets]
    if len(targets) != 3 or any(t.dtype != torch.float32 or t.device != dev for t in f32):
        raise TypeError("state, control, xdot and the three targets must be "
                        "float32 on one device")
    if dev.type != "cuda":
        return task_step_plain(variant, cfg, s, u, xdot, targets, step_count)
    s, u, xdot = s.contiguous(), u.contiguous(), xdot.contiguous()
    tg = [t.contiguous() for t in targets]
    sc = step_count.to(device=dev, dtype=torch.int32).contiguous()
    obs = torch.empty((n, N_OBS), dtype=torch.float32, device=dev)
    done = torch.empty(n, dtype=torch.bool, device=dev)
    bad = torch.empty(n, dtype=torch.bool, device=dev)
    reward = torch.empty(n, dtype=torch.float32, device=dev)
    counts = torch.zeros(N_CND, dtype=torch.int32, device=dev)
    if n:
        tc = task_consts(cfg)
        params = TaskParams(n=n, variant=VARIANTS.index(variant), **tc)
        lib = _lib()
        code = lib.np_task_step(
            s.data_ptr(), u.data_ptr(), xdot.data_ptr(),
            *(t.data_ptr() for t in tg), sc.data_ptr(), params,
            obs.data_ptr(), done.data_ptr(), bad.data_ptr(), reward.data_ptr(),
            counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        task_step.launches += 1
        cuda_build.check(code, "task_step", lib)
    return obs, done, bad, reward, counts


task_step.launches = 0
