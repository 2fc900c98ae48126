"""Profiling / tracing harness (counterpart of
neuralplane_tpu/utils/profiling.py).

`trace(log_dir)` captures a torch.profiler trace of the host and, where a
card is present, of the device (kernel launches by name), written as a
Chrome trace (`<log_dir>/trace.json`, viewable in ui.perfetto.dev);
`time_fn` times a callable with the device synchronised around the timed
calls (warm-up calls excluded).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch
from torch.profiler import ProfilerActivity, profile


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str = "neuralplane_trace"):
    """`with trace("dir") as prof: run_workload()`; on exit the trace is in
    `dir/trace.json` (and `prof.key_averages()` sums it by name)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1,
            **kwargs) -> Dict[str, float]:
    """Wall time of fn(*args, **kwargs) with the device synchronised.

    Returns {mean_s, total_s, iters}; the warm-up calls are excluded."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _sync()
    total = time.perf_counter() - t0
    return {"mean_s": total / iters, "total_s": total, "iters": iters}
