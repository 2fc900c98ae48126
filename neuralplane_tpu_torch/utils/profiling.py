"""Profiling / tracing harness (counterpart of
neuralplane_tpu/utils/profiling.py).

`trace(log_dir)` captures a torch.profiler trace of the host and, where a
card is present, of the device (kernel launches by name), written as a
Chrome trace (`<log_dir>/trace.json`, viewable in ui.perfetto.dev);
`time_fn` times a callable with the device synchronised around the timed
calls (warm-up calls excluded).

`span(name)` marks a stretch of the program's own work (the collect, the
policy's act, the env step, the update and its phases). It records only
while a torch.profiler records or inside `record_spans()`; otherwise it
costs one check. A recorded span keeps its name, its parent (the
enclosing span on the same thread) and its host start and end in
nanoseconds since the epoch, the clock the profiler's events carry, so
that they can be laid beside the profiler's device operations; under a
profiler it also opens a `record_function` range of its name inside its
stamps, which the Chrome trace shows beside the kernels. With
`device=True` it records a CUDA event pair on the current stream, read
(`device_ms`) by `recorded()` once the caller has synchronised.
`recorded()` returns the spans, `clear()` empties the recorder.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


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


# ---------------------------------------------------------------- spans
@dataclasses.dataclass
class Span:
    """One recorded span: `parent` is the index in `recorded()` of the span
    that enclosed it on its thread (None at the top); host times in ns
    since the epoch (`end_ns` None while open); `device_ms` the stream time
    between its CUDA events, None where it recorded none."""
    name: str
    parent: Optional[int]
    start_ns: int
    end_ns: Optional[int] = None
    device_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)


_spans: List[Span] = []
_recording = 0
_thread = threading.local()
_profiler_enabled = torch.autograd._profiler_enabled


class _Off:
    """What `span` returns while nothing records: enters and exits only."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "device", "range", "rec")

    def __init__(self, name: str, device: bool):
        self.name, self.device, self.range = name, device, None

    def __enter__(self):
        stack = getattr(_thread, "stack", None)
        if stack is None:
            stack = _thread.stack = []
        rec = Span(self.name, stack[-1] if stack else None, time.time_ns())
        if _profiler_enabled():
            self.range = record_function(self.name)
            self.range.__enter__()
        if self.device:
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        stack.append(len(_spans))
        _spans.append(rec)
        self.rec = rec
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record()
        if self.range is not None:
            self.range.__exit__(*exc)
        rec.end_ns = time.time_ns()
        _thread.stack.pop()
        return False


def span(name: str, device: bool = False):
    """`with span("runner.collect"): ...`; `device=True` only where the
    work runs on a CUDA device (the current stream is timed)."""
    if not (_recording or _profiler_enabled()):
        return _OFF
    return _On(name, device)


@contextlib.contextmanager
def record_spans():
    """Record spans inside the block without a profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def recorded() -> List[Span]:
    """The spans recorded since the last `clear()`, in the order they
    opened, each span's `device_ms` read from its events (which waits for
    them: call after the timed work)."""
    for rec in _spans:
        if rec.events is not None and rec.device_ms is None and rec.end_ns is not None:
            rec.events[1].synchronize()
            rec.device_ms = rec.events[0].elapsed_time(rec.events[1])
    return list(_spans)


def clear() -> None:
    """Empty the recorder (between spans, not inside one)."""
    _spans.clear()
