"""Reading the device's work from torch.profiler, and the benchmark's spans.

`Trace` profiles a stretch of the run with CPU and CUDA activities and
reduces it to intervals: each device operation (kernels, copies, sets) on
the profiler's clock, and the benchmark's own spans (`record_function`
around the calls into each layer). From them: the device's busy seconds
(the union of the operations' intervals), the operations that took most
time, the launches inside a span, and the longest idle gaps of the device,
each named by the span the host was in and the operation before it. The
raw events are read from the profiler's result directly, which keeps the
reading of a trace of a million launches to seconds (`key_averages` builds
a Python object per event).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

SPANS = ("collect", "update", "step")


class Trace:
    def __init__(self):
        self.device_ops: List[Tuple[int, int, str]] = []   # (start ns, end ns, name)
        self.spans: List[Tuple[int, int, str]] = []
        self.by_name: Dict[str, Tuple[float, int]] = {}    # name -> (seconds, count)
        self.window_s = 0.0

    @contextlib.contextmanager
    def record(self):
        """Profile the block; the window is the host time between a
        synchronize before it and one after it."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield self
            torch.cuda.synchronize()
            self.window_s = time.perf_counter() - t0
        self._read(prof)

    def _read(self, prof) -> None:
        from torch.autograd import DeviceType
        for e in prof.profiler.kineto_results.events():
            start, dur, name = e.start_ns(), e.duration_ns(), e.name()
            if e.is_user_annotation() or name in SPANS:
                if e.device_type() != DeviceType.CUDA and name in SPANS:
                    self.spans.append((start, start + dur, name))
                continue
            if e.device_type() == DeviceType.CUDA and dur > 0:
                self.device_ops.append((start, start + dur, name))
        self.device_ops.sort()
        self.spans.sort()
        for s, e, name in self.device_ops:
            sec, cnt = self.by_name.get(name, (0.0, 0))
            self.by_name[name] = (sec + (e - s) * 1e-9, cnt + 1)

    # ---- reductions ----
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, end = 0, None
        for s, e, _ in self.device_ops:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-9

    def launches(self, span: Optional[str] = None) -> int:
        """Device operations, all or those that began inside `span`."""
        if span is None:
            return len(self.device_ops)
        windows = [(s, e) for s, e, n in self.spans if n == span]
        return sum(1 for s, _, _ in self.device_ops if any(a <= s <= b for a, b in windows))

    def top_ops(self, k: int = 10) -> List[list]:
        rows = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:k]
        return [[name, sec] for name, (sec, _) in rows]

    def kernel_times(self, names: Sequence[str]) -> List[float]:
        """Durations (s) of every device operation whose name contains one of
        `names`."""
        return [(e - s) * 1e-9 for s, e, n in self.device_ops if any(k in n for k in names)]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The k longest gaps between device operations, each named by the
        span the host was in when it began and the operation before it."""
        gaps = []
        end, before = None, None
        for s, e, name in self.device_ops:
            if end is not None and s > end:
                gaps.append((s - end, end, before))
            if end is None or e > end:
                end, before = e, name
        gaps.sort(reverse=True)
        out = []
        for dur, at, before in gaps[:k]:
            span = next((n for a, b, n in self.spans if a <= at <= b), "between spans")
            out.append([f"{span}: after {before[:80]}", dur * 1e-9])
        return out


@contextlib.contextmanager
def span(name: str, times: Optional[list] = None, sync: bool = False):
    """A span of the benchmark's own around a call into a layer: a
    `record_function` range the profiler sees, and with `sync` its host
    time between two synchronizes appended to `times`."""
    from torch.profiler import record_function
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with record_function(name):
        yield
    if sync:
        torch.cuda.synchronize()
    if times is not None:
        times.append(time.perf_counter() - t0)

