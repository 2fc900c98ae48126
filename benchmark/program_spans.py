"""The program's own spans, as the per-layer metrics read them.

The program records spans at the boundaries of its collect and its PPO
update (`neuralplane_tpu_torch/utils/profiling.py`) while torch.profiler
records: in a `--trace 1` run, the window's first iteration. Each span has
a name, the index of its parent, host start and end in ns since the epoch
(the clock of the profiler's events) and, for the update's phases, the
stream time between two CUDA events (`device_ms`).

Here the profiled `runner.collect` and `trainer.update` are the ones that
overlap the benchmark's own `collect` and `update` ranges in the trace.
From them: the host time inside their child spans, the update's phases'
stream time, and the device's idle time inside the collect split by the
innermost open span. Every function returns None where there is nothing
to read: a program without the recorder, or a stretch that recorded no
span. Only this module, `program.py` and the drivers import the program.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

COLLECT, ACT, ENV = "runner.collect", "policy.act", "env.step"
UPDATE = "trainer.update"
PHASES = ("trainer.forward", "trainer.backward", "trainer.optimizer")


def spans(ctx: dict) -> Optional[list]:
    """The spans of ctx["program_spans"] where it is set, else the
    program's recorder's; None where there are none."""
    if "program_spans" in ctx:
        return ctx["program_spans"] or None
    try:
        from neuralplane_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    return (recorded() or None) if recorded is not None else None


def profiled(ctx: dict, name: str, bench_span: str) -> Optional[Tuple[int, list]]:
    """(index, all spans) of the first closed span `name` that overlaps one
    of the trace's `bench_span` ranges; None where there is none."""
    tr, found = ctx.get("trace"), spans(ctx)
    if tr is None or found is None:
        return None
    ranges = [(a, b) for a, b, n in tr.spans if n == bench_span]
    for i, s in enumerate(found):
        if s.name == name and s.end_ns is not None and \
                any(s.start_ns < b and a < s.end_ns for a, b in ranges):
            return i, found
    return None


def children(found: list, parent: int, name: str) -> list:
    return [s for s in found if s.parent == parent and s.name == name]


def host_ms_per_step(ctx: dict, name: str) -> Optional[float]:
    """Host ms inside the profiled collect's child spans `name`, over the
    collect's `T` steps."""
    got = profiled(ctx, COLLECT, "collect")
    if got is None:
        return None
    inside = children(got[1], got[0], name)
    if not inside:
        return None
    return sum(s.end_ns - s.start_ns for s in inside) * 1e-6 / ctx["T"]


def phase_s(ctx: dict, name: str) -> Optional[float]:
    """Stream seconds of the profiled update's phase `name`, summed over
    its minibatches; None where a phase carries no device time."""
    got = profiled(ctx, UPDATE, "update")
    if got is None:
        return None
    inside = children(got[1], got[0], name)
    if not inside or any(s.device_ms is None for s in inside):
        return None
    return sum(s.device_ms for s in inside) * 1e-3


def _merge(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _innermost(found: list, root: int) -> List[Tuple[int, int, str]]:
    """Segments (start, end, name) that tile span `root`, each named by
    the innermost span open in it."""
    kids: Dict[int, List[int]] = {}
    for i, s in enumerate(found):
        if s.parent is not None and s.end_ns is not None:
            kids.setdefault(s.parent, []).append(i)

    def walk(i: int) -> List[Tuple[int, int, str]]:
        s, t, out = found[i], found[i].start_ns, []
        for k in sorted(kids.get(i, []), key=lambda k: found[k].start_ns):
            out.append((t, found[k].start_ns, s.name))
            out.extend(walk(k))
            t = found[k].end_ns
        out.append((t, s.end_ns, s.name))
        return [seg for seg in out if seg[1] > seg[0]]
    return walk(root)


def _overlaps(xs: List[Tuple[int, int]], ys: List[Tuple[int, int, str]]) -> List[int]:
    """For each segment of `ys` (sorted, disjoint), the ns it shares with
    the intervals `xs` (sorted, disjoint)."""
    out, j = [], 0
    for a, b, _ in ys:
        while j < len(xs) and xs[j][1] <= a:
            j += 1
        k, total = j, 0
        while k < len(xs) and xs[k][0] < b:
            total += min(b, xs[k][1]) - max(a, xs[k][0])
            k += 1
        out.append(total)
    return out


def idle_split(ctx: dict) -> Optional[Dict[str, int]]:
    """The device's idle ns inside the profiled collect (the complement of
    the union of the trace's device operations), by the innermost program
    span open at the time, with the total under "all"."""
    got = profiled(ctx, COLLECT, "collect")
    if got is None:
        return None
    i, found = got
    lo, hi = found[i].start_ns, found[i].end_ns
    busy = _merge([(max(s, lo), min(e, hi)) for s, e, _ in ctx["trace"].device_ops
                   if e > lo and s < hi])
    idle, t = [], lo
    for a, b in busy:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    if hi > t:
        idle.append((t, hi))
    segs = _innermost(found, i)
    out = {"all": sum(b - a for a, b in idle)}
    for (_, _, name), ns in zip(segs, _overlaps(idle, segs)):
        out[name] = out.get(name, 0) + ns
    return out


def idle_share(ctx: dict, name: str) -> Optional[float]:
    """The share (%) of the profiled collect's device idle time during
    which `name` was the innermost open span."""
    split = idle_split(ctx)
    if not split or not split["all"]:
        return None
    return 100.0 * split.get(name, 0) / split["all"]
