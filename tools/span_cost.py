"""What the port's spans (neuralplane_tpu_torch/utils/profiling.py) cost
when they record, and whether they share the profiler's clock.

    python tools/span_cost.py [--config benchmark/configs/heading_43nets.json]
        [--pairs 3] [--profiled 2] [--n N] [--buffer T] [--device cuda]
        [--out build/span_cost.json]

Builds the configuration's env and PPO runner (`benchmark/program.py`),
runs one warm-up iteration, then `--pairs` pairs of whole iterations, one
inside `record_spans()` and one without, alternating which goes first;
each collect and update is timed on the host between synchronizes. Then
`--profiled` iterations under torch.profiler (CPU and, on a card, CUDA
activities) with the benchmark's own `collect` and `update` ranges around
the calls, as a `--trace 1` run has them: for each, the offsets (ns) of
the program's `runner.collect` and `trainer.update` spans from those
ranges at both ends, the quartiles of every span's offsets from the
`record_function` range it opened itself, and the profiled collect's ms
per step with its `policy.act` and `env.step` shares. The first profiled
iteration is a process's first range under a profiler, which pays the
profiler's own set-up inside that range. Last, a check of the clock
itself: host stamps right before and after a small op against the
profiler's event of that op, and a bare range's host cost. Between the
pairs and the profiled iterations: the host cost of one span, off,
recording and under a profiler (measured before the profiled iterations:
the garbage a profiled iteration leaves makes the collector's passes
dominate a tight loop of spans). Prints one JSON line and writes it to
`--out`.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import program  # noqa: E402
from benchmark import trace as btrace  # noqa: E402
from neuralplane_tpu_torch.runner import F16SimRunner  # noqa: E402
from neuralplane_tpu_torch.utils import profiling  # noqa: E402

NAMES = ("runner.collect", "policy.act", "env.step", "trainer.update", "trainer.forward",
         "trainer.backward", "trainer.optimizer")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def timed(fn, dev):
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def iteration(runner, carry, dev):
    (carry, batch, _), c = timed(lambda: runner.collect(carry), dev)
    _, u = timed(lambda: runner.train(batch), dev)
    return carry, c, u


def profiled(runner, carry, dev):
    """One iteration under torch.profiler; the offsets of the program's
    spans from the benchmark's ranges and from their own."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    profiling.clear()
    with profile(activities=acts) as prof:
        with btrace.span("collect", sync=dev.type == "cuda"):
            carry, batch, _ = runner.collect(carry)
        with btrace.span("update", sync=dev.type == "cuda"):
            runner.train(batch)
    spans = profiling.recorded()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in NAMES + btrace.SPANS and e.device_type().name == "CPU":
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    out = {}
    for mine, bench in (("runner.collect", "collect"), ("trainer.update", "update")):
        s = next(s for s in spans if s.name == mine)
        a, b = ranges[bench][0]
        out[mine + "_vs_" + bench] = [s.start_ns - a, b - s.end_ns]
    starts, ends = [], []
    for name in NAMES:
        own = sorted(ranges.get(name, []))
        st = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        assert len(own) == len(st), name
        starts += [c - a for (a, _), (c, _) in zip(st, own)]
        ends += [b - d for (_, b), (_, d) in zip(st, own)]
    out["own_range_start_ns"] = quartiles(starts)
    out["own_range_end_ns"] = quartiles(ends)
    c = next(s for s in spans if s.name == "runner.collect")
    T = runner.cfg.buffer_size
    out["collect_ms_per_step"] = (c.end_ns - c.start_ns) * 1e-6 / T
    for name in ("policy.act", "env.step"):
        out[name + "_ms_per_step"] = sum(s.end_ns - s.start_ns for s in spans
                                         if s.name == name) * 1e-6 / T
    out["spans"] = len(spans)
    profiling.clear()
    return carry, out


def quartiles(values):
    """[least, first quartile, median, third quartile, largest]."""
    v = sorted(values)
    return [v[0], v[len(v) // 4], v[len(v) // 2], v[3 * len(v) // 4], v[-1]]


def per_span_ns(dev, reps=20000):
    """Host ns of one empty `with span(...)` (an empty loop's ns taken
    off): off, inside `record_spans()` (with CUDA events where `dev` is a
    card) and under a profiler (its range included)."""
    from torch.profiler import ProfilerActivity, profile

    def loop(device=False, body=True):
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            if body:
                with profiling.span("cost", device=device):
                    pass
        return (time.perf_counter_ns() - t0) / reps
    gc.collect()
    empty = loop(body=False)
    out = {"off": loop() - empty}
    with profiling.record_spans():
        out["record_spans"] = loop() - empty
        if dev.type == "cuda":
            out["record_spans_events"] = loop(device=True) - empty
    profiling.recorded()
    profiling.clear()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts):
        out["profiler"] = loop() - empty
    profiling.clear()
    return out


def clock_bracket(dev, reps=200):
    """Host stamps (time.time_ns) right before and after a small device
    op under the profiler, against the profiler's own event of that op:
    quartiles of (op start - stamp before) and (stamp after - op end) in
    ns, all >= 0 where the two share a clock, and of a bare
    record_function's host cost (enter and exit, ns)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    x = torch.zeros(4, device=dev)
    stamps, costs = [], []
    with profile(activities=acts) as prof:
        for _ in range(reps):
            a = time.time_ns()
            x.add_(1.0)
            b = time.time_ns()
            stamps.append((a, b))
            t0 = time.perf_counter_ns()
            with record_function("bracket"):
                pass
            costs.append(time.perf_counter_ns() - t0)
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in
                 prof.profiler.kineto_results.events()
                 if e.name() == "aten::add_" and e.device_type() == DeviceType.CPU)
    assert len(ops) == reps, len(ops)
    return {"before_ns": quartiles([s - a for (a, _), (s, _) in zip(stamps, ops)]),
            "after_ns": quartiles([b - e for (_, b), (_, e) in zip(stamps, ops)]),
            "record_function_ns": quartiles(costs)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=os.path.join(ROOT, "benchmark/configs/heading_43nets.json"))
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--profiled", type=int, default=2)
    p.add_argument("--n", type=int, default=None, help="envs (default: the configuration's)")
    p.add_argument("--buffer", type=int, default=None, help="buffer_size (default: its)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=2147483901)
    p.add_argument("--out", default=os.path.join(ROOT, "build", "span_cost.json"))
    args = p.parse_args(argv)
    with open(args.config, encoding="utf-8") as f:
        config = json.load(f)
    if args.buffer:
        config["buffer_size"] = args.buffer
    n = args.n or config["n_rollout_threads"]
    config["n_rollout_threads"] = n
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    env = program.make_env(config, n, dev)
    with tempfile.TemporaryDirectory() as run_dir:
        runner = F16SimRunner(env, program.rl_config(config, args.seed), run_dir=run_dir)
        carry = runner.init_carry(runner.next_seed())
        carry, _, _ = iteration(runner, carry, dev)   # warm-up
        rows = {"on": [], "off": []}
        for k in range(args.pairs):
            for mode in (("on", "off") if k % 2 == 0 else ("off", "on")):
                profiling.clear()
                with (profiling.record_spans() if mode == "on" else contextlib.nullcontext()):
                    carry, c, u = iteration(runner, carry, dev)
                recorded = len(profiling.recorded())
                rows[mode].append({"collect_ms_per_step": c * 1e3 / config["buffer_size"],
                                   "update_s": u, "spans": recorded})
        cost = per_span_ns(dev)   # before the profiled iterations, whose garbage slows it
        clocks = []
        for _ in range(args.profiled):
            carry, out = profiled(runner, carry, dev)
            clocks.append(out)
        runner.close()
    bracket = clock_bracket(dev)
    line = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
            "n": n, "buffer_size": config["buffer_size"], "on": rows["on"], "off": rows["off"],
            "profiled": clocks, "clock_bracket": bracket, "per_span_ns": cost}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        f.write(json.dumps(line) + "\n")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
