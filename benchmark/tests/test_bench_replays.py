"""The reader of `act_graph_replays_per_step` (benchmark/metrics/): the
`policy.act.replay` spans inside the profiled collect's `policy.act` spans
over its T steps, on the synthetic trace of test_bench_spans.py, on a
program whose collect replays nothing, on a program without the recorder,
and on a real CPU collect of the port (eager there: 0)."""
from __future__ import annotations

import pytest

from benchmark.trace import Trace

from .test_bench_spans import US, Span, read, synthetic

NAME = "act_graph_replays_per_step"


def with_replays(ctx, acts):
    """Add one replay span inside each `policy.act` whose index is in `acts`."""
    spans = ctx["program_spans"]
    for i in acts:
        a = spans[i]
        spans.append(Span("policy.act.replay", i, a.start_ns + 10 * US, a.end_ns - 10 * US, None))
    return ctx


def acts_of(ctx, collect_start):
    spans = ctx["program_spans"]
    c = next(i for i, s in enumerate(spans)
             if s.name == "runner.collect" and s.start_ns == collect_start * US)
    return [i for i, s in enumerate(spans) if s.name == "policy.act" and s.parent == c]


def test_no_replay_reads_zero():
    assert read(NAME, synthetic()) == 0.0


def test_replays_inside_the_profiled_collects_acts():
    ctx = synthetic()
    with_replays(ctx, acts_of(ctx, 0))
    assert read(NAME, ctx) == pytest.approx(2 / 4)


def test_replays_elsewhere_are_not_counted():
    ctx = synthetic()
    # the warm-up collect's act, and a replay span hung on the collect itself
    with_replays(ctx, acts_of(ctx, -9000))
    spans = ctx["program_spans"]
    c = next(i for i, s in enumerate(spans) if s.name == "runner.collect" and s.start_ns == 0)
    spans.append(Span("policy.act.replay", c, 950 * US, 960 * US, None))
    assert read(NAME, ctx) == 0.0


@pytest.mark.parametrize("missing", ["no spans", "no trace range"])
def test_nothing_to_read_gives_none(missing):
    ctx = synthetic()
    if missing == "no spans":
        ctx["program_spans"] = []
    else:
        ctx["trace"].spans = []
    assert read(NAME, ctx) is None


def test_a_cpu_collect_of_the_port_replays_nothing(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.envs import ControlEnv
    from neuralplane_tpu_torch.runner import F16SimRunner
    from neuralplane_tpu_torch.utils import profiling
    T = 8
    cfg = RLConfig(buffer_size=T, data_chunk_length=4, hidden_sizes=(16,), act_hidden_sizes=(8,),
                   recurrent_hidden_size=8, n_rollout_threads=4)
    run = F16SimRunner(ControlEnv(num_envs=4, config="heading", device="cpu"), cfg,
                       run_dir=str(tmp_path))
    carry = run.init_carry(run.next_seed())
    profiling.clear()
    tr = Trace()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("collect"):
                run.collect(carry)
        tr._read(prof)
        got = read(NAME, {"trace": tr, "T": T})
    finally:
        profiling.clear()
        run.close()
    assert got == 0.0
