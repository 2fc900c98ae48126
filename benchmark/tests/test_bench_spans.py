"""The seven readers of the program's spans (benchmark/program_spans.py and
benchmark/metrics/{act,env}_ms_per_step, idle_in_{act,env}.train,
update_{forward,backward,optimizer}_s) against hand-worked values on a
synthetic trace, on a program without the recorder, and on a real CPU
collect and update of the port under torch.profiler."""
from __future__ import annotations

import sys
from collections import namedtuple

import pytest

from benchmark import harness, program_spans
from benchmark.trace import Trace

NEW = ("act_ms_per_step", "env_ms_per_step", "idle_in_act.train", "idle_in_env.train",
       "update_forward_s", "update_backward_s", "update_optimizer_s")
Span = namedtuple("Span", "name parent start_ns end_ns device_ms")
US = 1000


def read(name, ctx):
    return harness.metric_reader(name).read(ctx)


def synthetic(device=True):
    """A warm-up collect outside the profiled stretch, then the profiled
    collect (T = 4, two acts and two env steps, 0-1000 us) and an update of
    two minibatches; device work at 0-50, 300-500 and 850-950 us."""
    spans = []

    def add(name, parent, a, b, ms=None):
        spans.append(Span(name, parent, a * US, b * US, ms if device else None))
        return len(spans) - 1
    warm = add("runner.collect", None, -9000, -8000)
    add("policy.act", warm, -8900, -8500)
    c = add("runner.collect", None, 0, 1000)
    add("policy.act", c, 100, 400)
    add("env.step", c, 400, 600)
    add("policy.act", c, 600, 800)
    add("env.step", c, 800, 900)
    u = add("trainer.update", None, 2000, 5000)
    for fwd, bwd, opt, t in ((1.5, 2.0, 0.25, 2100), (0.5, 1.0, 0.25, 3000)):
        add("trainer.forward", u, t, t + 100, fwd)
        add("trainer.backward", u, t + 100, t + 300, bwd)
        add("trainer.optimizer", u, t + 300, t + 400, opt)
    tr = Trace()
    tr.spans = [(-10 * US, 1010 * US, "collect"), (1990 * US, 5010 * US, "update")]
    tr.device_ops = [(0, 50 * US, "k"), (300 * US, 500 * US, "k"), (850 * US, 950 * US, "k"),
                     (2100 * US, 4000 * US, "k")]
    return {"trace": tr, "T": 4, "program_spans": spans}


def test_hand_worked_values():
    ctx = synthetic()
    got = {n: read(n, ctx) for n in NEW}
    # acts 300 + 200 us, env steps 200 + 100 us, over T = 4 steps (not the
    # two spans of each)
    assert got["act_ms_per_step"] == pytest.approx(0.5 / 4)
    assert got["env_ms_per_step"] == pytest.approx(0.3 / 4)
    # idle: 50-300 (50 the collect's own, 200 act), 500-850 (100 env, 200
    # act, 50 env: the gap straddles both), 950-1000 (the collect's own)
    assert got["idle_in_act.train"] == pytest.approx(100 * 400 / 650)
    assert got["idle_in_env.train"] == pytest.approx(100 * 150 / 650)
    assert got["update_forward_s"] == pytest.approx(2.0e-3)
    assert got["update_backward_s"] == pytest.approx(3.0e-3)
    assert got["update_optimizer_s"] == pytest.approx(0.5e-3)


def test_idle_outside_any_leaf_goes_to_neither():
    ctx = synthetic()
    split = program_spans.idle_split(ctx)
    assert split == {"all": 650 * US, "runner.collect": 100 * US, "policy.act": 400 * US,
                     "env.step": 150 * US}
    # no device work at all: every idle ns is somewhere; the collect's own
    # 200 us go to neither metric
    ctx["trace"].device_ops = []
    assert read("idle_in_act.train", ctx) == pytest.approx(50.0)
    assert read("idle_in_env.train", ctx) == pytest.approx(30.0)
    # the collect busy throughout: nothing to share
    ctx["trace"].device_ops = [(-5 * US, 1005 * US, "k")]
    assert read("idle_in_act.train", ctx) is None


def test_the_profiled_collect_is_the_one_the_trace_ranges_overlap():
    ctx = synthetic()
    ctx["trace"].spans = [(-9010 * US, -7990 * US, "collect")]
    assert read("act_ms_per_step", ctx) == pytest.approx(0.4 / 4)   # the warm-up's
    ctx["trace"].spans = []
    assert all(read(n, ctx) is None for n in NEW)


def test_cpu_spans_give_no_update_time():
    ctx = synthetic(device=False)
    assert read("act_ms_per_step", ctx) == pytest.approx(0.5 / 4)
    for n in ("update_forward_s", "update_backward_s", "update_optimizer_s"):
        assert read(n, ctx) is None


@pytest.mark.parametrize("missing", ["no recorder", "no module", "empty"])
def test_a_program_without_the_recorder_gives_none(monkeypatch, missing):
    ctx = synthetic()
    del ctx["program_spans"]
    if missing == "no recorder":
        from neuralplane_tpu_torch.utils import profiling
        monkeypatch.delattr(profiling, "recorded")
    elif missing == "no module":
        monkeypatch.setitem(sys.modules, "neuralplane_tpu_torch.utils.profiling", None)
    else:
        ctx["program_spans"] = []
    assert {n: read(n, ctx) for n in NEW} == dict.fromkeys(NEW)


def test_a_cpu_collect_and_update_of_the_port(tmp_path):
    """The port's own spans under a CPU profiler, beside the benchmark's
    ranges: the host metrics read, the update's phases have no device time."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.envs import ControlEnv
    from neuralplane_tpu_torch.runner import F16SimRunner
    from neuralplane_tpu_torch.utils import profiling
    T = 8
    cfg = RLConfig(buffer_size=T, data_chunk_length=4, hidden_sizes=(16,), act_hidden_sizes=(8,),
                   recurrent_hidden_size=8, n_rollout_threads=4, ppo_epoch=1, num_mini_batch=2)
    run = F16SimRunner(ControlEnv(num_envs=4, config="heading", device="cpu"), cfg,
                       run_dir=str(tmp_path))
    carry = run.init_carry(run.next_seed())
    profiling.clear()
    tr = Trace()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("collect"):
                carry, batch, _ = run.collect(carry)
            with trace.span("update"):
                run.train(batch)
        tr._read(prof)
        ctx = {"trace": tr, "T": T}
        got = {n: read(n, ctx) for n in NEW}
        i, found = program_spans.profiled(ctx, "runner.collect", "collect")
        collect_ms = (found[i].end_ns - found[i].start_ns) * 1e-6
    finally:
        profiling.clear()
    assert tr.device_ops == [] and {n for _, _, n in tr.spans} == {"collect", "update"}
    assert got["act_ms_per_step"] > 0 and got["env_ms_per_step"] > 0
    # no device work on the CPU: the collect is idle throughout, split by
    # the host's time in each span
    assert 0 < got["idle_in_act.train"] < 100 and 0 < got["idle_in_env.train"] < 100
    assert got["idle_in_act.train"] + got["idle_in_env.train"] < 100
    assert got["update_forward_s"] is None and got["update_backward_s"] is None
    assert got["update_optimizer_s"] is None
    assert got["idle_in_act.train"] / 100 * collect_ms == pytest.approx(got["act_ms_per_step"] * T)
    assert got["idle_in_env.train"] / 100 * collect_ms == pytest.approx(got["env_ms_per_step"] * T)
