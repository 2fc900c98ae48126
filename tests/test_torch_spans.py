"""The port's spans (neuralplane_tpu_torch/utils/profiling.py: span,
record_spans, recorded, clear) at the boundaries of the collect and the PPO
update, on a tiny heading run: 4 envs, a buffer of 16 in chunks of 8, 2
epochs x 2 minibatches.

- Off (no profiler, no `record_spans()`): nothing is recorded and no
  profiler range is opened.
- Under a CPU torch.profiler, and inside `record_spans()`, one collect
  records 16 `policy.act` and 16 `env.step` spans inside one
  `runner.collect`, one update 4 each of `trainer.forward`,
  `trainer.backward` and `trainer.optimizer` inside `trainer.update`.
- The spans' host stamps lie on the profiler's clock: for each name, the
  median distance to the `record_function` ranges they open is under 100
  us at both ends.
- On the CPU no span carries a device time.
- The spans change nothing: the same seed gives a bit-identical batch and
  bit-identical parameters after the update, spans on or off.
- On the card (`-m cuda`): the profiler's device operations hold no span's
  name, and a collect launches as many device operations with the spans on
  as with them off; after the warm-up collect each `policy.act` holds one
  `policy.act.replay` (the act's CUDA graph replayed).
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.envs import ControlEnv
from neuralplane_tpu_torch.runner import F16SimRunner
from neuralplane_tpu_torch.utils import profiling

T, L, N = 16, 8, 4
COLLECT = ("runner.collect", "policy.act", "env.step")
REPLAY = "policy.act.replay"
UPDATE = ("trainer.update", "trainer.forward", "trainer.backward", "trainer.optimizer")
PHASES = UPDATE[1:]


def tiny_runner(tmp_path, device="cpu"):
    cfg = RLConfig(buffer_size=T, data_chunk_length=L, hidden_sizes=(16,),
                   act_hidden_sizes=(8,), recurrent_hidden_size=8, n_rollout_threads=N,
                   ppo_epoch=2, num_mini_batch=2, seed=5)
    env = ControlEnv(num_envs=N, config="heading", device=device)
    return F16SimRunner(env, cfg, run_dir=str(tmp_path))


def iteration(run):
    """One collect and one update; returns the batch and the parameters."""
    carry = run.init_carry(run.next_seed())
    _, batch, _ = run.collect(carry)
    run.train(batch)
    params = {k: v.detach().clone() for k, v in run.policy.state_dict().items()}
    return batch, params


@pytest.fixture
def recorder():
    profiling.clear()
    yield profiling
    profiling.clear()


def names(spans):
    return [s.name for s in spans]


def check_tree(spans, replays=False):
    """The counts and parents of one collect and one update; with
    `replays`, one `policy.act.replay` inside each `policy.act`."""
    by = {n: [s for s in spans if s.name == n] for n in COLLECT + UPDATE + (REPLAY,)}
    assert len(by["runner.collect"]) == 1 and len(by["trainer.update"]) == 1
    assert len(by["policy.act"]) == T and len(by["env.step"]) == T
    assert all(len(by[n]) == 4 for n in PHASES)
    assert set(names(spans)) == set(COLLECT + UPDATE + ((REPLAY,) if replays else ()))
    collect, update = spans.index(by["runner.collect"][0]), spans.index(by["trainer.update"][0])
    assert spans[collect].parent is None and spans[update].parent is None
    for s in by["policy.act"] + by["env.step"]:
        assert s.parent == collect
    acts = [spans.index(s) for s in by["policy.act"]]
    assert sorted(s.parent for s in by[REPLAY]) == (acts if replays else [])
    for n in PHASES:
        assert all(s.parent == update for s in by[n])
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_off_records_nothing_and_opens_no_range(tmp_path, recorder, monkeypatch):
    def no_range(name):
        raise AssertionError(f"a profiler range was opened for {name}")
    monkeypatch.setattr(profiling, "record_function", no_range)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("x") is profiling.span("y", device=True)   # the one shared no-op
    iteration(tiny_runner(tmp_path))
    assert recorder.recorded() == []


def test_profiler_records_the_tree_on_its_clock(tmp_path, recorder):
    run = tiny_runner(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.profiler.record_function("warm-up"):
            pass   # a process's first range under a profiler costs ~1 ms of set-up
    recorder.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        iteration(run)
    spans = recorder.recorded()
    check_tree(spans)
    assert all(s.device_ms is None for s in spans)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in COLLECT + UPDATE:
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in COLLECT + UPDATE:
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        theirs = sorted(ranges[name])
        assert len(mine) == len(theirs)
        # on one clock the ends lie within 100 us (the median of each name's:
        # a loaded host may preempt the thread between a stamp and its range)
        starts = sorted(abs(c - a) for (a, _), (c, _) in zip(mine, theirs))
        ends = sorted(abs(b - d) for (_, b), (_, d) in zip(mine, theirs))
        assert starts[len(starts) // 2] < 100_000 and ends[len(ends) // 2] < 100_000, name


def test_record_spans_without_a_profiler(tmp_path, recorder, monkeypatch):
    def no_range(name):
        raise AssertionError(f"a profiler range was opened for {name}")
    monkeypatch.setattr(profiling, "record_function", no_range)
    with recorder.record_spans():
        iteration(tiny_runner(tmp_path))
    spans = recorder.recorded()
    check_tree(spans)
    assert all(s.device_ms is None for s in spans)
    recorder.clear()
    assert recorder.recorded() == []


def test_nested_spans_and_clear(recorder):
    with recorder.record_spans():
        with recorder.span("a"):
            with recorder.span("b"):
                pass
            with recorder.span("c"):
                with recorder.span("d"):
                    pass
        with recorder.span("e"):
            pass
    spans = recorder.recorded()
    assert names(spans) == ["a", "b", "c", "d", "e"]
    assert [s.parent for s in spans] == [None, 0, 0, 2, None]
    with pytest.raises(RuntimeError):
        with recorder.record_spans(), recorder.span("f"):
            raise RuntimeError("inside")
    assert recorder.recorded()[-1].end_ns is not None
    with recorder.record_spans(), recorder.span("g"):
        pass
    assert recorder.recorded()[-1].parent is None   # the failed span closed
    assert profiling.span("h") is profiling.span("i")   # off again


@pytest.mark.parametrize("on", ["record_spans", "profiler"])
def test_spans_change_nothing(tmp_path, recorder, on):
    torch.manual_seed(0)
    batch0, params0 = iteration(tiny_runner(tmp_path / "off"))
    ctx = (recorder.record_spans() if on == "record_spans"
           else profile(activities=[ProfilerActivity.CPU]))
    torch.manual_seed(0)
    with ctx:
        batch1, params1 = iteration(tiny_runner(tmp_path / "on"))
    assert len(recorder.recorded()) == 2 + 2 * T + 3 * 4
    for k in ("obs", "actions", "rewards", "masks", "bad_masks", "action_log_probs",
              "value_preds", "rnn_states_actor", "rnn_states_critic"):
        assert torch.equal(getattr(batch0, k), getattr(batch1, k)), k
    assert params0.keys() == params1.keys()
    for k in params0:
        assert torch.equal(params0[k], params1[k]), k


@pytest.mark.cuda
def test_on_the_card_spans_add_no_device_operation(tmp_path, recorder, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    from benchmark import trace
    from benchmark.trace import Trace
    run = tiny_runner(tmp_path, device="cuda")
    carry = run.init_carry(run.next_seed())
    carry, batch, _ = run.collect(carry)   # warm-up: builds and loads the kernels
    run.train(batch)
    torch.cuda.synchronize()

    def traced(carry):
        tr = Trace()
        with tr.record():
            with trace.span("collect"):
                carry, batch, _ = run.collect(carry)
            run.train(batch)
        return tr, carry

    recorder.clear()
    tr_on, carry = traced(carry)
    spans = recorder.recorded()
    check_tree(spans, replays=True)
    assert all(s.device_ms is not None and s.device_ms > 0 for s in spans if s.name in PHASES)
    assert all(s.device_ms is None for s in spans if s.name not in PHASES)
    recorder.clear()
    with monkeypatch.context() as m:
        m.setattr(profiling, "_profiler_enabled", lambda: False)   # spans off
        tr_off, carry = traced(carry)
    assert recorder.recorded() == []
    device_names = {n for _, _, n in tr_on.device_ops}
    assert not device_names & set(COLLECT + UPDATE + (REPLAY,))
    assert tr_on.launches("collect") > 0
    assert tr_on.launches("collect") == tr_off.launches("collect")
    assert tr_on.launches() == tr_off.launches()
