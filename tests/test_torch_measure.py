"""The port's throughput harness (neuralplane_tpu_torch/measure.py and
scripts/bench.py) against the JAX package's (neuralplane_tpu/measure.py,
tests/test_measure.py) on the CPU, at tiny sizes.

- The rows: every key of the JAX row, JSON scalars only once a sweep has
  dropped the env, its state and its output; `resident_state_mb` > 0 and
  linear in n; the rounding of n to whole env groups, `num_envs` and
  `inner_fdm_steps` equal to the JAX row's for each of the four combat envs.
- The sweeps: generators whose (n, steps, env) calls are the JAX package's,
  the combat sweep's first row SingleCombat at n = 10, a size the card
  cannot hold listed with its error and the sweep going on.
- The held-high shoot action of the missile rows, one step of
  MultipleCombatShoot from a JAX state: the same shoot/* counts, obs,
  state and reward as the JAX step.
- The bench CLI on --device cpu: exit 0, sweep rows on stderr, and a last
  stdout line with exactly bench.py's keys plus `device`.
"""
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from neuralplane_tpu import measure as jmeasure
from neuralplane_tpu.envs import MultipleCombatShootEnv as JTeamShoot
from neuralplane_tpu_torch import measure
from test_torch_shoot import angle_cols, assert_cols_close, make_pair, nose_on, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMBAT_ENVS = ["SingleCombat", "SingleCombatShoot", "MultipleCombat", "MultipleCombatShoot"]
JSON_TYPES = (str, int, float, bool, type(None))


def test_env_step_row_schema():
    """The port's row carries every key of the JAX row (and the env, its
    state and output for the caller); resident_state_mb grows by the same
    bytes per aircraft between 4, 8 and 16 aircraft."""
    jrow = jmeasure.measure_env_step(4, steps=3)
    rows = {n: measure.measure_env_step(n, steps=3, device="cpu") for n in (4, 8, 16)}
    row = rows[4]
    assert set(jrow) <= set(row) and {"env", "state", "out", "wall_s", "finite"} <= set(row)
    assert row["n"] == 4 and row["steps"] == 3 and row["device"] == "cpu"
    assert row["s_per_step"] > 0 and row["agent_steps_per_s"] > 0 and row["finite"]
    assert np.isnan(row["device_mem_mb"]) and row["peak_mem_mb"] is None
    mb = {n: r["resident_state_mb"] for n, r in rows.items()}
    assert mb[4] > 0
    assert (mb[16] - mb[8]) == pytest.approx(2 * (mb[8] - mb[4]), rel=1e-12)
    per_agent = (mb[8] - mb[4]) * 2 ** 20 / 4
    assert 150 <= per_agent <= 200, per_agent   # state, controls, task, flags, obs [22]


@pytest.mark.parametrize("env_name", COMBAT_ENVS)
def test_combat_step_rounds_to_groups_as_jax(env_name):
    jrow = jmeasure.measure_combat_step(10, steps=2, env_name=env_name)
    row = measure.measure_combat_step(10, steps=2, env_name=env_name, device="cpu")
    agents = row["env_obj"].num_agents
    assert set(jrow) <= set(row)
    assert row["env"] == env_name and row["n"] == (10 // agents) * agents
    for k in ("n", "num_envs", "steps", "inner_fdm_steps"):
        assert row[k] == jrow[k], k
    assert row["inner_fdm_steps"] in (1, 5) and row["s_per_step"] > 0 and row["finite"]
    assert row["resident_state_mb"] > 0


def test_combat_sweep_streams_json_rows():
    gen = measure.measure_combat_sweep(max_exp=1, steps=1, device="cpu")
    assert isinstance(gen, types.GeneratorType)
    first = next(gen)
    assert first["env"] == "SingleCombat" and first["n"] == 10
    rows = [first, *gen]
    assert [r["env"] for r in rows] == COMBAT_ENVS
    for r in rows:
        assert all(isinstance(v, JSON_TYPES) for v in r.values()), r
        json.dumps(r)


def test_sweeps_call_as_jax(monkeypatch):
    """With the measurement stubbed on both sides, the sweeps request the
    same (n, steps, env) in the same order as the JAX package's."""
    calls = {"jax": [], "port": []}

    def stub(side):
        def measured(n, steps=500, env_name=None, **kw):
            calls[side].append((n, steps, env_name))
            return {"n": n}
        return measured
    for side, mod in (("jax", jmeasure), ("port", measure)):
        monkeypatch.setattr(mod, "measure_combat_step", stub(side))
        monkeypatch.setattr(mod, "measure_env_step", stub(side))
    list(jmeasure.measure_combat_sweep(max_exp=2, steps=3))
    list(measure.measure_combat_sweep(max_exp=2, steps=3, device="cpu"))
    jmeasure.measure_sweep(max_exp=2, steps=3)
    list(measure.measure_sweep(max_exp=2, steps=3, device="cpu"))
    assert calls["port"] == calls["jax"] and len(calls["jax"]) == 8 + 3


def test_sweep_lists_a_size_the_card_cannot_hold(monkeypatch):
    """An out-of-memory row becomes a row with the error and the peak MiB,
    and the sweep goes on to the next size."""
    def measured(n, steps, device, env_name=None):
        if n == 10:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
        return {"n": n, "steps": steps, "env": object()}   # dropped: not JSON
    monkeypatch.setattr(measure, "measure_env_step", measured)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda dev: 3 * 2 ** 20)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    rows = list(measure.measure_sweep(max_exp=2, steps=1, device="cpu"))
    assert rows == [{"n": 1, "steps": 1},
                    {"n": 10, "steps": 1, "peak_mem_mb": 3.0,
                     "error": "CUDA out of memory. Tried to allocate 2 GiB"},
                    {"n": 100, "steps": 1}]


def test_held_high_shoot_step_matches_jax(monkeypatch):
    """measure_combat_step's missile action ([20, 20, 20, 20, 1] on every
    row) through one MultipleCombatShoot step from a JAX state with both
    sides nose-on inside the WEZ: the shoot/* counts equal the JAX step's,
    state, obs and reward at tests/test_torch_shoot.py's tolerances."""
    monkeypatch.setenv("NEURALPLANE_AERO_BACKEND", "stacked")
    jenv, env = make_pair("multiple_selfplay_shoot", 2)
    assert isinstance(jenv, JTeamShoot)
    jstate, _ = jenv.reset(jax.random.PRNGKey(1))
    jstate = nose_on(env, jstate)
    act = np.tile(np.float32([[20.0, 20.0, 20.0, 20.0, 1.0]]), (env.n, 1))
    env.reset(0)
    state = env.state_from_jax(to_np(jstate))
    jstate, jout = jenv.step(jstate, act)
    state, out = env.step(state, torch.from_numpy(act))
    counts = {k: int(v) for k, v in out.info.items() if k.startswith("shoot/")
              and not k.endswith("_vec") and k != "shoot/pk_sum"}
    want = {k: int(v) for k, v in jout.info.items() if k.startswith("shoot/")
            and not k.endswith("_vec") and k != "shoot/pk_sum"}
    assert counts == want and counts["shoot/launches"] > 0, (counts, want)
    assert float(out.info["shoot/pk_sum"]) == pytest.approx(float(jout.info["shoot/pk_sum"]),
                                                             abs=1e-5)
    ang = np.zeros(env.num_observation, bool)
    ang[angle_cols(env)] = True
    obs, jobs = out.obs.numpy(), np.asarray(jout.obs)
    assert_cols_close(obs[:, ~ang], jobs[:, ~ang], "obs")
    np.testing.assert_allclose(obs[:, ang], jobs[:, ang], rtol=0, atol=1e-3)
    assert_cols_close(state.model.s.numpy(), np.asarray(jstate.model.s), "s")
    assert_cols_close(out.reward.numpy(), np.asarray(jout.reward), "reward")
    np.testing.assert_array_equal(state.ammo.numpy(), np.asarray(jstate.ammo))


# `python -m neuralplane_tpu_torch.scripts.bench` with the heading sweep cut
# to 10^0..10^2: at 10^6 aircraft it is a full-size run (about 4 GB and 30 s
# on the CPU), which belongs on the card (chip_smoke.py phase 34)
CLI = r"""
import functools, runpy, sys
import neuralplane_tpu_torch.measure as m
m.measure_sweep = functools.partial(m.measure_sweep, max_exp=2)
sys.argv = ["bench"] + sys.argv[1:]
runpy.run_module("neuralplane_tpu_torch.scripts.bench", run_name="__main__")
"""


def test_bench_cli_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-c", CLI, "--device", "cpu", "--n", "8", "--steps",
                        "2", "--sweep", "--combat-sweep", "--combat-max-exp", "1"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline", "aero_backend", "device"}
    assert last["metric"] == "f16_heading_env_step_1M_agents" and last["unit"] == "s/step"
    assert last["device"] == "cpu" and last["aero_backend"] == "auto" and last["value"] > 0
    assert last["vs_baseline"] == round(0.2103 / last["value"], 2)
    rows = [json.loads(line) for line in r.stderr.splitlines() if line.startswith("{")]
    assert [row["n"] for row in rows[:3]] == [1, 10, 100]
    assert [(row["env"], row["steps"]) for row in rows[3:]] == [(e, 2) for e in COMBAT_ENVS]
