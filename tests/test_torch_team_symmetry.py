"""The 2v2 missile game's two sides in the port against the JAX package's
(CPU), `MultipleCombatShootEnv("multiple_selfplay_shoot_evadable")`.

- Reset draws. The packages draw from different generators by design, so a
  skew between the sides could hide in the reset without any carried-across
  step showing it. Each package draws 4096 team resets (the inherited
  masked reset and the team `_reset_extras`): 8192 agents per side. For
  each side, each drawn quantity (north, east, altitude, heading, speed) and
  each column of the first observation: the port's mean within 4 standard
  errors of the JAX package's, and the two-sample Kolmogorov-Smirnov
  distance under KS_BOUND (the 1e-4 level for two samples of 8192:
  2.225 sqrt(2 / 8192) = 0.0348); the ego side against the enemy side
  within the port by the same two rules. The weapon state and the blood of
  both sides equal the JAX package's exactly (full ammo, no cooldown, no
  missile, no lock).
- One step with the sides swapped. A JAX reset staged nose-on with a
  missile closing in each of two groups (`tests/test_torch_shoot.py`), then
  every per-agent row of each group's ego side exchanged with its enemy's
  (and each lock's victim index moved to the other side): two chained
  steps in both packages on the same actions, the port held to the JAX
  package's at the combat tolerances of `run_shoot_chain`. The JAX step
  need not be side-symmetric itself; the port must do what it does.
- `tools/combat_eval.py compare` pools a row's runs over its files
  (`<row>.json`, `<row>_seeds*.json`).
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralplane_tpu.envs import MultipleCombatShootEnv as JTeam
from neuralplane_tpu_torch.envs import MultipleCombatShootEnv

from test_torch_shoot import make_pair, nose_on, run_shoot_chain, stage_missiles, to_np

SCENARIO = "multiple_selfplay_shoot_evadable"
E = 4096
KS_BOUND = 0.035
DRAWN = {"north": 0, "east": 1, "altitude": 2, "heading": 5, "speed": 6}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's small tensors: the suite runs six
    workers on the host's cores, where a thread per core spin-waits (the
    tracking collect's port side in test_torch_trained_tracking.py: 180 s
    instead of 9.5 s beside six busy processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def resets():
    """(JAX state and obs, port state and obs, ego-side row mask), on
    "stacked" (the reset's observation needs one xdot)."""
    prev = os.environ.get("NEURALPLANE_AERO_BACKEND")
    os.environ["NEURALPLANE_AERO_BACKEND"] = "stacked"
    try:
        jenv = JTeam(E, SCENARIO)
        env = MultipleCombatShootEnv(E, SCENARIO, device="cpu")
        jstate, jobs = jenv.reset(jax.random.PRNGKey(0))
        state, obs = env.reset(0)
    finally:
        if prev is None:
            del os.environ["NEURALPLANE_AERO_BACKEND"]
        else:
            os.environ["NEURALPLANE_AERO_BACKEND"] = prev
    m = env.num_agents
    ego = (np.arange(E * m) % m) < m // 2
    return to_np(jstate), np.asarray(jobs), state, obs.numpy(), ego


def ks_distance(a, b) -> float:
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    return float(np.abs(np.searchsorted(a, grid, side="right") / len(a)
                        - np.searchsorted(b, grid, side="right") / len(b)).max())


def assert_same_distribution(got, want, what):
    se = np.sqrt(got.var() / len(got) + want.var() / len(want))
    gap = abs(got.mean() - want.mean())
    assert gap <= 4.0 * se + 1e-6, f"{what}: means {got.mean():.6g} / {want.mean():.6g}, " \
        f"4 se {4 * se:.3g}"
    d = ks_distance(got, want)
    assert d <= KS_BOUND, f"{what}: KS distance {d:.4f} > {KS_BOUND}"


@pytest.mark.parametrize("quantity", list(DRAWN) + ["obs"])
def test_reset_draws_agree_per_side(resets, quantity):
    jstate, jobs, state, obs, ego = resets
    if quantity == "obs":
        cols = [(f"obs[{c}]", obs[:, c], jobs[:, c]) for c in range(obs.shape[1])]
    else:
        c = DRAWN[quantity]
        cols = [(quantity, state.model.s[:, c].numpy(), np.asarray(jstate.model.s)[:, c])]
    for name, got, want in cols:
        for side, rows in (("ego", ego), ("enemy", ~ego)):
            assert_same_distribution(got[rows], want[rows], f"{name}, {side} side, port vs JAX")
        assert_same_distribution(got[ego], got[~ego], f"{name}, port, ego vs enemy side")


def test_reset_weapon_state_equals_jax_on_both_sides(resets):
    jstate, _, state, _, _ = resets
    for name, got, want in (("ammo", state.ammo, jstate.ammo),
                            ("cooldown", state.cooldown, jstate.cooldown),
                            ("blood", state.blood, jstate.blood),
                            ("missiles active", state.missiles.active, jstate.missiles.active),
                            ("missile_target", state.missile_target, jstate.missile_target),
                            ("step_count", state.step_count, jstate.step_count)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    assert (state.ammo.numpy() > 0).all() and not state.missiles.active.numpy().any()


def swap_sides(env, jstate):
    """Each group's ego rows exchanged with its enemy rows in every
    per-agent leaf; each lock's in-group victim index moved to the other
    side (k -> (k + h) mod m)."""
    n, m, h = env.n, env.num_agents, env.num_agents // 2
    perm = (np.arange(n) // m) * m + (np.arange(n) % m + h) % m

    def swap(x):
        x = np.asarray(x)
        return jnp.asarray(x[perm]) if x.ndim and x.shape[0] == n else x
    key = jstate.key
    out = jax.tree.map(swap, jstate.replace(key=None))
    tgt = (np.asarray(out.missile_target) + h) % m
    return out.replace(key=key, missile_target=jnp.asarray(tgt))


def test_swapped_sides_step_matches_jax(monkeypatch):
    monkeypatch.setenv("NEURALPLANE_AERO_BACKEND", "stacked")
    jenv, env = make_pair(SCENARIO, 3)
    jstate, _ = jenv.reset(jax.random.PRNGKey(4))
    jstate = stage_missiles(env, nose_on(env, jstate, groups=(0, 1)))
    swapped = swap_sides(env, jstate)
    m, h = env.num_agents, env.num_agents // 2
    # the staged missiles now fly for the enemy side, locked on the ego side
    assert np.asarray(swapped.missiles.active)[h, -1]
    assert int(np.asarray(swapped.missile_target)[h, -1]) == 0
    outs = run_shoot_chain(jenv, env, swapped, steps=2, seed=3)
    pk = outs[0][1].info["shoot/pk_dealt_vec"].numpy()
    assert pk[h] == pytest.approx(1.0) and 0.05 < pk[m + h] < 0.95


def test_combat_eval_compare_pools_seed_files(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "combat_eval", os.path.join(REPO, "tools", "combat_eval.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for fname, seeds in (("A5m.json", [0, 1]), ("A5m_seeds4-5.json", [4, 5]),
                         ("A5m_seeds6-6.json", [6])):
        rec = {"row": "A5m", "card": "x", "runs": [{"seed": s, "last_line": {"ego_wins": s}}
                                                   for s in seeds]}
        (tmp_path / fname).write_text(json.dumps(rec))
    rec = tool.read_row(str(tmp_path), "A5m")
    assert [r["seed"] for r in rec["runs"]] == [0, 1, 4, 5, 6]
    assert rec["path"].endswith("A5m.json")
    assert tool.read_row(str(tmp_path), "A5") is None
