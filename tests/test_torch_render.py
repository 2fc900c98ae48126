"""Rendering of the PyTorch port (neuralplane_tpu_torch.utils.geodesy,
render.acmi, render.trajectory, scripts.render) against the JAX package on
the CPU.

The geodesy is numpy in float64 on both sides and agrees exactly; the same
states give a byte-identical ACMI file; the recorder and the metrics agree
exactly on the same buffers. One frame's channels (the batch means the
render records, the pose it writes) after one step from a JAX state carried
across agree at the env tolerances of tests/test_torch_env.py. The CLI runs
in all four modes on the CPU for a few frames.
"""
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralplane_tpu.envs import ControlEnv as JaxControlEnv
from neuralplane_tpu.envs import PlanningEnv as JaxPlanningEnv
from neuralplane_tpu.render import acmi as jacmi
from neuralplane_tpu.render import trajectory as jtraj
from neuralplane_tpu.utils import geodesy as jgeo
from neuralplane_tpu.utils.checkpoint import load_pytree
from neuralplane_tpu.utils.config import load_config as j_load_config
from neuralplane_tpu_torch.envs import ControlEnv, PlanningEnv
from neuralplane_tpu_torch.envs.planning import load_low_level_ckpt
from neuralplane_tpu_torch.render import acmi as tacmi
from neuralplane_tpu_torch.render import trajectory as ttraj
from neuralplane_tpu_torch.scripts import render as trender
from neuralplane_tpu_torch.utils import geodesy as tgeo
from neuralplane_tpu_torch.utils.config import load_config

from test_torch_env import assert_state_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "results")
N = 8
# the metrics JSON of neuralplane_tpu/scripts/render.py:render_control
CONTROL_KEYS = {"mean_G", "mean_TAS", "mean_RoC", "mean_AOA", "ASM", "SSM", "OSM", "AOASM",
                "AOSSM", "episode_reward", "reached_target", "failed", "success_rate"}


# ---------------------------------------------------------------- geodesy

def test_geodesy_constants():
    for k in ("A", "B", "F", "E_SQ"):
        assert getattr(tgeo, k) == getattr(jgeo, k)


@pytest.mark.parametrize("ref", [(0.0, 0.0, 0.0), (35.6, 139.7, 40.0), (-60.0, -120.0, 1500.0)])
def test_geodesy_matches_jax_exactly(ref):
    rng = np.random.default_rng(int(abs(ref[0])))
    e, n, u = rng.uniform(-2e5, 2e5, 500), rng.uniform(-2e5, 2e5, 500), rng.uniform(0, 2e4, 500)
    lat, lon, h = rng.uniform(-89, 89, 500), rng.uniform(-180, 180, 500), rng.uniform(0, 2e4, 500)
    for fn, args in (("geodetic_to_ecef", (lat, lon, h)),
                     ("ecef_to_geodetic", jgeo.geodetic_to_ecef(lat, lon, h)),
                     ("enu_to_ecef", (e, n, u, *ref)),
                     ("ecef_to_enu", (*jgeo.geodetic_to_ecef(lat, lon, h), *ref)),
                     ("geodetic_to_enu", (lat, lon, h, *ref)),
                     ("enu_to_geodetic", (e, n, u, *ref))):
        for got, want in zip(getattr(tgeo, fn)(*args), getattr(jgeo, fn)(*args)):
            np.testing.assert_array_equal(got, want, err_msg=fn)
    # the round trip closes
    back = tgeo.geodetic_to_enu(*tgeo.enu_to_geodetic(e, n, u, *ref), *ref)
    np.testing.assert_allclose(np.stack(back), np.stack([e, n, u]), atol=1e-3)


# ---------------------------------------------------------------- ACMI

def write_recording(mod, path, rng):
    w = mod.ACMIWriter(path)
    for t in range(3):
        states = np.concatenate([rng.uniform(-3e4, 3e4, (4, 3)) + [0, 0, 2e4],
                                 rng.uniform(-3, 3, (4, 3))], axis=1).astype(np.float32)
        w.write_frame(t * 0.2, states, colors=["Red", "Red", "Blue", "Blue"])
        mis = np.concatenate([rng.uniform(-3e4, 3e4, 3), [0.0], rng.uniform(-1, 1, 2)])
        w.write_object(1000 + t, mis, name="AAM", color="Blue")
        if t:
            w.remove_object(1000 + t - 1)
    w.write_frame(0.6, np.zeros((1, 6)))


def test_acmi_byte_identical(tmp_path):
    paths = [str(tmp_path / f"{m}.txt.acmi") for m in ("port", "jax")]
    write_recording(tacmi, paths[0], np.random.default_rng(0))
    write_recording(jacmi, paths[1], np.random.default_rng(0))
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        got, want = a.read(), b.read()
    assert got == want and b"Type=Missile" in got and b"\n-1000\n" in got


def test_acmi_reference_checks(tmp_path):
    """tests/test_surrogates.py:106-140 on the port's writer."""
    path = str(tmp_path / "rec.txt.acmi")
    w = tacmi.ACMIWriter(path)
    states = np.array([[1000.0, 2000.0, 20000.0, 0.1, 0.05, 1.0]])
    w.write_frame(0.0, states)
    w.write_object(1000, np.array([500.0, 600.0, 19000.0, 0.0, 0.2, 0.9]), name="AAM",
                   color="Red")
    w.write_frame(0.1, states)
    w.remove_object(1000)
    lines = open(path).read().splitlines()
    assert lines[0] == "FileType=text/acmi/tacview"
    assert "#0.00" in lines and "#0.10" in lines
    assert any(l.startswith("100,T=") for l in lines)
    mis = [l for l in lines if l.startswith("1000,T=")]
    assert len(mis) == 1 and "Type=Missile" in mis[0] and "Name=AAM" in mis[0]
    assert lines.index(mis[0]) < lines.index("#0.10") < lines.index("-1000")


# ---------------------------------------------------------------- trajectory

def test_recorder_and_metrics_exact(tmp_path):
    rng = np.random.default_rng(1)
    rec_t, rec_j = ttraj.TrajectoryRecorder(), jtraj.TrajectoryRecorder()
    assert rec_t.CHANNELS == rec_j.CHANNELS
    for _ in range(7):
        ch = {k: rng.uniform(-1, 1, 5).astype(np.float32) for k in rec_t.CHANNELS}
        ch.update(altitude=rng.uniform(1e4, 3e4, 5), vt=rng.uniform(500, 1200, 5))
        rec_t.record(**ch)
        rec_j.record(**ch)
    a, b = rec_t.arrays(), rec_j.arrays()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert ttraj.evaluate_metrics(a) == jtraj.evaluate_metrics(b)
    rec_t.save(str(tmp_path / "result"))
    np.testing.assert_array_equal(np.load(tmp_path / "result" / "vt.npy"), b["vt"])
    pytest.importorskip("matplotlib")
    ttraj.plot_result(a, str(tmp_path / "fig.png"))
    assert os.path.getsize(tmp_path / "fig.png") > 0


def jax_channels(model, mstate):
    """The channels of neuralplane_tpu/scripts/render.py:89-106 (batch means)."""
    xdot = model.extended_state(mstate)
    rec = jtraj.TrajectoryRecorder()
    rec.record_model(model, mstate, xdot)
    return {k: v[0] for k, v in rec.arrays().items()}


def check_frame(env, state, jmodel, jstate_model):
    xdot = env.model.extended_state(state.model)
    got = {k: float(v) for k, v in ttraj.model_channels(env.model, state.model, xdot).items()}
    want = jax_channels(jmodel, jstate_model)
    assert got.keys() == want.keys() == set(ttraj.TrajectoryRecorder.CHANNELS)
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-5 * (abs(want[k]) + 1.0), (k, got[k], want[k])
    assert_state_close(state.model.s[:, :6].numpy(), np.asarray(jstate_model.s)[:, :6], True,
                       "pose")
    # the recorder's one-copy path records the same values
    rec = ttraj.TrajectoryRecorder()
    rec.record_model(env.model, state.model, xdot)
    assert {k: v[0] for k, v in rec.arrays().items()} == pytest.approx(got, rel=1e-7)


def test_control_frame_from_a_jax_state():
    over = dict(noise_scale=0.0)
    jenv = JaxControlEnv(num_envs=N, config=j_load_config("heading", **over), task="heading",
                         aero_backend="stacked")
    env = ControlEnv(num_envs=N, config=load_config("heading", **over), task="heading",
                     aero_backend="stacked", device="cpu")
    jstate, _ = jenv.reset(jax.random.PRNGKey(2))
    env.reset(0)
    state = env.state_from_jax(jax.tree.map(np.asarray, jstate))
    a = np.random.default_rng(2).uniform(-1, 1, (N, 4)).astype(np.float32)
    jstate, _ = jenv.step(jstate, jnp.asarray(a))
    state, _ = env.step(state, torch.from_numpy(a))
    check_frame(env, state, jenv.model, jstate.model)


def test_planning_frame_from_a_jax_state(monkeypatch):
    monkeypatch.setenv("NEURALPLANE_AERO_BACKEND", "stacked")
    ckpt = os.path.join(RESULTS, "control", "policy_checkpoint.pkl")
    jlow = jax.tree.map(jnp.asarray, load_pytree(ckpt)["train_state"].params["actor"])
    jenv = JaxPlanningEnv(num_envs=N, config=j_load_config("tracking", low_level_steps=2),
                          low_level_params=jlow)
    env = PlanningEnv(num_envs=N, config=load_config("tracking", low_level_steps=2),
                      low_level_params=load_low_level_ckpt(ckpt), device="cpu")
    jstate, _ = jenv.reset(jax.random.PRNGKey(3))
    env.reset(0)
    state = env.state_from_jax(jax.tree.map(np.asarray, jstate))
    a = np.random.default_rng(3).uniform(-1, 1, (N, 3)).astype(np.float32)
    jstate, _ = jenv.step(jstate, jnp.asarray(a))
    state, _ = env.step(state, torch.from_numpy(a))
    check_frame(env, state.env, jenv.model, jstate.env.model)


# ---------------------------------------------------------------- CLI

def acmi_frames(path):
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[:3] == ["FileType=text/acmi/tacview", "FileVersion=2.0",
                         "0,ReferenceTime=2023-04-01T00:00:00Z"]
    nums = [float(x) for l in lines if ",T=" in l for x in l.split(",")[1][2:].split("|")]
    assert nums and all(math.isfinite(x) for x in nums)
    return sum(l.startswith("#") for l in lines), lines


CONTROL_MODES = {
    "ppo": ["--checkpoint", os.path.join(RESULTS, "heading", "policy_checkpoint.pkl")],
    "pid": [],
    "planning": ["--checkpoint", os.path.join(RESULTS, "tracking", "policy_checkpoint.pkl"),
                 "--low-level-ckpt", os.path.join(RESULTS, "control", "policy_checkpoint.pkl")],
}


@pytest.mark.parametrize("mode", sorted(CONTROL_MODES))
def test_cli_control_modes(tmp_path, capsys, mode):
    out = str(tmp_path / mode)
    steps = 3
    metrics = trender.main(["--mode", mode, *CONTROL_MODES[mode], "--steps", str(steps),
                            "--device", "cpu", "--out", out])
    assert set(metrics) == CONTROL_KEYS
    assert json.loads(capsys.readouterr().out) == pytest.approx(metrics)
    assert all(math.isfinite(v) for v in metrics.values())
    frames, _ = acmi_frames(os.path.join(out, "recording.txt.acmi"))
    assert frames == steps
    files = set(os.listdir(os.path.join(out, "result")))
    targets = {"planning": {"target_npos", "target_epos", "target_altitude"}}.get(
        mode, {"target_altitude", "target_heading", "target_vt"})
    assert files == {f"{k}.npy" for k in ttraj.TrajectoryRecorder.CHANNELS} | \
        {f"{k}.npy" for k in targets}
    for fn in files:
        buf = np.load(os.path.join(out, "result", fn))
        assert buf.shape == (steps,) and np.isfinite(buf).all()


def test_cli_combat_missiles(tmp_path):
    """The 1v1 missile policy, sampled, with its launch prior: the frame
    count, the missile objects and the metrics of the JAX render."""
    out = str(tmp_path / "combat")
    ckpt = os.path.join(RESULTS, "shoot_1v1", "policy_checkpoint.pkl")
    rec = trender.main(["--mode", "combat", "--scenario", "selfplay_shoot", "--checkpoint",
                        ckpt, "--stochastic", "--steps", "6", "--seed", "0",
                        "--device", "cpu", "--out", out])
    assert set(rec) == {"steps", "blood", "launches", "hits", "ammo"}
    frames, lines = acmi_frames(os.path.join(out, "recording.txt.acmi"))
    assert frames == rec["steps"] and len(rec["blood"]) == 2
    mis = [l for l in lines if ",Type=Missile" in l]
    assert rec["launches"] >= 1 and mis and all(",Name=AAM," in l for l in mis)
    assert sum(rec["ammo"]) == 2 * 4 - rec["launches"]   # max_missiles 4 each


def test_cli_guns_combat_with_pool(tmp_path):
    """--model-dir resolves pool entries of either package's names."""
    pool = tmp_path / "pool"
    pool.mkdir()
    actor = load_low_level_ckpt(os.path.join(RESULTS, "selfplay", "policy_checkpoint.pkl"))
    torch.save(actor, pool / "actor_0.pt")
    os.symlink(os.path.join(RESULTS, "selfplay", "policy_checkpoint.pkl"),
               pool / "state_latest.pkl")
    assert trender._resolve_pool_ckpt(str(pool), "0").endswith("actor_0.pt")
    assert trender._resolve_pool_ckpt(str(pool), "latest").endswith("state_latest.pkl")
    with pytest.raises(FileNotFoundError):
        trender._resolve_pool_ckpt(str(pool), "7")
    out = str(tmp_path / "guns")
    rec = trender.main(["--mode", "combat", "--model-dir", str(pool), "--render-index", "0",
                        "--steps", "3", "--device", "cpu", "--out", out])
    assert set(rec) == {"steps", "blood"} and rec["steps"] == 3


def test_cli_without_matplotlib(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = str(tmp_path / "nofig")
    trender.main(["--mode", "ppo", "--steps", "2", "--device", "cpu", "--out", out])
    assert "figure skipped" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(out, "result.png"))
    assert os.path.exists(os.path.join(out, "result", "G.npy"))
