"""Whole-step plain version of the PyTorch port (ops/step_cuda.env_step_plain)
against the TPU kernel (ops/step_pallas.env_step_pallas, interpret mode) on
the CPU, with distilled weights, draws explicit and sensor noise off; plus
the target resample, the Generator draws and the Philox host twin.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from neuralplane_tpu.ops import step_pallas as jsp
from neuralplane_tpu.utils.config import load_config as j_load_config
from neuralplane_tpu_torch.ops import philox, step_cuda
from neuralplane_tpu_torch.utils.config import load_config

from test_torch_aero import port_weights, random_weights
from test_torch_cuda import envelope_states


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def pad_rows(a, rows):
    return np.concatenate([a, np.zeros((rows - a.shape[0], a.shape[1]), a.dtype)])


@pytest.mark.parametrize("variant", ["heading", "control", "tracking"])
def test_env_step_plain_matches_pallas(interpret_pallas, variant):
    """Four chained steps at n = 70 (ragged 32-wide TPU tiles) with ~20% of
    rows flagged for reset. Each step feeds the TPU kernel's outputs to both
    sides. Tolerances of tests/test_distilled.py:122-131 and
    tests/test_step_pallas.py: obs 2e-5, state 1e-5, reward 1e-4, flags and
    counts exact."""
    n = 70
    rng = np.random.default_rng(11)
    jw = random_weights(12)
    w = port_weights(jw)
    jcfg, cfg = j_load_config(variant), load_config(variant)
    s, u = envelope_states(rng, n)
    sf, uf = s.T.copy(), u.T.copy()
    tg = [rng.uniform(-1.0, 1.0, n).astype(np.float32) + s[:, k] for k in (2, 5, 6)]
    sc = rng.integers(0, 2600, n).astype(np.int32)
    mask = rng.uniform(size=n) < 0.2
    for step in range(4):
        act = rng.uniform(-1.2, 1.2, (n, 4)).astype(np.float32)
        alt0 = rng.uniform(cfg.min_altitude, cfg.max_altitude, n).astype(np.float32)
        vt0 = rng.uniform(cfg.min_vt, cfg.max_vt, n).astype(np.float32)
        fresh = [rng.uniform(lo, hi, n).astype(np.float32)
                 for lo, hi in ((1.9e4, 2.1e4), (-3.0, 3.0), (900.0, 1300.0))]
        tg = [np.where(mask, f, t) for f, t in zip(fresh, tg)]
        sc = np.where(mask, 0, sc) + 1
        want = jsp.env_step_pallas(
            variant, jcfg, jw, jnp.asarray(pad_rows(sf, 16)),
            jnp.asarray(pad_rows(uf, 8)), jnp.asarray(act), jnp.asarray(mask),
            jnp.asarray(alt0), jnp.asarray(vt0), tuple(jnp.asarray(t) for t in tg),
            jnp.asarray(sc), tile=32)
        want = [np.asarray(x) for x in want]
        T = torch.from_numpy
        got = step_cuda.env_step(
            variant, cfg, w, T(sf), T(uf), T(act), T(mask), T(alt0), T(vt0),
            tuple(T(t) for t in tg), T(sc))
        got = [x.numpy() for x in got]
        msg = f"{variant} step {step}"
        np.testing.assert_allclose(got[0], want[0][:12], rtol=1e-5, atol=1e-5, err_msg=msg)
        np.testing.assert_allclose(got[1], want[1][:5], rtol=1e-5, atol=1e-5, err_msg=msg)
        np.testing.assert_allclose(got[2], want[2], rtol=2e-5, atol=2e-5, err_msg=msg)
        np.testing.assert_array_equal(got[3], want[3], err_msg=msg)
        np.testing.assert_array_equal(got[4], want[4], err_msg=msg)
        np.testing.assert_allclose(got[5], want[5], rtol=1e-4, atol=1e-4, err_msg=msg)
        np.testing.assert_array_equal(got[6], want[6].astype(np.int32), err_msg=msg)
        sf, uf = want[0][:12].copy(), want[1][:5].copy()
        mask = want[3] | want[4] | (rng.uniform(size=n) < 0.1)


def test_resample_targets_matches_jax():
    n = 256
    du = np.random.default_rng(3).uniform(size=(8, n)).astype(np.float32)
    for variant in ("heading", "control", "tracking"):
        for random_inc in (False, True):
            cfg = load_config(variant, heading_random_increments=random_inc)
            jcfg = j_load_config(variant, heading_random_increments=random_inc)
            rc, jrc = step_cuda.reset_consts(cfg, variant), jsp.reset_consts(jcfg, variant)
            assert rc == jrc
            alt0 = rc["min_alt"] + du[0] * (rc["max_alt"] - rc["min_alt"])
            vt0 = rc["min_vt"] + du[1] * (rc["max_vt"] - rc["min_vt"])
            got = step_cuda._resample_targets(variant, rc, torch.from_numpy(du),
                                              torch.from_numpy(alt0),
                                              torch.from_numpy(vt0))
            want = jsp._resample_targets(variant, jrc, jnp.asarray(du),
                                         jnp.asarray(alt0), jnp.asarray(vt0))
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                           atol=1e-4)


@pytest.mark.parametrize("variant", ["heading", "control", "tracking"])
def test_generator_draws_land_in_bands(variant):
    """With draws on (CPU path: torch.Generator), flagged rows restart inside
    the init band with targets inside the task's band; the others keep their
    targets exactly."""
    n = 400
    rng = np.random.default_rng(5)
    cfg = load_config(variant)
    w = port_weights(random_weights(13))
    s, u = envelope_states(rng, n)
    mask = torch.from_numpy(rng.uniform(size=n) < 0.5)
    tg = tuple(torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
               for _ in range(3))
    gen = torch.Generator().manual_seed(0)
    out = step_cuda.env_step(variant, cfg, w, torch.from_numpy(s.T.copy()),
                             torch.from_numpy(u.T.copy()), torch.zeros(n, 4), mask,
                             None, None, tg, torch.ones(n, dtype=torch.int32),
                             noise_scale=0.01, reset_draws=True, generator=gen)
    t = [x.numpy() for x in out[7:10]]
    m = mask.numpy()
    for k in range(3):
        np.testing.assert_array_equal(t[k][~m], tg[k].numpy()[~m])
    alt = out[0][2].numpy()[m]
    assert ((alt > cfg.min_altitude - 50) & (alt < cfg.max_altitude + 50)).all()
    assert np.allclose(out[1][0].numpy()[m],
                       0.9 * cfg.init_state.init_T + 0.1 * 0.0 * step_cuda.THRUST_SCALE)
    tm = [x[m] for x in t]
    if variant == "heading":
        assert ((tm[0] >= cfg.min_altitude + 1000) & (tm[0] <= cfg.max_altitude + 1000)).all()
        np.testing.assert_allclose(tm[1], 2 * np.pi / 3, rtol=1e-6)
        assert ((tm[2] >= cfg.min_vt) & (tm[2] <= cfg.max_vt)).all()
    elif variant == "control":
        assert (np.abs(tm[0]) <= np.pi).all() and (np.abs(tm[1]) <= np.pi).all()
        lo = cfg.min_vt - cfg.max_velocities_u_increment
        hi = cfg.max_vt + cfg.max_velocities_u_increment
        assert ((tm[2] >= lo) & (tm[2] <= hi)).all()
    else:
        horiz = np.hypot(tm[0], tm[1])
        assert (horiz <= cfg.max_distance + 1e-2).all()
        assert ((tm[2] >= cfg.min_altitude - cfg.max_distance)
                & (tm[2] <= cfg.max_altitude + cfg.max_distance)).all()
    # noise is on: the observation differs from a noiseless step by ~0.01
    quiet = step_cuda.env_step(variant, cfg, w, torch.from_numpy(s.T.copy()),
                               torch.from_numpy(u.T.copy()), torch.zeros(n, 4),
                               mask, None, None, tg, torch.ones(n, dtype=torch.int32),
                               reset_draws=True, generator=torch.Generator().manual_seed(0))
    d = (out[2] - quiet[2]).numpy()
    assert 0.005 < d.std() < 0.02


def test_philox_known_answers():
    """The host twin of csrc/philox.cuh against the Random123 known-answer
    vectors of Philox4x32-10."""
    cases = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0xA4093822, 0x299F31D0), (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = philox.philox4x32_10([np.array([c], np.uint32) for c in ctr], key)
        assert tuple(int(g[0]) for g in got) == want
    u = philox.uniforms((1, 2), 1000, range(2))
    assert u.shape == (8, 1000) and u.dtype == np.float32
    assert (u >= 0).all() and (u < 1).all() and abs(u.mean() - 0.5) < 0.02


def test_step_params_match_the_c_struct():
    """ctypes passes StepParams by value: its fields must be the C struct's,
    in order and type."""
    import os
    src = open(os.path.join(os.path.dirname(step_cuda.__file__), "..", "csrc",
                            "env_step.cu")).read()
    body = re.search(r"struct StepParams \{(.*?)\};", src, re.S).group(1)
    c_fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            ctype, names = decl.split(None, 1)
            c_fields += [(nm.strip(), ctype) for nm in names.split(",")]
    py = [(nm, "int" if t.__name__ == "c_int" else "float")
          for nm, t in step_cuda.StepParams._fields_]
    assert c_fields == py
