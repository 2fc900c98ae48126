"""The 43-net aero backend of the PyTorch port (ops/aero.py containers,
ops/aero_grouped_cuda.py, ops/task_cuda.py, the grouped mode of
ops/step_cuda.py) against the JAX package on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
(a Pallas kernel in interpret mode, as tests/test_aero_pallas.py runs it)
and through the port's plain version. The tests that hold each CUDA kernel
to its plain version on the card are in tests/test_torch_cuda.py.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from neuralplane_tpu.envs import ControlEnv as JaxControlEnv
from neuralplane_tpu.ops import aero as jaero
from neuralplane_tpu.ops import aero_pallas as jap
from neuralplane_tpu.ops import step_pallas as jsp
from neuralplane_tpu.ops import task_pallas as jtp
from neuralplane_tpu.ops.buildup import B_SPAN, CBAR, coeff_buildup
from neuralplane_tpu.ops.dynamics import nlplant_f16 as j_nlplant_f16
from neuralplane_tpu.utils.config import load_config as j_load_config
from neuralplane_tpu_torch.ops import aero as taero
from neuralplane_tpu_torch.ops import aero_grouped_cuda as tgrp
from neuralplane_tpu_torch.ops import step_cuda, task_cuda
from neuralplane_tpu_torch.ops.dynamics import nlplant_f16
from neuralplane_tpu_torch.utils.config import load_config

from test_torch_cuda import envelope, envelope_states, query_points, totals_feats
from test_torch_step import pad_rows

T = torch.from_numpy


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


@pytest.fixture(scope="module")
def jw():
    return jaero.load_aero_weights()


@pytest.fixture(scope="module")
def w(jw):
    """The shipped 43 nets carried across as numpy, stacked container."""
    return taero.aero_from_numpy([np.asarray(x) for x in jw], device="cpu")


@pytest.fixture(scope="module")
def gw(w):
    return taero.pack_grouped(w)


def assert_same_arithmetic(got, want, scale, tol=2e-5, flip_share=1e-3, flip_tol=2e-2):
    """Both sides round the same values to bf16 at the same points and may
    sum in float32 in another order: entries agree to `tol` of `scale`
    (the JAX suite's kernel tolerance), except that a sum landing on the
    other side of a bf16 rounding flips one hidden unit of one net; such
    entries are counted (at most `flip_share`) and bounded (`flip_tol`)."""
    err = np.abs(got - want) / scale
    flips = err > tol
    assert flips.mean() <= flip_share, f"{flips.sum()} entries above {tol}"
    assert err.max() <= flip_tol, err.max()


# --- (a) containers ---

def test_aero_from_numpy_round_trip(jw, w):
    assert all(t.dtype == torch.float32 for t in w.leaves())
    assert w.W1.shape == (taero.K, 3, 20) and w.b4.shape == (taero.K,)
    for got, want in zip(w.to_numpy(), jw):
        np.testing.assert_array_equal(got, np.asarray(want))
    again = taero.aero_from_numpy(w.to_numpy(), device="cpu")
    for a, b in zip(again.leaves(), w.leaves()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="expected 8 leaves"):
        taero.aero_from_numpy(w.to_numpy()[:7], device="cpu")
    with pytest.raises(ValueError, match="W2 must be"):
        bad = list(w.to_numpy())
        bad[2] = bad[2][:, :10]
        taero.aero_from_numpy(bad, device="cpu")


def test_load_aero_weights_matches_jax_loader(jw):
    w = taero.load_aero_weights(device="cpu")
    assert type(w) is taero.AeroWeights
    for got, want in zip(w.to_numpy(), jw):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_packed_fragments_hold_every_weight_once(gw):
    """The kernels' layout: unpack the B fragments by the mma.sync lane
    rule and recover the bf16 weights, zero padding elsewhere."""
    frags, vec = gw.packed()
    assert gw.packed()[0] is frags                       # made once
    assert frags.shape == (taero.K, 9, 32, 2) and frags.dtype == torch.int32
    assert vec.shape == (taero.K, taero.VEC_FLOATS)
    words = frags.permute(0, 1, 3, 2).reshape(taero.K, 18, 32)   # [K, word, lane]
    halves = words.contiguous().view(torch.bfloat16).reshape(taero.K, 18, 32, 2).float()
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3

    def unpack(first_word, k_rows, n_tiles, k16):
        B = np.zeros((taero.K, k_rows, 8 * n_tiles), np.float32)
        word = first_word
        for j in range(n_tiles):
            for h in range(2 if k16 else 1):
                for e in range(2):
                    B[:, 2 * t + 8 * h + e, 8 * j + g] = halves[:, word, :, e].numpy()
                word += 1
        return B

    bf = lambda a: a.to(torch.bfloat16).float().numpy()
    B1 = unpack(0, 8, 3, False)
    np.testing.assert_array_equal(B1[:, :3, :20], bf(gw.W1))
    assert not B1[:, 3:].any() and not B1[:, :, 20:].any()
    B2 = np.concatenate([unpack(8, 16, 3, True), unpack(3, 8, 3, False)], axis=1)
    np.testing.assert_array_equal(B2[:, :20, :20], bf(gw.W2))
    assert not B2[:, 20:].any() and not B2[:, :, 20:].any()
    B3 = np.concatenate([unpack(14, 16, 2, True), unpack(6, 8, 2, False)], axis=1)
    np.testing.assert_array_equal(B3[:, :20, :10], bf(gw.W3))
    assert not B3[:, 20:].any() and not B3[:, :, 10:].any()
    v = vec.numpy()
    np.testing.assert_array_equal(v[:, 0:20], gw.b1.numpy())
    np.testing.assert_array_equal(v[:, 24:44], gw.b2.numpy())
    np.testing.assert_array_equal(v[:, 48:58], gw.b3.numpy())
    np.testing.assert_array_equal(v[:, 64:74], bf(gw.W4))
    np.testing.assert_array_equal(v[:, 80], gw.b4.numpy())
    used = np.r_[0:20, 24:44, 48:58, 64:74, 80]
    assert not np.delete(v, used, axis=1).any()


@pytest.mark.parametrize("backend,cls", [
    ("stacked", taero.AeroWeights), ("pallas", taero.GroupedAeroWeights),
    ("distilled", taero.DistilledAeroWeights), ("auto", taero.DistilledAeroWeights)])
def test_select_aero_weights_by_name(monkeypatch, backend, cls):
    monkeypatch.delenv("NEURALPLANE_AERO_BACKEND", raising=False)
    assert type(taero.select_aero_weights(backend, device="cpu")) is cls


def test_select_aero_weights_honours_the_environment(monkeypatch):
    """NEURALPLANE_AERO_BACKEND overrides the argument, as
    neuralplane_tpu/ops/aero.py:82 does; a wrong name raises either way."""
    monkeypatch.setenv("NEURALPLANE_AERO_BACKEND", "stacked")
    assert type(taero.select_aero_weights("distilled", device="cpu")) is taero.AeroWeights
    monkeypatch.setenv("NEURALPLANE_AERO_BACKEND", "pallas")
    assert type(taero.select_aero_weights("auto", device="cpu")) is taero.GroupedAeroWeights
    monkeypatch.setenv("NEURALPLANE_AERO_BACKEND", "mosaic")
    with pytest.raises(ValueError, match="aero_backend must be one of"):
        taero.select_aero_weights("auto", device="cpu")
    monkeypatch.delenv("NEURALPLANE_AERO_BACKEND")
    with pytest.raises(ValueError, match="aero_backend must be one of"):
        taero.select_aero_weights("xla", device="cpu")


# --- (b) the stacked query ---

def test_stacked_query_matches_jax(jw, w):
    """float32 on both sides, the same contraction order up to the BLAS:
    rtol = atol = 1e-5."""
    a, b, e = query_points(0, 700)
    want = np.asarray(jaero.aero_coeffs(jw, jnp.asarray(a), jnp.asarray(b), jnp.asarray(e)))
    got = taero.aero_coeffs(w, T(a), T(b), T(e))
    assert got.shape == (700, taero.K)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    got_t = taero.aero_coeffs_t(w, T(a), T(b), T(e))
    np.testing.assert_array_equal(got_t.numpy(), got.numpy().T)


def test_distilled_query_dispatch_matches_jax():
    """aero_coeffs_t on the distilled container is the quantized trunk
    (ops/aero.py:149-157); tolerance 2e-5 of each coefficient's spread,
    with the shipped net's rare bf16 flips counted."""
    a, b, e = query_points(3, 300)
    want = np.asarray(jaero.aero_coeffs_t(jap.load_distilled_t(), jnp.asarray(a),
                                          jnp.asarray(b), jnp.asarray(e)))
    tw = taero.load_distilled(device="cpu")
    got = taero.aero_coeffs_t(tw, T(a), T(b), T(e)).numpy()
    assert got.shape == (taero.K, 300)
    scale = np.abs(want).mean(1, keepdims=True) + 1e-6
    assert_same_arithmetic(got, want, scale, flip_share=1e-2, flip_tol=5e-2)
    np.testing.assert_array_equal(taero.aero_coeffs(tw, T(a), T(b), T(e)).numpy(), got.T)


# --- (c) the plain sweep ---

@pytest.mark.parametrize("kernel", ["ft", "t"])
def test_plain_sweep_matches_pallas(interpret_pallas, jw, gw, kernel):
    """n = 700 is no multiple of the 256-row tile. Against the TPU kernel:
    2e-5 of each coefficient's scale; against the float32 stacked query:
    the JAX suite's own limit (mean scaled error < 2e-2,
    tests/test_aero_pallas.py:38-41)."""
    a, b, e = query_points(0, 700)
    ja, jb, je = jnp.asarray(a), jnp.asarray(b), jnp.asarray(e)
    if kernel == "ft":
        want = np.asarray(jap.aero_coeffs_pallas_ft(jap.pack_grouped_t(jw), ja, jb, je,
                                                    tile=256))
    else:
        want = np.asarray(jap.aero_coeffs_pallas_t(jap.pack_grouped(jw), ja, jb, je,
                                                   tile=256))
    got = taero.aero_coeffs_t(gw, T(a), T(b), T(e)).numpy()
    assert got.shape == want.shape == (taero.K, 700)
    ref = np.asarray(jaero.aero_coeffs(jw, ja, jb, je)).T
    scale = np.abs(ref).mean(1, keepdims=True) + 1e-6
    assert_same_arithmetic(got, want, scale)
    assert (np.abs(got - ref) / scale).mean() < 2e-2
    rows = taero.aero_coeffs(gw, T(a), T(b), T(e))
    assert rows.is_contiguous()
    np.testing.assert_array_equal(rows.numpy(), got.T)


def test_plain_sweep_rounds_the_inputs_to_bf16(gw):
    """The sweep sees (alpha, beta, el) only through their bf16 values."""
    a, b, e = (T(x) for x in query_points(5, 64))
    r = lambda x: x.to(torch.bfloat16).float()
    assert not torch.equal(r(a), a)
    for hb in (False, True):
        assert torch.equal(tgrp.grouped_coeff_rows(gw, a, b, e, hb),
                           tgrp.grouped_coeff_rows(gw, r(a), r(b), r(e), hb))
    assert not torch.equal(tgrp.grouped_coeff_rows(gw, a, b, e, False),
                           tgrp.grouped_coeff_rows(gw, a, b, e, True))


def test_plain_sweep_chunks_agree(gw, monkeypatch):
    a, b, e = (T(x) for x in query_points(6, 300))
    whole = tgrp.grouped_coeff_rows(gw, a, b, e, True)
    monkeypatch.setattr(tgrp, "PLAIN_CHUNK", 128)
    assert torch.equal(tgrp.grouped_coeff_rows(gw, a, b, e, True), whole)


# --- (d) totals ---

def test_plain_totals_match_pallas(interpret_pallas, jw, gw):
    n = 300
    feats = totals_feats(1, n)
    want = np.asarray(jap.aero_totals_pallas_ft(jap.pack_grouped_t(jw), jnp.asarray(feats),
                                                tile=128))
    got = tgrp.aero_totals(gw, T(feats)).numpy()
    assert got.shape == want.shape == (6, n)
    scale = np.abs(want).mean(1, keepdims=True) + 1e-4
    assert_same_arithmetic(got, want, scale)
    # and the JAX suite's own check against the float32 query + build-up
    c = np.asarray(jaero.aero_coeffs(jw, *(jnp.asarray(feats[i]) for i in range(3)))).T
    f = feats.astype(np.float64)
    ref = np.stack(coeff_buildup(
        lambda nm: c[jaero.IDX[nm]], dlef=f[3], dail=f[4], drud=f[5], P=f[6], Q=f[7],
        R=f[8], beta_deg=f[1], half_cbar_v=CBAR * f[9], half_b_v=B_SPAN * f[9]))
    assert (np.abs(got - ref) / (np.abs(ref).mean(1, keepdims=True) + 1e-4)).mean() < 2e-2


# --- (e) xdot ---

@pytest.mark.parametrize("hidden_bf16", [True, False])
def test_plain_xdot_matches_pallas(interpret_pallas, jw, w, gw, hidden_bf16):
    """n = 500 over the envelope, tile 128. Against the TPU kernel: 2e-5 of
    each column's RMS (flips counted); against the stacked float32 nlplant:
    the JAX suite's limits (tests/test_aero_pallas.py:115-120)."""
    s, u = envelope(2, 500)
    want = np.asarray(jap.nlplant_pallas_ft(jap.pack_grouped_t(jw), jnp.asarray(s),
                                            jnp.asarray(u), tile=128,
                                            hidden_bf16=hidden_bf16))
    got = nlplant_f16(gw, T(s), T(u)) if hidden_bf16 else \
        tgrp.nlplant_grouped(gw, T(s), T(u), hidden_bf16=False)
    got = got.numpy()
    rms = np.sqrt((want ** 2).mean(0))
    assert_same_arithmetic(got, want, rms)
    ref = nlplant_f16(w, T(s), T(u)).numpy()           # the stacked dispatch
    np.testing.assert_allclose(
        ref, np.asarray(j_nlplant_f16(jw, jnp.asarray(s), jnp.asarray(u))),
        rtol=1e-5, atol=1e-4)
    assert np.allclose(got[:, :6], ref[:, :6], rtol=1e-5, atol=1e-4)
    scale = np.abs(ref[:, 6:]).mean(0) + 1e-3
    assert (np.abs(got[:, 6:] - ref[:, 6:]) / scale).mean() < 2e-2


# --- (f) the task layer on its own ---

@pytest.mark.parametrize("variant", ["heading", "control", "tracking"])
def test_plain_task_step_matches_pallas(interpret_pallas, variant):
    """n = 70 with 32-wide TPU tiles; tolerances of
    tests/test_task_pallas.py:63-71: obs 2e-5, reward 1e-4, flags and
    counts exact."""
    n = 70
    rng = np.random.default_rng(31)
    s, u = envelope_states(rng, n)
    xdot = rng.normal(0.0, 1.0, (n, 12)).astype(np.float32)
    xdot[:, 6] *= 40.0                    # some rows over the acceleration limit
    if variant == "tracking":
        tg = [s[:, k] + rng.uniform(-150, 150, n).astype(np.float32) for k in (0, 1, 2)]
    elif variant == "heading":
        tg = [s[:, 2] + rng.uniform(-150, 150, n).astype(np.float32),
              s[:, 5] + rng.uniform(-0.15, 0.15, n).astype(np.float32),
              s[:, 6] + rng.uniform(-30, 30, n).astype(np.float32)]
    else:
        tg = [s[:, 4] + rng.uniform(-0.15, 0.15, n).astype(np.float32),
              s[:, 5] + rng.uniform(-0.15, 0.15, n).astype(np.float32),
              s[:, 6] + rng.uniform(-30, 30, n).astype(np.float32)]
    sc = rng.integers(0, 2600, n).astype(np.int32)
    want = jtp.task_step_pallas(variant, j_load_config(variant), jnp.asarray(s),
                                jnp.asarray(u), jnp.asarray(xdot),
                                tuple(jnp.asarray(t) for t in tg), jnp.asarray(sc), tile=32)
    want = [np.asarray(x) for x in want]
    got = task_cuda.task_step(variant, load_config(variant), T(s), T(u), T(xdot),
                              tuple(T(t) for t in tg), T(sc), device="cpu")
    assert got[4].dtype == torch.int32 and got[0].shape == (n, 22)
    got = [x.numpy() for x in got]
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[4], want[4].astype(np.int32))
    assert want[4].sum() > 0 and want[2].any() and not want[2].all()


def test_task_step_refuses_the_wrong_device():
    z = torch.zeros(4, 12)
    args = ("heading", load_config("heading"), z, torch.zeros(4, 5), z,
            (torch.zeros(4),) * 3, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="state is on cpu"):
        task_cuda.task_step(*args)               # the default is the card
    with pytest.raises(ValueError, match="variant must be"):
        task_cuda.task_step("loiter", *args[1:], device="cpu")


def c_struct_fields(source, name):
    src = open(os.path.join(os.path.dirname(step_cuda.__file__), "..", "csrc",
                            source)).read()
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            ctype, names = decl.split(None, 1)
            fields += [(nm.strip(), ctype) for nm in names.split(",")]
    return fields


def test_task_params_match_the_c_struct():
    """ctypes passes TaskParams by value: its fields must be the C struct's,
    in order and type."""
    py = [(nm, "int" if t.__name__ == "c_int" else "float")
          for nm, t in task_cuda.TaskParams._fields_]
    assert c_struct_fields("task_step.cu", "TaskParams") == py


def test_kernel_constants_match_the_packing():
    """csrc/grouped.cuh reads the layout ops/aero.py packs."""
    src = open(os.path.join(os.path.dirname(step_cuda.__file__), "..", "csrc",
                            "grouped.cuh")).read()
    const = lambda nm: int(re.search(r"\b%s = (\d+)" % nm, src).group(1))
    assert const("N_NETS") == taero.K
    assert const("FRAG_PAIRS") * 2 == taero.FRAG_WORDS
    assert const("VEC") == taero.VEC_FLOATS
    assert (const("OFF_B2"), const("OFF_B3"), const("OFF_W4"), const("OFF_B4")) == \
        (taero.NP1, taero.NP1 + taero.NP2, taero.NP1 + taero.NP2 + taero.NP3,
         taero.NP1 + taero.NP2 + 2 * taero.NP3)


# --- (g) the whole step in grouped mode ---

@pytest.mark.parametrize("variant", ["heading", "control", "tracking"])
def test_env_step_plain_grouped_matches_pallas(interpret_pallas, jw, gw, variant):
    """Four chained steps at n = 70 (ragged 32-wide TPU tiles) with ~20% of
    rows flagged for reset, `pack_grouped_t` weights on the JAX side; each
    step feeds the TPU kernel's outputs to both sides. Tolerances of
    tests/test_step_pallas.py: obs 2e-5, state 1e-5, reward 1e-4, flags and
    counts exact."""
    n = 70
    rng = np.random.default_rng(17)
    jgw = jap.pack_grouped_t(jw)
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
            variant, jcfg, jgw, jnp.asarray(pad_rows(sf, 16)),
            jnp.asarray(pad_rows(uf, 8)), jnp.asarray(act), jnp.asarray(mask),
            jnp.asarray(alt0), jnp.asarray(vt0), tuple(jnp.asarray(t) for t in tg),
            jnp.asarray(sc), tile=32)
        want = [np.asarray(x) for x in want]
        got = step_cuda.env_step(
            variant, cfg, gw, T(sf), T(uf), T(act), T(mask), T(alt0), T(vt0),
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


def test_env_step_refuses_the_stacked_container(w):
    z = torch.zeros
    with pytest.raises(TypeError, match="DistilledAeroWeights or GroupedAeroWeights"):
        step_cuda.env_step("heading", load_config("heading"), w, z(12, 4), z(5, 4),
                           z(4, 4), z(4, dtype=torch.bool), z(4), z(4), (z(4),) * 3,
                           z(4, dtype=torch.int32))
