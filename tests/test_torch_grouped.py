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
    rule and recover the bf16 weights, zero padding elsewhere; the readout's
    fragment holds bf16 W4 in every column; the bias words are the biases
    rounded to bf16, bit for bit, by t."""
    frags, vec = gw.packed()
    assert gw.packed()[0] is frags                       # made once
    assert frags.shape == (taero.K, taero.NET_WORDS) and frags.dtype == torch.int32
    assert vec.shape == (taero.K, taero.VEC_FLOATS) and vec.dtype == torch.float32
    assert taero.NET_WORDS == 20 * 32 + 4 * 8 and taero.VEC_FLOATS == 68
    pairs = frags[:, :taero.FRAG_WORDS * 32].reshape(taero.K, 10, 32, 2)
    words = pairs.permute(0, 1, 3, 2).reshape(taero.K, 20, 32)   # [K, word, lane]
    halves = words.contiguous().view(torch.bfloat16).reshape(taero.K, 20, 32, 2).float()
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
    B4 = unpack(18, 16, 1, True)                         # [K, 16, 8]
    for col in range(8):
        np.testing.assert_array_equal(B4[:, :10, col], bf(gw.W4))
    assert not B4[:, 10:].any()
    # bias words [K, t, 8]: b1 j = 0-2, b2 j = 0-2, b3 j = 0-1 at columns
    # 8 j + 2 t, + 1; the float32 copies in vec in the same order
    bias_words = frags[:, taero.FRAG_WORDS * 32:].reshape(taero.K, 4, 8)
    bias_f32 = vec[:, :taero.VEC_BIAS].reshape(taero.K, 4, 8, 2)
    slot = 0
    for b, tiles in ((gw.b1, 3), (gw.b2, 3), (gw.b3, 2)):
        padded = torch.zeros(taero.K, 8 * tiles)
        padded[:, :b.shape[1]] = b
        for j in range(tiles):
            for tt in range(4):
                want = padded[:, 8 * j + 2 * tt:8 * j + 2 * tt + 2]
                got = bias_words[:, tt, slot].contiguous().view(torch.bfloat16)
                assert torch.equal(got.view(torch.int16).reshape(taero.K, 2),
                                   want.to(torch.bfloat16).view(torch.int16))
                assert torch.equal(bias_f32[:, tt, slot], want)
            slot += 1
    assert slot == taero.BIAS_PAIRS
    np.testing.assert_array_equal(vec[:, taero.VEC_BIAS].numpy(), gw.b4.numpy())
    assert not vec[:, taero.VEC_BIAS + 1:].any()
    # padding columns (20-23 of b1 and b2, 10-15 of b3) are zero words
    assert not bias_words[:, 2:, 2].any() and not bias_words[:, 2:, 5].any()
    assert not bias_words[:, 1:, 7].any()


# --- the sweep's lane rules, in numpy ---

def _bf(x):
    """float32 values rounded to bf16 (round to nearest even), as float32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3


def _mma(a_regs, b_regs, c):
    """mma.sync.m16n8k8 (2 A registers, 1 B register) or m16n8k16 (4 and 2)
    on one warp, by the PTX fragment layouts, summed in float64. A register
    is [32 lanes, 2 bf16 values]; c and the result are [32, 4]: lane 4g + t
    holds columns 2t, 2t + 1 of rows g (elements 0, 1) and g + 8 (2, 3)."""
    k = 4 * len(a_regs)
    A, B, C = np.zeros((16, k)), np.zeros((k, 8)), np.zeros((16, 8))
    for ln, (g, t) in enumerate(zip(_G, _T)):
        for r, reg in enumerate(a_regs):     # a0: row g, a1: row g + 8, a2, a3: columns + 8
            A[g + 8 * (r % 2), 2 * t + 8 * (r // 2):2 * t + 8 * (r // 2) + 2] = reg[ln]
        for r, reg in enumerate(b_regs):     # b0: rows 2t, 2t + 1 of column g, b1: rows + 8
            B[2 * t + 8 * r:2 * t + 8 * r + 2, g] = reg[ln]
        C[g, 2 * t:2 * t + 2], C[g + 8, 2 * t:2 * t + 2] = c[ln, :2], c[ln, 2:]
    D = A @ B + C
    return np.stack([D[_G, 2 * _T], D[_G, 2 * _T + 1], D[_G + 8, 2 * _T], D[_G + 8, 2 * _T + 1]],
                    axis=1)


def sweep_by_lane_rules(gw, alpha, beta, el, hidden_bf16):
    """One warp tile (up to 32 aircraft) through csrc/grouped.cuh:sweep as
    the lanes run it, from the packed buffers alone: [K, nv]."""
    frags, vec = (x.numpy() for x in gw.packed())
    nv = len(alpha)
    own = 16 * (_T >> 1) + 8 * (_T & 1) + _G             # own_row() per lane
    pad = lambda x: np.concatenate([x, np.zeros(32 - nv, np.float32)])[own]
    a, b, e = _bf(pad(alpha)), _bf(pad(beta)), _bf(pad(el))
    p_ab, p_e = np.stack([a, b], 1), np.stack([e, 0 * e], 1)
    xa = [[None, None], [None, None]]
    for m in range(2):
        for half in range(2):
            owner = (_LANE & ~3) | (2 * m + half)
            xa[m][half] = np.where((_T == 0)[:, None], p_ab[owner],
                                   np.where((_T == 1)[:, None], p_e[owner], 0.0))
    out = np.zeros((taero.K, 32), np.float32)
    zero = np.zeros((32, 4))
    for k in range(taero.K):
        pairs = frags[k, :640].reshape(10, 32, 2)
        word = lambda i: torch.from_numpy(pairs[i // 2, :, i % 2].copy()).view(
            torch.bfloat16).reshape(32, 2).float().numpy()
        bias_bf = torch.from_numpy(frags[k, 640:].copy()).view(torch.bfloat16).reshape(
            4, 8, 2).float().numpy()[_T]                  # [lane, slot, 2]
        bias_f32 = vec[k, :64].reshape(4, 8, 2)[_T]

        def hidden(acc, slot):
            x = acc.astype(np.float32)                    # the tensor core's float32 sum
            bias = bias_bf if hidden_bf16 else bias_f32
            bb = np.concatenate([bias[:, slot], bias[:, slot]], axis=1)
            if hidden_bf16:
                x = np.maximum(_bf(_bf(x) + bb), 0.0)
            else:
                x = _bf(np.maximum(x + bb, 0.0))
            return x[:, :2], x[:, 2:]                     # rows g and g + 8

        h = [[None] * 6 for _ in range(2)]
        for m in range(2):
            for j in range(3):
                acc = _mma(xa[m], [word(j)], zero)
                h[m][2 * j], h[m][2 * j + 1] = hidden(acc, j)
        for layer, tiles, k16_word, k8_word, slot0 in ((2, 3, 8, 3, 3), (3, 2, 14, 6, 6)):
            nxt = [[None] * 6 for _ in range(2)]
            for m in range(2):
                for j in range(tiles):
                    acc = _mma(h[m][:4], [word(k16_word + 2 * j), word(k16_word + 2 * j + 1)],
                               zero)
                    acc = _mma(h[m][4:6], [word(k8_word + j)], acc)
                    nxt[m][2 * j], nxt[m][2 * j + 1] = hidden(acc, slot0 + j)
            h = nxt
        y = [_mma(h[m][:4], [word(18), word(19)], zero) for m in range(2)]
        mine = np.where(_T < 2, y[0][_LANE, 2 * (_T & 1)], y[1][_LANE, 2 * (_T & 1)])
        out[k, own] = mine.astype(np.float32) + vec[k, 64]
    return out[:, :nv]


@pytest.mark.parametrize("hidden_bf16", [True, False])
@pytest.mark.parametrize("nv", [32, 19])
def test_sweep_lane_rules_match_the_plain_sweep(gw, hidden_bf16, nv):
    """The kernel cannot run without a card; its data movement can. One net
    after the other goes from the packed buffers through the A, B and C
    fragment layouts of m16n8k8 / m16n8k16, the layer-to-layer hand-over,
    the readout product and the owner's select, for a whole tile and a
    ragged one. Sums are taken in float64 here and in float32 by torch, so
    entries agree to 2e-5 of the coefficient's scale except where a sum
    lands on the other side of a bf16 rounding: at most 4 of the 43 x nv
    entries may, by at most 2e-2 (the same limits as against the TPU
    kernel)."""
    a, b, e = query_points(21 + nv, nv)
    got = sweep_by_lane_rules(gw, a, b, e, hidden_bf16)
    want = tgrp.grouped_coeff_rows(gw, T(a), T(b), T(e), hidden_bf16).numpy()
    assert got.shape == want.shape == (taero.K, nv)
    ref = tgrp.grouped_coeff_rows(gw, *(T(x) for x in query_points(0, 700)), hidden_bf16)
    scale = ref.abs().mean(1, keepdim=True).numpy() + 1e-6
    err = np.abs(got - want) / scale
    assert (err > 2e-5).sum() <= 4, f"{(err > 2e-5).sum()} entries above 2e-5"
    assert err.max() <= 2e-2, err.max()


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
    """csrc/grouped.cuh reads the layout ops/aero.py packs, through entry
    points that take the two buffers as pointers."""
    csrc = os.path.join(os.path.dirname(step_cuda.__file__), "..", "csrc")
    src = open(os.path.join(csrc, "grouped.cuh")).read()
    const = lambda nm: int(re.search(r"\b%s = (\d+)" % nm, src).group(1))
    assert const("N_NETS") == taero.K
    assert const("FRAG_PAIRS") * 2 == taero.FRAG_WORDS
    assert const("BIAS_PAIRS") == taero.BIAS_PAIRS
    assert const("NET_WORDS") == taero.NET_WORDS
    assert const("VEC") == taero.VEC_FLOATS
    assert const("OFF_B4") == taero.VEC_BIAS
    assert const("TILE") == 32 and const("GRP_WARPS") == 16
    # every entry point still takes (frags, vec) as two pointers
    for source, fn in (("aero_grouped.cu", "np_aero_coeffs"), ("aero_grouped.cu", "np_aero_totals"),
                       ("aero_grouped.cu", "np_nlplant_grouped"),
                       ("env_step.cu", "np_env_step_grouped")):
        text = open(os.path.join(csrc, source)).read()
        sig = re.search(r"int %s\((.*?)\)\s*\{" % fn, text, re.S).group(1)
        assert "const uint2* frags" in sig and "const float* vec" in sig, fn


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
