"""Distilled surrogate of the PyTorch port (neuralplane_tpu_torch.ops.aero,
aero_cuda, surrogates.distill) against the JAX package on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
(the Pallas kernel in interpret mode, as tests/test_distilled.py runs it)
and through the port's plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from neuralplane_tpu.ops.aero_pallas import (OUT, DistilledAeroWeightsT,
                                             load_distilled_t,
                                             nlplant_pallas_distilled)
from neuralplane_tpu.surrogates import distill as jdistill
from neuralplane_tpu_torch.ops import aero as taero
from neuralplane_tpu_torch.ops import aero_cuda


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def random_weights(seed, hidden=64):
    """Synthetic distilled weights (tests/test_distilled.py:_random_weights,
    drawn with numpy): W bf16, the rest float32."""
    rng = np.random.default_rng(seed)
    F = jdistill.N_FEAT
    r = lambda sh, s: (rng.standard_normal(sh) * s).astype(np.float32)
    bf = jnp.bfloat16
    return DistilledAeroWeightsT(
        W1=jnp.asarray(r((hidden, F), 0.5), bf), b1=jnp.asarray(r((hidden,), 0.1)),
        W2=jnp.asarray(r((hidden, hidden), 0.15), bf),
        b2=jnp.asarray(r((hidden,), 0.1)),
        W3=jnp.asarray(r((OUT, hidden + F), 0.1), bf),
        b3=jnp.asarray(r((OUT,), 0.05)),
        out_mean=jnp.zeros(OUT).at[:5].set(0.02),
        out_std=jnp.ones(OUT) * jnp.linspace(0.02, 2.0, OUT))


def port_weights(jw):
    return taero.distilled_from_numpy([np.asarray(x) for x in jw], device="cpu")


def random_states(seed, n):
    """States and controls as tests/test_distilled.py:_random_states draws
    them, from numpy."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(-1.0, 1.0, (n, 12)).astype(np.float32)
    s[:, 2] = rng.uniform(5000.0, 25000.0, n)
    s[:, 6] = rng.uniform(400.0, 1200.0, n)
    u = rng.uniform(-15.0, 15.0, (n, 5)).astype(np.float32)
    u[:, 0] = 4000.0
    return s, u


def test_feature_rows_match_featurize_bit_exact():
    """Features are computed in float32 by division and cast to bf16: the
    port must give the JAX featurize's bf16 values exactly."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.array([[-15.0, -20.0, -10.0], [35.0, 0.0, 0.0], [80.0, 25.0, 20.0],
                  [-20.0, -30.0, -25.0], [90.0, 30.0, 25.0]], np.float32),
        rng.uniform([-45, -45, -40], [120, 45, 40], (200, 3)).astype(np.float32)])
    want = np.asarray(jdistill.featurize(jnp.asarray(x)).astype(jnp.bfloat16),
                      np.float32)
    t = torch.from_numpy(x)
    got = aero_cuda.distilled_feature_rows(t[:, 0], t[:, 1], t[:, 2])
    np.testing.assert_array_equal(got.T.float().numpy(), want)


def test_distilled_from_numpy_round_trip():
    jw = random_weights(1)
    w = port_weights(jw)
    assert w.W1.dtype == torch.bfloat16 and w.b1.dtype == torch.float32
    for got, want in zip(w.to_numpy(), jw):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    again = taero.distilled_from_numpy(w.to_numpy(), device="cpu")
    for a, b in zip(again.leaves(), w.leaves()):
        assert torch.equal(a, b)


def test_load_distilled_matches_jax_loader():
    w = taero.load_distilled(device="cpu")
    for got, want in zip(w.to_numpy(), load_distilled_t()):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_packed_layout_pads_with_zeros():
    w = taero.load_distilled(device="cpu")
    w1p, _, _, _, w3p, _, _, _ = w.packed()
    H, F = w.W1.shape
    assert w1p.shape == (H, taero.F_PAD) and w3p.shape == (taero.OUT, H + taero.F_PAD)
    assert torch.equal(w1p[:, :F], w.W1) and not w1p[:, F:].any()
    assert torch.equal(w3p[:, :H + F], w.W3) and not w3p[:, H + F:].any()
    with pytest.raises(ValueError, match="built for H = 256"):
        port_weights(random_weights(2)).packed()


@pytest.mark.parametrize("hidden_bf16", [True, False])
def test_nlplant_plain_matches_pallas(interpret_pallas, hidden_bf16):
    """rtol = atol = 2e-5, the JAX suite's own kernel-vs-XLA tolerance
    (tests/test_distilled.py:88): both sides round the same values to bf16
    at the same points and differ only in float32 summation order."""
    jw = random_weights(3)
    s, u = random_states(4, 70)
    want = np.asarray(nlplant_pallas_distilled(jw, jnp.asarray(s), jnp.asarray(u),
                                               tile=32, hidden_bf16=hidden_bf16))
    got = aero_cuda.nlplant_distilled(port_weights(jw), torch.from_numpy(s),
                                      torch.from_numpy(u), hidden_bf16=hidden_bf16)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_nlplant_plain_matches_pallas_shipped_weights(interpret_pallas):
    """The shipped H = 256 net at n = 64. Same arithmetic; with 4x the
    hidden width a float32 sum in another order can land on the other side
    of a bf16 rounding of one hidden unit, which moves that aircraft's xdot
    by far less than the surrogate's own resolution: 99% of the entries
    hold rtol = atol = 2e-5 and all hold 2e-2 relative to each column's
    RMS."""
    s, u = random_states(5, 64)
    want = np.asarray(nlplant_pallas_distilled(load_distilled_t(), jnp.asarray(s),
                                               jnp.asarray(u)))
    got = aero_cuda.nlplant_distilled(taero.load_distilled(device="cpu"),
                                      torch.from_numpy(s), torch.from_numpy(u)).numpy()
    close = np.isclose(got, want, rtol=2e-5, atol=2e-5)
    assert close.mean() >= 0.99, close.mean()
    rms = np.sqrt((want ** 2).mean(0))
    assert (np.abs(got - want) <= 2e-2 * rms).all()


def test_quantized_coeffs_match_jax():
    """surrogates.distill.quantized_coeffs against its JAX twin at the
    kernel tolerance (2e-5)."""
    jw = random_weights(6)
    K = len(taero.AERO_NAMES)
    p = jdistill.DistilledParams(
        W1=jw.W1.astype(jnp.float32), b1=jw.b1, W2=jw.W2.astype(jnp.float32),
        b2=jw.b2, W3=jw.W3[:K].astype(jnp.float32), b3=jw.b3[:K])
    rng = np.random.default_rng(7)
    x = rng.uniform([-20, -30, -25], [90, 30, 25], (50, 3)).astype(np.float32)
    want = np.asarray(jdistill.quantized_coeffs(
        p, np.asarray(jw.out_mean[:K]), np.asarray(jw.out_std[:K]),
        jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]), jnp.asarray(x[:, 2])))
    from neuralplane_tpu_torch.surrogates import distill as tdistill
    tp = tdistill.DistilledParams(*(torch.from_numpy(np.array(a, np.float32))
                                    for a in p))
    t = torch.from_numpy(x)
    got = tdistill.quantized_coeffs(tp, np.asarray(jw.out_mean[:K]),
                                    np.asarray(jw.out_std[:K]), t[:, 0], t[:, 1],
                                    t[:, 2])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_nlplant_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version (needs the card; chip_smoke.py
    runs the same check at n = 10^6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    w = taero.load_distilled(device="cuda")
    s, u = (torch.from_numpy(a).cuda() for a in random_states(8, 4099))
    got = aero_cuda.nlplant_distilled(w, s, u)
    want = aero_cuda.nlplant_distilled_plain(w, s, u)
    rms = want.pow(2).mean(0).sqrt()
    err = (got - want).abs() / rms
    assert err.median() < 1e-5 and (err > 1e-3).float().mean() < 1e-2
    assert err.max() < 0.1
