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


def image_matrix(image, offset, N, K):
    """Read W [N, K] back out of the kernels' weight image by the layout
    rule of csrc/wgmma.cuh, one element at a time: (n, k) sits at byte
    16 N (k // 8) + 128 (n // 8) + 16 (n % 8) + 2 (k % 8) of the matrix.
    Also returns how often each of the matrix's 2-byte cells was read."""
    n, k = np.meshgrid(np.arange(N), np.arange(K), indexing="ij")
    addr = 16 * N * (k // 8) + 128 * (n // 8) + 16 * (n % 8) + 2 * (k % 8)
    assert (addr % 2 == 0).all()
    cells = image[offset:offset + 2 * N * K].clone().view(torch.bfloat16)
    hits = np.bincount((addr // 2).ravel(), minlength=N * K)
    return cells[torch.from_numpy(addr // 2)], hits


def test_packed_layout_pads_with_zeros():
    w = taero.load_distilled(device="cpu")
    image = w.packed()
    assert w.packed() is image                            # made once
    assert image.dtype == torch.uint8 and image.shape == (taero.IMG_BYTES,)
    H, F = w.W1.shape
    FP, ON = taero.F_PAD, taero.OUT_N
    W1, hits = image_matrix(image, taero.IMG_W1, H, FP)
    assert (hits == 1).all()
    assert torch.equal(W1[:, :F], w.W1) and not W1[:, F:].any()
    W2, hits = image_matrix(image, taero.IMG_W2, H, H)
    assert (hits == 1).all() and torch.equal(W2, w.W2)
    W3, hits = image_matrix(image, taero.IMG_W3, ON, H + FP)
    assert (hits == 1).all()
    assert torch.equal(W3[:, :H + F], w.W3[:ON]) and not W3[:, H + F:].any()
    assert not W3[taero.K:].any()                          # rows 43..47 are padding
    vec = lambda off, n: image[off:off + 4 * n].clone().view(torch.float32)
    assert torch.equal(vec(taero.IMG_B1, H), w.b1)
    assert torch.equal(vec(taero.IMG_B2, H), w.b2)
    assert torch.equal(vec(taero.IMG_B3, ON), w.b3[:ON])
    assert torch.equal(vec(taero.IMG_SD, ON), w.out_std[:ON])
    assert torch.equal(vec(taero.IMG_MU, ON), w.out_mean[:ON])
    half = lambda off, n: image[off:off + 2 * n].clone().view(torch.bfloat16)
    assert torch.equal(half(taero.IMG_B1H, H), w.b1.to(torch.bfloat16))
    assert torch.equal(half(taero.IMG_B2H, H), w.b2.to(torch.bfloat16))
    assert taero.IMG_B2H + 2 * H == taero.IMG_BYTES       # nothing behind the vectors
    with pytest.raises(ValueError, match="built for H = 256"):
        port_weights(random_weights(2)).packed()


@pytest.mark.parametrize("N,K", [(8, 8), (8, 16), (16, 8), (48, 336), (256, 80)])
def test_core_matrix_image_holds_every_element_once(N, K):
    """Distinct values in, the layout rule out: every element is found at
    its address and every cell is used exactly once."""
    # bf16 holds too few integers: the values are distinct as bit patterns
    W = torch.arange(N * K, dtype=torch.int32).reshape(N, K).to(torch.int16) \
        .view(torch.bfloat16)
    image = taero.core_matrix_image(W)
    assert image.dtype == torch.uint8 and image.shape == (2 * N * K,)
    back, hits = image_matrix(image, 0, N, K)
    assert (hits == 1).all()
    assert torch.equal(back.view(torch.int16), W.view(torch.int16))
    # a core matrix is 8 rows of 16 bytes, 128 bytes in all
    first = image[:128].clone().view(torch.bfloat16).reshape(8, 8)
    assert torch.equal(first.view(torch.int16), W[:8, :8].contiguous().view(torch.int16))


def cuh_constants(name):
    """The `constexpr int NAME = expression;` lines of a csrc header,
    evaluated in order."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(aero_cuda.__file__), "..", "csrc", name)).read()
    env = {}
    for decl in re.findall(r"constexpr int ([^;]+);", src):
        for part in re.split(r",\s*(?=[A-Z_0-9]+ = )", decl):
            nm, expr = part.split(" = ")
            env[nm.strip()] = eval(expr.replace("/", "//"), {"__builtins__": {}}, env)
    return env


@pytest.mark.parametrize("name", ["IMG_W1", "IMG_W2", "IMG_W3", "IMG_B1", "IMG_B2",
                                  "IMG_B3", "IMG_SD", "IMG_MU", "IMG_B1H", "IMG_B2H",
                                  "IMG_BYTES", "F_PAD",
                                  "OUT_N"])
def test_kernel_image_constants_match_the_packing(name):
    """csrc/distilled.cuh reads the image ops/aero.py packs."""
    assert cuh_constants("distilled.cuh")[name] == getattr(taero, name)


def test_kernel_block_fits_the_sm():
    """Shared memory, threads and registers of the persistent block."""
    c = cuh_constants("distilled.cuh")
    assert c["NP_H"] == taero.KERNEL_HIDDEN and c["N_COEF"] == taero.K
    assert c["SMEM_COEF"] == taero.IMG_BYTES
    assert c["FEAT_WORDS"] == taero.F_PAD // 16 * 4  # 4 words a thread per 16 columns
    assert c["SMEM_BYTES"] == taero.IMG_BYTES + 64 * 43 * 4 \
        + c["FEAT_WORDS"] * 128 * 4 + 8 * (3 * c["N_PAIRS"] + 1)
    assert c["SMEM_BYTES"] <= 232448
    assert c["SMEM_BARS"] % 8 == 0 and taero.IMG_BYTES % 16 == 0
    owners = 64 * c["N_PAIRS"]
    assert c["MUL_THREADS"] == 128 and c["NP_THREADS"] == 128 + owners <= 1024
    assert owners % 128 == 0                       # whole warpgroups trade registers
    assert c["MUL_REGS"] % 8 == 0 and c["PAIR_REGS"] % 8 == 0
    assert 128 * c["MUL_REGS"] + owners * c["PAIR_REGS"] <= 65536
    assert c["NP_H"] % c["NH"] == 0 and c["NH"] % 16 == 0 and c["OUT_N"] % 8 == 0


def c_prototype(source, name):
    """ctypes argument types of the C entry point `name` in csrc/`source`:
    a pointer is c_void_p, an int is c_int, a struct is named."""
    import ctypes
    import os
    import re
    src = open(os.path.join(os.path.dirname(aero_cuda.__file__), "..", "csrc",
                            source)).read()
    params = re.search(r"\bint %s\((.*?)\)\s*\{" % name, src, re.S).group(1)
    out = []
    for prm in params.split(","):
        prm = " ".join(prm.split())
        out.append(ctypes.c_void_p if "*" in prm else
                   ctypes.c_int if prm.startswith("int ") else prm.split()[0])
    return out


@pytest.mark.parametrize("source,name", [
    ("nlplant_distilled.cu", "np_nlplant_distilled"),
    ("env_step.cu", "np_env_step"), ("env_step.cu", "np_env_step_grouped")])
def test_ctypes_signatures_match_the_c_entry_points(source, name):
    from neuralplane_tpu_torch.ops import step_cuda
    py = {"np_nlplant_distilled": aero_cuda.NLPLANT_ARGTYPES,
          "np_env_step": step_cuda.ENV_STEP_ARGTYPES,
          "np_env_step_grouped": step_cuda.ENV_STEP_GROUPED_ARGTYPES}[name]
    py = [t if isinstance(t, type) and t.__module__ == "ctypes" else t.__name__ for t in py]
    assert c_prototype(source, name) == py


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
