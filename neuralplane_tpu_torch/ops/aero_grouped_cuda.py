"""The 43-net aero ensemble in fused kernels: the Hopper kernels and their
plain versions (counterpart of neuralplane_tpu/ops/aero_pallas.py:53-450).

Three wrappers over `csrc/aero_grouped.cu`, each with its plain PyTorch
version beside it:

    aero_coeffs_grouped(w, alpha_deg, beta_deg, el)   -> [K, n] or [n, K]
        (aero_coeffs_pallas_ft / aero_coeffs_pallas_t / aero_coeffs_pallas)
    aero_totals(w, feats [10, n])                     -> [6, n]
        (aero_totals_pallas_ft)
    nlplant_grouped(w, s [n,12], u [n,5])             -> xdot [n, 12]
        (nlplant_pallas_ft)

A wrapper launches its kernel on CUDA tensors (a failure raises) and runs
its plain version on CPU tensors; nothing else. `<wrapper>.launches` counts
kernel launches.

The plain versions repeat the kernels' arithmetic, not the float32 stacked
query's: the three inputs and every weight are rounded to bf16, products
are summed in float32, and the hidden layers round as `grouped_coeff_rows`
says. They run on the stacked [K, ...] leaves: the kernels' padding only
adds exact zeros.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .aero import IDX, GroupedAeroWeights
from .buildup import B_SPAN, CBAR, coeff_buildup
from .dynamics import R2D, nlplant_core

N_S, N_U = 12, 5
N_FEATS = 10   # alpha beta el dlef dail drud P Q R 1/(2 vt)
N_TOT = 6      # Cx Cy Cz Cl Cm Cn
PLAIN_CHUNK = 65536   # aircraft per pass of the plain sweep ([K, chunk, 20] float32)


def _mm(h: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Per-net product [K, m, i] x [K, i, j] with bf16 operands and a
    float32 sum (a bf16 matmul would round its output)."""
    bf = torch.bfloat16
    return torch.bmm(h.to(bf).float(), W.to(bf).float())


def grouped_coeff_rows(w: GroupedAeroWeights, alpha_deg, beta_deg, el,
                       hidden_bf16: bool = False) -> torch.Tensor:
    """Three [n] rows -> [K, n] float32 raw coefficients with the rounding
    points of aero_pallas.py:aero_coeff_rows. hidden_bf16=False: the float32
    bias joins the float32 sum, then ReLU, then the result is rounded to
    bf16 for the next product. hidden_bf16=True: the sum is rounded to bf16
    once, the bias is rounded to bf16, and the add and the ReLU run in
    bf16. The readout is bf16 h3 times bf16 W4 summed in float32, plus the
    float32 b4."""
    bf = torch.bfloat16
    k = w.W1.shape[0]
    x = torch.stack([alpha_deg, beta_deg, el], dim=1).to(bf)          # [n, 3]
    out = []
    for x_c in x.split(PLAIN_CHUNK):
        h = x_c.unsqueeze(0).expand(k, -1, -1)
        for W, b in ((w.W1, w.b1), (w.W2, w.b2), (w.W3, w.b3)):
            a = _mm(h, W)
            if hidden_bf16:
                h = torch.relu(a.to(bf) + b.to(bf)[:, None, :])
            else:
                h = torch.relu(a + b[:, None, :]).to(bf)
        y = _mm(h, w.W4[:, :, None])[:, :, 0] + w.b4[:, None]
        out.append(y)
    return torch.cat(out, dim=1) if len(out) != 1 else out[0]


def aero_coeffs_grouped_plain(w: GroupedAeroWeights, alpha_deg, beta_deg, el,
                              row_major: bool = False) -> torch.Tensor:
    """Plain PyTorch query: [K, n], or [n, K] with row_major."""
    c = grouped_coeff_rows(w, alpha_deg, beta_deg, el, hidden_bf16=False)
    return c.T.contiguous() if row_major else c


def aero_totals_plain(w: GroupedAeroWeights, feats: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch query + build-up: feats [10, n] -> [6, n]."""
    c = grouped_coeff_rows(w, feats[0], feats[1], feats[2], hidden_bf16=False)
    inv_2v = feats[9]
    totals = coeff_buildup(
        lambda name: c[IDX[name]], dlef=feats[3], dail=feats[4], drud=feats[5],
        P=feats[6], Q=feats[7], R=feats[8], beta_deg=feats[1],
        half_cbar_v=CBAR * inv_2v, half_b_v=B_SPAN * inv_2v)
    return torch.stack(totals)


def nlplant_grouped_plain(w: GroupedAeroWeights, s: torch.Tensor, u: torch.Tensor,
                          hidden_bf16: bool = True) -> torch.Tensor:
    """Plain PyTorch xdot on the 43 nets: s [n,12], u [n,5] -> [n,12]."""
    c = grouped_coeff_rows(w, s[:, 7] * R2D, s[:, 8] * R2D, u[:, 1], hidden_bf16)
    xd = nlplant_core(tuple(s[:, i] for i in range(N_S)),
                      tuple(u[:, i] for i in range(N_U)),
                      lambda name: c[IDX[name]])
    return torch.stack(xd, dim=1)


def _check(w, tensors):
    if not isinstance(w, GroupedAeroWeights):
        raise TypeError(f"want GroupedAeroWeights, got {type(w).__name__}")
    for name, t in tensors.items():
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, weights on {w.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def _lib():
    lib = cuda_build.load("aero_grouped")
    if not getattr(lib, "_np_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        # inputs | frags vec | output n [flag] stream
        lib.np_aero_coeffs.argtypes = [p, p, p, p, p, p, i, i, p]
        lib.np_aero_totals.argtypes = [p, p, p, p, i, p]
        lib.np_nlplant_grouped.argtypes = [p, p, p, p, p, i, i, p]
        for fn in (lib.np_aero_coeffs, lib.np_aero_totals, lib.np_nlplant_grouped):
            fn.restype = ctypes.c_int
        lib._np_typed = True
    return lib


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def aero_coeffs_grouped(w: GroupedAeroWeights, alpha_deg, beta_deg, el,
                        row_major: bool = False) -> torch.Tensor:
    """The 43 raw coefficients of n aircraft from one fused kernel:
    [K, n] rows in AERO_NAMES order, or [n, K] with row_major (the layout
    is a flag of the one kernel, not a transpose afterwards)."""
    _check(w, {"alpha_deg": alpha_deg, "beta_deg": beta_deg, "el": el})
    n = alpha_deg.shape[0]
    if not (alpha_deg.shape == beta_deg.shape == el.shape == (n,)):
        raise ValueError("alpha_deg, beta_deg and el must be [n]")
    if alpha_deg.device.type != "cuda":
        return aero_coeffs_grouped_plain(w, alpha_deg, beta_deg, el, row_major)
    k = w.W1.shape[0]
    out = torch.empty((n, k) if row_major else (k, n), dtype=torch.float32,
                      device=w.device)
    if n == 0:
        return out
    a, b, e = alpha_deg.contiguous(), beta_deg.contiguous(), el.contiguous()
    frags, vec = w.packed()
    lib = _lib()
    code = lib.np_aero_coeffs(a.data_ptr(), b.data_ptr(), e.data_ptr(),
                              frags.data_ptr(), vec.data_ptr(), out.data_ptr(),
                              n, int(row_major), _stream(a))
    aero_coeffs_grouped.launches += 1
    cuda_build.check(code, "aero_coeffs_grouped", lib)
    return out


aero_coeffs_grouped.launches = 0


def aero_totals(w: GroupedAeroWeights, feats: torch.Tensor) -> torch.Tensor:
    """Fused query + build-up. `feats` is the feature-major [10, n] stack
    (alpha_deg, beta_deg, el_deg, dlef, dail, drud, P, Q, R, 1/(2 vt));
    returns [6, n] = (Cx, Cy, Cz, Cl, Cm, Cn) totals."""
    _check(w, {"feats": feats})
    n = feats.shape[1]
    if feats.shape != (N_FEATS, n):
        raise ValueError(f"want feats [{N_FEATS}, n], got {tuple(feats.shape)}")
    if feats.device.type != "cuda":
        return aero_totals_plain(w, feats)
    out = torch.empty((N_TOT, n), dtype=torch.float32, device=w.device)
    if n == 0:
        return out
    feats = feats.contiguous()
    frags, vec = w.packed()
    lib = _lib()
    code = lib.np_aero_totals(feats.data_ptr(), frags.data_ptr(), vec.data_ptr(),
                              out.data_ptr(), n, _stream(feats))
    aero_totals.launches += 1
    cuda_build.check(code, "aero_totals", lib)
    return out


aero_totals.launches = 0


def nlplant_grouped(w: GroupedAeroWeights, s: torch.Tensor, u: torch.Tensor,
                    hidden_bf16: bool = True) -> torch.Tensor:
    """xdot = f(s, u) on the 43-net ensemble: s [n,12], u [n,5] -> [n,12]."""
    _check(w, {"s": s, "u": u})
    n = s.shape[0]
    if s.shape != (n, N_S) or u.shape != (n, N_U):
        raise ValueError(f"want s [n,{N_S}], u [n,{N_U}]; got {tuple(s.shape)}, "
                         f"{tuple(u.shape)}")
    if s.device.type != "cuda":
        return nlplant_grouped_plain(w, s, u, hidden_bf16)
    s, u = s.contiguous(), u.contiguous()
    xdot = torch.empty_like(s)
    if n == 0:
        return xdot
    frags, vec = w.packed()
    lib = _lib()
    code = lib.np_nlplant_grouped(s.data_ptr(), u.data_ptr(), frags.data_ptr(),
                                  vec.data_ptr(), xdot.data_ptr(), n,
                                  int(hidden_bf16), _stream(s))
    nlplant_grouped.launches += 1
    cuda_build.check(code, "nlplant_grouped", lib)
    return xdot


nlplant_grouped.launches = 0
