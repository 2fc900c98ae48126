"""Distilled-surrogate state derivative: the Hopper kernel and its plain
version (counterpart of neuralplane_tpu/ops/aero_pallas.py:524-620,
`nlplant_pallas_distilled` and its row functions).

`nlplant_distilled(w, s, u)` launches `csrc/nlplant_distilled.cu` on CUDA
tensors and runs `nlplant_distilled_plain` on CPU tensors; nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from ..surrogates.distill import featurize, trunk_z
from . import cuda_build
from .aero import IDX, DistilledAeroWeights
from .dynamics import R2D, nlplant_core

N_S, N_U = 12, 5


def distilled_feature_rows(alpha_deg, beta_deg, el) -> torch.Tensor:
    """Three [n] rows -> [F, n] bf16 hinge features (aero_pallas.py:524-541)."""
    x = torch.stack([alpha_deg, beta_deg, el], dim=1)
    return featurize(x).T.to(torch.bfloat16)


def distilled_coeff_rows(ft: torch.Tensor, w: DistilledAeroWeights,
                         hidden_bf16: bool = True) -> torch.Tensor:
    """[F, n] bf16 features -> [OUT, n] float32 raw coefficients
    (aero_pallas.py:544-564): the z-space trunk, then z * sd + mu."""
    z = trunk_z(ft.T, w.W1, w.b1, w.W2, w.b2, w.W3, w.b3, hidden_bf16)
    return (z * w.out_std + w.out_mean).T


def nlplant_distilled_plain(w: DistilledAeroWeights, s: torch.Tensor,
                            u: torch.Tensor, hidden_bf16: bool = True
                            ) -> torch.Tensor:
    """Plain PyTorch xdot: s [n,12], u [n,5] float32 -> [n,12]."""
    ft = distilled_feature_rows(s[:, 7] * R2D, s[:, 8] * R2D, u[:, 1])
    c = distilled_coeff_rows(ft, w, hidden_bf16)
    xd = nlplant_core(tuple(s[:, i] for i in range(N_S)),
                      tuple(u[:, i] for i in range(N_U)),
                      lambda name: c[IDX[name]])
    return torch.stack(xd, dim=1)


def _check_inputs(w, tensors):
    dev = w.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, weights on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


_P, _I = ctypes.c_void_p, ctypes.c_int
# np_nlplant_distilled(s, u, xdot, n, image, H, hidden_bf16, stream)
NLPLANT_ARGTYPES = [_P, _P, _P, _I, _P, _I, _I, _P]


def _lib():
    lib = cuda_build.load("nlplant_distilled")
    if not getattr(lib, "_np_typed", False):
        lib.np_nlplant_distilled.argtypes = NLPLANT_ARGTYPES
        lib.np_nlplant_distilled.restype = ctypes.c_int
        lib._np_typed = True
    return lib


def nlplant_distilled(w: DistilledAeroWeights, s: torch.Tensor,
                      u: torch.Tensor, hidden_bf16: bool = True) -> torch.Tensor:
    """xdot = f(s, u) on the distilled surrogate: s [n,12], u [n,5] -> [n,12].

    CUDA tensors go to the kernel (a failure raises); CPU tensors go to the
    plain version. `nlplant_distilled.launches` counts kernel launches."""
    _check_inputs(w, {"s": s, "u": u})
    n = s.shape[0]
    if s.shape != (n, N_S) or u.shape != (n, N_U):
        raise ValueError(f"want s [n,{N_S}], u [n,{N_U}]; got {tuple(s.shape)}, "
                         f"{tuple(u.shape)}")
    if s.device.type != "cuda":
        return nlplant_distilled_plain(w, s, u, hidden_bf16)
    s, u = s.contiguous(), u.contiguous()
    if s.data_ptr() % 16:  # the kernel reads a state row as three float4
        s = s.clone()
    xdot = torch.empty_like(s)
    if n == 0:
        return xdot
    image = w.packed()
    lib = _lib()
    code = lib.np_nlplant_distilled(
        s.data_ptr(), u.data_ptr(), xdot.data_ptr(), n,
        image.data_ptr(), w.hidden, int(hidden_bf16),
        torch.cuda.current_stream(s.device).cuda_stream)
    nlplant_distilled.launches += 1
    cuda_build.check(code, "nlplant_distilled", lib)
    return xdot


nlplant_distilled.launches = 0
