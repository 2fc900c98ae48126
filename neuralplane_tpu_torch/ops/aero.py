"""Aero-coefficient names and the distilled weight container (counterpart of
neuralplane_tpu/ops/aero.py and the loader of ops/aero_pallas.py:467-521).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from ..surrogates import distill

# Canonical coefficient order (neuralplane_tpu/ops/aero.py AERO_NAMES).
AERO_NAMES = (
    "Cx", "Cz", "Cm", "Cy", "Cn", "Cl",
    "Cxq", "Cyr", "Cyp", "Czq", "Clr", "Clp", "Cmq", "Cnr", "Cnp",
    "delta_Cx_lef", "delta_Cz_lef", "delta_Cm_lef", "delta_Cy_lef",
    "delta_Cn_lef", "delta_Cl_lef",
    "delta_Cxq_lef", "delta_Cyr_lef", "delta_Cyp_lef", "delta_Czq_lef",
    "delta_Clr_lef", "delta_Clp_lef", "delta_Cmq_lef", "delta_Cnr_lef",
    "delta_Cnp_lef",
    "delta_Cy_r30", "delta_Cn_r30", "delta_Cl_r30",
    "delta_Cy_a20", "delta_Cy_a20_lef", "delta_Cn_a20", "delta_Cn_a20_lef",
    "delta_Cl_a20", "delta_Cl_a20_lef",
    "delta_Cnbeta", "delta_Clbeta", "delta_Cm", "eta_el",
)
IDX = {name: i for i, name in enumerate(AERO_NAMES)}
K = len(AERO_NAMES)
OUT = 64      # readout rows (43 real, zero-padded)
F_PAD = 80    # the kernels' feature width: 68 features padded to 5 x 16
KERNEL_HIDDEN = 256  # the hidden width the CUDA kernels are built for (csrc/distilled.cuh)

_DISTILLED_NPZ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "neuralplane_tpu", "data", "f16_aero_distilled.npz")
LEAVES = ("W1", "b1", "W2", "b2", "W3", "b3", "out_mean", "out_std")


@dataclasses.dataclass(eq=False)
class DistilledAeroWeights:
    """Distilled-trunk weights, left-multiply convention (y = W @ x).

    W1 [H, F], W2 [H, H], W3 [OUT, H + F] are bf16; b1, b2 [H], b3, out_mean,
    out_std [OUT] are float32. W3 reads [hidden ; hinge features]."""
    W1: torch.Tensor
    b1: torch.Tensor
    W2: torch.Tensor
    b2: torch.Tensor
    W3: torch.Tensor
    b3: torch.Tensor
    out_mean: torch.Tensor
    out_std: torch.Tensor

    def __post_init__(self):
        self._packed = None

    @property
    def hidden(self) -> int:
        return self.W1.shape[0]

    @property
    def device(self) -> torch.device:
        return self.W1.device

    def leaves(self):
        return tuple(getattr(self, k) for k in LEAVES)

    def to_numpy(self):
        """float32 numpy leaves in LEAVES order (inverse of distilled_from_numpy)."""
        return tuple(t.detach().float().cpu().numpy() for t in self.leaves())

    def packed(self):
        """The kernels' layout, made once per container: W1 zero-padded to
        [H, F_PAD]; W3 as [OUT, H + F_PAD] with the feature block padded the
        same way; W2 and the float32 vectors as they are."""
        if self._packed is None:
            H, F = self.W1.shape
            if H != KERNEL_HIDDEN or F != distill.N_FEAT:
                raise ValueError(f"the CUDA kernels are built for H = {KERNEL_HIDDEN}, "
                                 f"F = {distill.N_FEAT}; got H={H}, F={F}")
            w1p = torch.zeros(H, F_PAD, dtype=torch.bfloat16, device=self.device)
            w1p[:, :F] = self.W1
            w3p = torch.zeros(OUT, H + F_PAD, dtype=torch.bfloat16,
                              device=self.device)
            w3p[:, :H + F] = self.W3
            self._packed = (w1p, self.b1.contiguous(), self.W2.contiguous(),
                            self.b2.contiguous(), w3p, self.b3.contiguous(),
                            self.out_mean.contiguous(), self.out_std.contiguous())
        return self._packed


def distilled_from_numpy(leaves: Sequence[np.ndarray],
                         device="cuda") -> DistilledAeroWeights:
    """Carry the JAX package's DistilledAeroWeightsT leaves (as numpy, in
    LEAVES order; W1/W2/W3 arrive as bf16 and are cast to float32 first)
    into the port's container on `device`."""
    if len(leaves) != len(LEAVES):
        raise ValueError(f"expected {len(LEAVES)} leaves {LEAVES}, got {len(leaves)}")
    t = {}
    for name, a in zip(LEAVES, leaves):
        a = torch.from_numpy(np.asarray(a).astype(np.float32))
        t[name] = a.to(device=device,
                       dtype=torch.bfloat16 if name[0] == "W" else torch.float32)
    if t["W3"].shape[0] != OUT:
        raise ValueError(f"W3 must have {OUT} rows, got {t['W3'].shape[0]}")
    return DistilledAeroWeights(**t)


def load_distilled(path: str | None = None, device="cuda") -> DistilledAeroWeights:
    """Load the shipped distilled npz (the JAX package's data file, read by
    path), checking coefficient order, knots and input scaling as
    ops/aero_pallas.py:_load_distilled_np does."""
    path = path or _DISTILLED_NPZ
    with np.load(path) as z:
        names = tuple(str(n) for n in z["names"])
        if names != AERO_NAMES:
            raise ValueError(f"{path}: coefficient order mismatch")
        for key, ref in (("alpha_knots", distill.ALPHA_KNOTS),
                         ("beta_knots", distill.BETA_KNOTS),
                         ("el_knots", distill.EL_KNOTS),
                         ("in_scale", distill.IN_SCALE),
                         ("in_mean", distill.IN_MEAN)):
            if not np.allclose(z[key], ref):
                raise ValueError(f"{path}: {key} mismatch - re-run distillation")
        leaves = [z[k] for k in LEAVES]
    return distilled_from_numpy(leaves, device=device)
