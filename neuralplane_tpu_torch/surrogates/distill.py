"""Distilled aero surrogate, the subset the kernels need (counterpart of
neuralplane_tpu/surrogates/distill.py:76-95 and :285-308).

One shared trunk [68 hinge features -> H -> H] with a [43, H + 68] readout
over [hidden ; features] replaces the 43-net ensemble. The net runs in
z-space; raw coefficients are z * out_std + out_mean.

bf16 rounding points, as the TPU kernel has them: features are computed in
float32 (by division by IN_SCALE) and cast to bf16; every product takes bf16
operands with a float32 accumulator; with `hidden_bf16` each hidden
accumulator is rounded to bf16 and added to the bf16-cast bias in bf16
before the ReLU; the readout keeps its float32 accumulator.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Hinge knots and input scaling (must equal the npz's, which the loader checks)
ALPHA_KNOTS = np.linspace(-20.0, 90.0, 45, dtype=np.float32)[1:-1]
BETA_KNOTS = np.linspace(-30.0, 30.0, 17, dtype=np.float32)[1:-1]
EL_KNOTS = np.linspace(-25.0, 25.0, 9, dtype=np.float32)[1:-1]
N_FEAT = 3 + len(ALPHA_KNOTS) + len(BETA_KNOTS) + len(EL_KNOTS)
IN_SCALE = np.array([35.0, 18.0, 15.0], np.float32)
IN_MEAN = np.array([35.0, 0.0, 0.0], np.float32)


class DistilledParams(NamedTuple):
    """Trunk parameters, math convention y = W @ x + b (float32 tensors
    holding bf16-representable weights)."""
    W1: torch.Tensor  # [H, F]
    b1: torch.Tensor  # [H]
    W2: torch.Tensor  # [H, H]
    b2: torch.Tensor  # [H]
    W3: torch.Tensor  # [K, H + F]
    b3: torch.Tensor  # [K]


def featurize(x: torch.Tensor) -> torch.Tensor:
    """[n, 3] raw degrees (alpha, beta, el) -> [n, F] float32 features."""
    a, b, e = x[:, 0], x[:, 1], x[:, 2]
    cols = [(a - float(IN_MEAN[0])) / float(IN_SCALE[0]),
            b / float(IN_SCALE[1]), e / float(IN_SCALE[2])]
    cols += [torch.relu(a - float(k)) / float(IN_SCALE[0]) for k in ALPHA_KNOTS]
    cols += [torch.relu(b - float(k)) / float(IN_SCALE[1]) for k in BETA_KNOTS]
    cols += [torch.relu(e - float(k)) / float(IN_SCALE[2]) for k in EL_KNOTS]
    return torch.stack(cols, dim=1)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, float32 product: operands are rounded to bf16 and the
    product runs in float32 (a bf16 matmul would round its output)."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def trunk_z(f: torch.Tensor, W1, b1, W2, b2, W3, b3,
            hidden_bf16: bool = True) -> torch.Tensor:
    """f [n, F] features -> [n, rows(W3)] z-space outputs, with the TPU
    kernel's rounding points (module docstring)."""
    bf = torch.bfloat16
    fb = f.to(bf)
    if hidden_bf16:
        h = torch.relu(_mm(fb, W1.T).to(bf) + b1.to(bf))
        h = torch.relu(_mm(h, W2.T).to(bf) + b2.to(bf))
    else:
        h = torch.relu(_mm(fb, W1.T) + b1)
        h = torch.relu(_mm(h, W2.T) + b2).to(bf)
    return _mm(torch.cat([h, fb], dim=1), W3.T) + b3


def quantized_coeffs_z(p: DistilledParams, x: torch.Tensor,
                       hidden_bf16: bool = True) -> torch.Tensor:
    """bf16-quantized net as the kernel computes it: [n, 3] -> [n, K] z."""
    return trunk_z(featurize(x), *p, hidden_bf16=hidden_bf16)


def quantized_coeffs(p: DistilledParams, mean, std, alpha_deg, beta_deg,
                     el_deg, hidden_bf16: bool = True) -> torch.Tensor:
    """Raw-coefficient rows [K, n] (AERO_NAMES order), quantized path."""
    x = torch.stack([alpha_deg, beta_deg, el_deg], dim=1)
    z = quantized_coeffs_z(p, x, hidden_bf16)
    std, mean = (v.to(z.device, torch.float32) if isinstance(v, torch.Tensor)
                 else torch.as_tensor(np.array(v, np.float32), device=z.device)
                 for v in (std, mean))
    return (z * std + mean).T
