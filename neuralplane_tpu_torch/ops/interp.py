"""Batched n-D multilinear table interpolation (counterpart of
neuralplane_tpu/ops/interp.py).

Given d 1-D grid axes and a value hypercube, a batch of query points is
evaluated by gathering the 2^d surrounding corners and blending them with
product weights, in vectorized gathers. Queries outside the table domain
clamp to the boundary cell. Axes and values may be numpy arrays or tensors;
they are taken in the dtype and on the device of `points`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def interpn(axes: Sequence, values, points: torch.Tensor) -> torch.Tensor:
    """Multilinear interpolation: d strictly increasing 1-D grids (axis i of
    length n_i), values [n_0, ..., n_{d-1}], points [N, d] -> [N]."""
    d = len(axes)
    dt, dev = points.dtype, points.device
    values = torch.as_tensor(np.asarray(values) if not isinstance(values, torch.Tensor)
                             else values, dtype=dt).to(dev)
    if values.ndim != d or points.shape[-1] != d:
        raise ValueError(f"want values of {d} dims and points [N, {d}], got "
                         f"{tuple(values.shape)} and {tuple(points.shape)}")

    idx0, frac = [], []
    for i, ax in enumerate(axes):
        ax = torch.as_tensor(np.asarray(ax) if not isinstance(ax, torch.Tensor) else ax,
                             dtype=dt).to(dev)
        n = ax.shape[0]
        x = points[:, i]
        if n == 1:
            idx0.append(torch.zeros_like(x, dtype=torch.int64))
            frac.append(torch.zeros_like(x))
            continue
        j = torch.clamp(torch.searchsorted(ax, x.contiguous(), right=True) - 1, 0, n - 2)
        x0, x1 = ax[j], ax[j + 1]
        idx0.append(j)
        frac.append(torch.clamp((x - x0) / (x1 - x0), 0.0, 1.0))

    strides = [1] * d
    for i in range(d - 2, -1, -1):
        strides[i] = strides[i + 1] * values.shape[i + 1]
    flat = values.reshape(-1)

    out = 0.0
    for corner in range(1 << d):
        lin = 0
        w = 1.0
        for i in range(d):
            hi = (corner >> i) & 1
            n = values.shape[i]
            step = torch.where(idx0[i] + hi > n - 1, 0, hi) if n > 1 else 0
            lin = lin + (idx0[i] + step) * strides[i]
            w = w * (frac[i] if hi else 1.0 - frac[i])
        out = out + w * flat[lin]
    return out


def load_dat(path: str) -> np.ndarray:
    """Whitespace-separated .dat table file -> flat float array."""
    with open(path, "r", encoding="utf-8") as f:
        return np.array([float(v) for v in f.read().split()])


def table_from_flat(flat: np.ndarray, axes: Sequence[np.ndarray]) -> np.ndarray:
    """Reshape a flat reference table to [n_0, ..., n_{d-1}] (axis-0-major).

    Reference layout is Fortran-order: value(i, j, k) at flat index
    i + n0 * j + n0 * n1 * k."""
    dims = [len(a) for a in axes]
    return flat.reshape(dims[::-1]).transpose(range(len(dims) - 1, -1, -1))
