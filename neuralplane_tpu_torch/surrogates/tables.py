"""NASA F-16 aero table registry and loaders (counterpart of
neuralplane_tpu/surrogates/tables.py, with its own copy of the registry).

Maps each of the 43 aero coefficients to its NASA table file and grid axes.
`load_tables(data_dir)` reads the .dat files (any copy of the public NASA
tables) and returns interpolation-ready AeroTable objects - the fidelity
oracles the MLP surrogates are trained against. Every surrogate consumes a
subset of (alpha_deg, beta_deg, el_deg); `input_keys` records which.

An AeroTable evaluates on the CPU in float32, as the JAX package's does:
it is host-side data, the training set of `surrogates/train.py`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops.interp import interpn, load_dat, table_from_flat

# name -> (dat file, axis files, input keys)
TABLE_REGISTRY: Dict[str, Tuple[str, Tuple[str, ...], Tuple[str, ...]]] = {
    "Cx": ("CX0120_ALPHA1_BETA1_DH1_201.dat", ("ALPHA1", "BETA1", "DH1"),
           ("alpha", "beta", "el")),
    "Cz": ("CZ0120_ALPHA1_BETA1_DH1_301.dat", ("ALPHA1", "BETA1", "DH1"),
           ("alpha", "beta", "el")),
    "Cm": ("CM0120_ALPHA1_BETA1_DH1_101.dat", ("ALPHA1", "BETA1", "DH1"),
           ("alpha", "beta", "el")),
    "Cy": ("CY0320_ALPHA1_BETA1_401.dat", ("ALPHA1", "BETA1"),
           ("alpha", "beta")),
    "Cn": ("CN0120_ALPHA1_BETA1_DH2_501.dat", ("ALPHA1", "BETA1", "DH2"),
           ("alpha", "beta", "el")),
    "Cl": ("CL0120_ALPHA1_BETA1_DH2_601.dat", ("ALPHA1", "BETA1", "DH2"),
           ("alpha", "beta", "el")),
    "Cxq": ("CX1120_ALPHA1_204.dat", ("ALPHA1",), ("alpha",)),
    "Cyr": ("CY1320_ALPHA1_406.dat", ("ALPHA1",), ("alpha",)),
    "Cyp": ("CY1220_ALPHA1_408.dat", ("ALPHA1",), ("alpha",)),
    "Czq": ("CZ1120_ALPHA1_304.dat", ("ALPHA1",), ("alpha",)),
    "Clr": ("CL1320_ALPHA1_606.dat", ("ALPHA1",), ("alpha",)),
    "Clp": ("CL1220_ALPHA1_608.dat", ("ALPHA1",), ("alpha",)),
    "Cmq": ("CM1120_ALPHA1_104.dat", ("ALPHA1",), ("alpha",)),
    "Cnr": ("CN1320_ALPHA1_506.dat", ("ALPHA1",), ("alpha",)),
    "Cnp": ("CN1220_ALPHA1_508.dat", ("ALPHA1",), ("alpha",)),
    "delta_Cx_lef": ("CX0820_ALPHA2_BETA1_202.dat", ("ALPHA2", "BETA1"),
                     ("alpha", "beta")),
    "delta_Cz_lef": ("CZ0820_ALPHA2_BETA1_302.dat", ("ALPHA2", "BETA1"),
                     ("alpha", "beta")),
    "delta_Cm_lef": ("CM0820_ALPHA2_BETA1_102.dat", ("ALPHA2", "BETA1"),
                     ("alpha", "beta")),
    "delta_Cy_lef": ("CY0820_ALPHA2_BETA1_402.dat", ("ALPHA2", "BETA1"),
                     ("alpha", "beta")),
    "delta_Cn_lef": ("CN0820_ALPHA2_BETA1_502.dat", ("ALPHA2", "BETA1"),
                     ("alpha", "beta")),
    "delta_Cl_lef": ("CL0820_ALPHA2_BETA1_602.dat", ("ALPHA2", "BETA1"),
                     ("alpha", "beta")),
    "delta_Cxq_lef": ("CX1420_ALPHA2_205.dat", ("ALPHA2",), ("alpha",)),
    "delta_Cyr_lef": ("CY1620_ALPHA2_407.dat", ("ALPHA2",), ("alpha",)),
    "delta_Cyp_lef": ("CY1520_ALPHA2_409.dat", ("ALPHA2",), ("alpha",)),
    "delta_Czq_lef": ("CZ1420_ALPHA2_305.dat", ("ALPHA2",), ("alpha",)),
    "delta_Clr_lef": ("CL1620_ALPHA2_607.dat", ("ALPHA2",), ("alpha",)),
    "delta_Clp_lef": ("CL1520_ALPHA2_609.dat", ("ALPHA2",), ("alpha",)),
    "delta_Cmq_lef": ("CM1420_ALPHA2_105.dat", ("ALPHA2",), ("alpha",)),
    "delta_Cnr_lef": ("CN1620_ALPHA2_507.dat", ("ALPHA2",), ("alpha",)),
    "delta_Cnp_lef": ("CN1520_ALPHA2_509.dat", ("ALPHA2",), ("alpha",)),
    "delta_Cy_r30": ("CY0720_ALPHA1_BETA1_405.dat", ("ALPHA1", "BETA1"),
                     ("alpha", "beta")),
    "delta_Cn_r30": ("CN0720_ALPHA1_BETA1_503.dat", ("ALPHA1", "BETA1"),
                     ("alpha", "beta")),
    "delta_Cl_r30": ("CL0720_ALPHA1_BETA1_603.dat", ("ALPHA1", "BETA1"),
                     ("alpha", "beta")),
    "delta_Cy_a20": ("CY0620_ALPHA1_BETA1_403.dat", ("ALPHA1", "BETA1"),
                     ("alpha", "beta")),
    "delta_Cy_a20_lef": ("CY0920_ALPHA2_BETA1_404.dat", ("ALPHA2", "BETA1"),
                         ("alpha", "beta")),
    "delta_Cn_a20": ("CN0620_ALPHA1_BETA1_504.dat", ("ALPHA1", "BETA1"),
                     ("alpha", "beta")),
    "delta_Cn_a20_lef": ("CN0920_ALPHA2_BETA1_505.dat", ("ALPHA2", "BETA1"),
                         ("alpha", "beta")),
    "delta_Cl_a20": ("CL0620_ALPHA1_BETA1_604.dat", ("ALPHA1", "BETA1"),
                     ("alpha", "beta")),
    "delta_Cl_a20_lef": ("CL0920_ALPHA2_BETA1_605.dat", ("ALPHA2", "BETA1"),
                         ("alpha", "beta")),
    "delta_Cnbeta": ("CN9999_ALPHA1_brett.dat", ("ALPHA1",), ("alpha",)),
    "delta_Clbeta": ("CL9999_ALPHA1_brett.dat", ("ALPHA1",), ("alpha",)),
    "delta_Cm": ("CM9999_ALPHA1_brett.dat", ("ALPHA1",), ("alpha",)),
    "eta_el": ("ETA_DH1_brett.dat", ("DH1",), ("el",)),
}


@dataclasses.dataclass
class AeroTable:
    name: str
    axes: Tuple[np.ndarray, ...]
    values: np.ndarray
    input_keys: Tuple[str, ...]

    def __call__(self, points: np.ndarray) -> np.ndarray:
        pts = torch.from_numpy(np.asarray(points, np.float32))
        return interpn(self.axes, self.values, pts).numpy()

    def dense_grid(self, subdivide: int = 3) -> Tuple[np.ndarray, np.ndarray]:
        """(points [N, d], targets [N]) on a `subdivide`x-refined grid - the
        surrogate training set."""
        fine_axes = []
        for ax in self.axes:
            if len(ax) == 1:
                fine_axes.append(ax)
                continue
            fine = [np.linspace(ax[i], ax[i + 1], subdivide, endpoint=False)
                    for i in range(len(ax) - 1)]
            fine_axes.append(np.concatenate(fine + [ax[-1:]]))
        mesh = np.meshgrid(*fine_axes, indexing="ij")
        points = np.stack([m.reshape(-1) for m in mesh], axis=1)
        return points, self(points)


def load_tables(data_dir: str, names: Sequence[str] = None) -> Dict[str, AeroTable]:
    """Load the axis files and the requested coefficient tables from data_dir."""
    names = list(names or TABLE_REGISTRY.keys())
    axis_cache: Dict[str, np.ndarray] = {}

    def axis(axis_name: str) -> np.ndarray:
        if axis_name not in axis_cache:
            axis_cache[axis_name] = load_dat(os.path.join(data_dir, f"{axis_name}.dat"))
        return axis_cache[axis_name]

    out = {}
    for name in names:
        dat, axis_names, input_keys = TABLE_REGISTRY[name]
        axes = tuple(axis(a) for a in axis_names)
        flat = load_dat(os.path.join(data_dir, dat))
        out[name] = AeroTable(name=name, axes=axes, values=table_from_flat(flat, axes),
                              input_keys=input_keys)
    return out
