"""Stability-derivative ("linear") aero build-up and the Cessna-172P airframe
(counterpart of neuralplane_tpu/ops/linear_aero.py).

One generic nondimensional-derivative build-up, `nlplant_linear`, over the
F-16's [n,12] wind-axis state layout and US units, parameterized by a
`LinearAeroDerivs` table; it shares `sixdof_eom` and `atmos` with the F-16
path. It is elementwise over the batch with no matrix product, so it runs
as eager tensor ops on any device: there is no kernel to write for it.

Conventions: derivatives per radian; pitch rate nondimensionalized by
cbar/2V, roll and yaw rates by b/2V; controls as the F-16's (T lbf | el deg
| ail deg | rud deg | unused). The alpha-dot lag terms are dropped. The
constants are Python floats, exactly as the JAX package's table has them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .atmosphere import atmos
from .dynamics import AirframeConst, sixdof_eom

D2R = math.pi / 180.0


class LinearAeroDerivs(NamedTuple):
    """Nondimensional stability and control derivatives of a fixed-wing
    airframe (per rad), plus its mass and geometry."""
    const: AirframeConst
    # longitudinal
    CL0: float
    CLa: float
    CLq: float
    CLde: float
    CD0: float
    k_ind: float          # induced-drag factor: CD = CD0 + k_ind * CL^2
    Cm0: float
    Cma: float
    Cmq: float
    Cmde: float
    # lateral-directional
    CYb: float
    CYdr: float
    Clb: float
    Clp: float
    Clr: float
    Clda: float
    Cldr: float
    Cnb: float
    Cnp: float
    Cnr: float
    Cnda: float
    Cndr: float


def _c172p() -> LinearAeroDerivs:
    # Cessna 172: W = 2300 lbf, S = 174 ft^2, b = 35.8 ft, cbar = 4.9 ft,
    # Ix/Iy/Iz = 948/1346/1967 slug ft^2 (Ixz ~ 0). AR = b^2/S = 7.37,
    # Oswald e = 0.75 -> k_ind = 1/(pi e AR) = 0.0576.
    const = AirframeConst(mass=2300.0 / 32.17, s_area=174.0, b_span=35.8,
                          cbar=4.9, jx=948.0, jy=1346.0, jz=1967.0,
                          jxz=0.0, heng=0.0)
    ar = const.b_span ** 2 / const.s_area
    return LinearAeroDerivs(
        const=const,
        CL0=0.31, CLa=5.143, CLq=3.9, CLde=0.43,
        CD0=0.031, k_ind=1.0 / (math.pi * 0.75 * ar),
        Cm0=-0.015, Cma=-0.89, Cmq=-12.4, Cmde=-1.28,
        CYb=-0.31, CYdr=0.21,
        Clb=-0.089, Clp=-0.47, Clr=0.096, Clda=-0.178, Cldr=0.0147,
        Cnb=0.065, Cnp=-0.03, Cnr=-0.099, Cnda=-0.053, Cndr=-0.074,
    )


C172P = _c172p()


def linear_coeffs(p: LinearAeroDerivs, alpha_r, beta_r, P, Q, R, vt,
                  el_r, ail_r, rud_r):
    """Total body-axis coefficients (Cx, Cy, Cz, Cl, Cm, Cn) from the table.
    Lift and drag are built in stability axes and rotated to body axes by
    alpha: Cx = CL sin(a) - CD cos(a), Cz = -CL cos(a) - CD sin(a)."""
    half_c_v = p.const.cbar / (2.0 * vt)
    half_b_v = p.const.b_span / (2.0 * vt)
    qh = Q * half_c_v
    ph = P * half_b_v
    rh = R * half_b_v

    CL = p.CL0 + p.CLa * alpha_r + p.CLq * qh + p.CLde * el_r
    CD = p.CD0 + p.k_ind * CL * CL
    sa, ca = torch.sin(alpha_r), torch.cos(alpha_r)
    Cx = CL * sa - CD * ca
    Cz = -CL * ca - CD * sa
    Cy = p.CYb * beta_r + p.CYdr * rud_r
    Cl = (p.Clb * beta_r + p.Clp * ph + p.Clr * rh
          + p.Clda * ail_r + p.Cldr * rud_r)
    Cm = p.Cm0 + p.Cma * alpha_r + p.Cmq * qh + p.Cmde * el_r
    Cn = (p.Cnb * beta_r + p.Cnp * ph + p.Cnr * rh
          + p.Cnda * ail_r + p.Cndr * rud_r)
    return Cx, Cy, Cz, Cl, Cm, Cn


def nlplant_linear(p: LinearAeroDerivs, s: torch.Tensor, u: torch.Tensor
                   ) -> torch.Tensor:
    """State derivative of a derivative-table airframe: s [n,12] (the
    F-16's layout and units), u [n,5] (T lbf, el/ail/rud deg, column 4
    ignored) -> xdot [n,12]."""
    sv = tuple(s[:, i] for i in range(12))
    alt, vt_raw = sv[2], sv[6]
    vt = torch.clamp(vt_raw, min=0.01)
    _, qbar, _ = atmos(alt, vt)
    coeffs = linear_coeffs(
        p, alpha_r=sv[7], beta_r=sv[8], P=sv[9], Q=sv[10], R=sv[11], vt=vt,
        el_r=u[:, 1] * D2R, ail_r=u[:, 2] * D2R, rud_r=u[:, 3] * D2R)
    xd = sixdof_eom(sv, u[:, 0], qbar, coeffs, p.const)
    return torch.stack(xd, dim=1)
