"""6-DOF flight dynamics of the F-16 and the UAV: xdot = f(s, u)
(counterpart of neuralplane_tpu/ops/dynamics.py).

State layout (US units):
    0 npos ft | 1 epos ft | 2 alt ft | 3 roll rad | 4 pitch rad | 5 yaw rad
    6 vt ft/s | 7 alpha rad | 8 beta rad | 9 P rad/s | 10 Q rad/s | 11 R rad/s
Control layout: 0 T lbf | 1 el deg | 2 ail deg | 3 rud deg | 4 lef deg

`nlplant_core` and `sixdof_eom` work on tuples of [n] tensors, with Python
float constants folded exactly as the JAX package folds them (a Python
expression of constants is evaluated in double and meets the tensor as
float32). `csrc/nlplant.cuh` is their device-side twin.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .atmosphere import atmos
from .buildup import B_SPAN, CBAR, coeff_buildup

G = 32.17          # ft/s^2
MASS = 636.94      # slugs
S_AREA = 300.0     # ft^2
HENG = 0.0
JY = 55814.0
JXZ = 982.0
JZ = 63100.0
JX = 9496.0
R2D = 180.0 / math.pi


class AirframeConst(NamedTuple):
    """Mass/geometry/inertia of a rigid airframe (US units: slug, ft)."""
    mass: float
    s_area: float
    b_span: float
    cbar: float
    jx: float
    jy: float
    jz: float
    jxz: float
    heng: float


F16_CONST = AirframeConst(mass=MASS, s_area=S_AREA, b_span=B_SPAN, cbar=CBAR,
                          jx=JX, jy=JY, jz=JZ, jxz=JXZ, heng=HENG)


def sixdof_eom(sv, T, qbar, coeffs, const: AirframeConst = F16_CONST):
    """Navigation + wind-axis force + inertia-coupled moment equations,
    given the total body-axis coefficients (Cx, Cy, Cz, Cl, Cm, Cn).
    Returns the 12 state-derivative tensors."""
    _, _, alt, phi, theta, psi, vt_raw, alpha_r, beta_r, P, Q, R = sv
    Cx_tot, Cy_tot, Cz_tot, Cl_tot, Cm_tot, Cn_tot = coeffs
    vt = torch.clamp(vt_raw, min=0.01)

    sa, ca = torch.sin(alpha_r), torch.cos(alpha_r)
    sb, cb = torch.sin(beta_r), torch.cos(beta_r)
    st, ct, tt = torch.sin(theta), torch.cos(theta), torch.tan(theta)
    sphi, cphi = torch.sin(phi), torch.cos(phi)
    spsi, cpsi = torch.sin(psi), torch.cos(psi)

    U = vt * ca * cb
    V = vt * sb
    W = vt * sa * cb
    npos_dot = (U * (ct * cpsi)
                + V * (sphi * cpsi * st - cphi * spsi)
                + W * (cphi * st * cpsi + sphi * spsi))
    epos_dot = (U * (ct * spsi)
                + V * (sphi * spsi * st + cphi * cpsi)
                + W * (cphi * st * spsi - sphi * cpsi))
    alt_dot = U * st - V * (sphi * ct) - W * (cphi * ct)
    phi_dot = P + tt * (Q * sphi + R * cphi)
    theta_dot = Q * cphi - R * sphi
    psi_dot = (Q * sphi + R * cphi) / ct

    qS_m = qbar * const.s_area / const.mass
    Udot = R * V - Q * W - G * st + qS_m * Cx_tot + T / const.mass
    Vdot = P * W - R * U + G * ct * sphi + qS_m * Cy_tot
    Wdot = Q * U - P * V + G * ct * cphi + qS_m * Cz_tot
    vt_dot = (U * Udot + V * Vdot + W * Wdot) / vt
    alpha_dot = (U * Wdot - W * Udot) / (U * U + W * W)
    beta_dot = (Vdot * vt - V * vt_dot) / (vt * vt * cb)

    jx, jy, jz, jxz, heng = const.jx, const.jy, const.jz, const.jxz, const.heng
    L_tot = Cl_tot * qbar * const.s_area * const.b_span
    M_tot = Cm_tot * qbar * const.s_area * const.cbar
    N_tot = Cn_tot * qbar * const.s_area * const.b_span
    denom = jx * jz - jxz * jxz
    P_dot = (jz * L_tot + jxz * N_tot
             - (jz * (jz - jy) + jxz * jxz) * Q * R
             + jxz * (jx - jy + jz) * P * Q + jxz * Q * heng) / denom
    Q_dot = (M_tot + (jz - jx) * P * R - jxz * (P * P - R * R) - R * heng) / jy
    R_dot = (jx * N_tot + jxz * L_tot
             + (jx * (jx - jy) + jxz * jxz) * P * Q
             - jxz * (jx - jy + jz) * Q * R + jx * Q * heng) / denom

    return [npos_dot, epos_dot, alt_dot, phi_dot, theta_dot, psi_dot,
            vt_dot, alpha_dot, beta_dot, P_dot, Q_dot, R_dot]


def nlplant_core(sv, uv, get_coeff):
    """Everything in nlplant except the surrogate: 12 state tensors, 5
    control tensors, and `get_coeff(name)` -> the AERO_NAMES coefficient
    tensor. Returns the 12 state-derivative tensors."""
    _, _, alt, _, _, _, vt_raw, _, beta_r, P, Q, R = sv
    T, el, ail, rud, lef = uv
    vt = torch.clamp(vt_raw, min=0.01)
    beta_deg = beta_r * R2D

    dail = ail / 21.5
    drud = rud / 30.0
    dlef = 1.0 - lef / 25.0

    _, qbar, _ = atmos(alt, vt)

    inv_2v = 1.0 / (2.0 * vt)
    coeffs = coeff_buildup(
        get_coeff, dlef=dlef, dail=dail, drud=drud, P=P, Q=Q, R=R,
        beta_deg=beta_deg, half_cbar_v=CBAR * inv_2v, half_b_v=B_SPAN * inv_2v)

    return sixdof_eom(sv, T, qbar, coeffs, F16_CONST)


def nlplant_f16(w, s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """F-16 state derivative, s [n,12], u [n,5] -> xdot [n,12], dispatched
    on the aero container (neuralplane_tpu/ops/dynamics.py:160-185): the
    fused 43-net kernel for GroupedAeroWeights, the fused distilled kernel
    for DistilledAeroWeights, and for the stacked AeroWeights the float32
    query followed by nlplant_core in plain tensor ops."""
    from . import aero
    if isinstance(w, aero.GroupedAeroWeights):
        from .aero_grouped_cuda import nlplant_grouped
        return nlplant_grouped(w, s, u)
    if isinstance(w, aero.DistilledAeroWeights):
        from .aero_cuda import nlplant_distilled
        return nlplant_distilled(w, s, u)
    if not isinstance(w, aero.AeroWeights):
        raise TypeError(f"nlplant_f16 got {type(w).__name__}")
    c = aero.aero_coeffs_t(w, s[:, 7] * R2D, s[:, 8] * R2D, u[:, 1])
    xd = nlplant_core(tuple(s[:, i] for i in range(12)),
                      tuple(u[:, i] for i in range(5)),
                      lambda name: c[aero.IDX[name]])
    return torch.stack(xd, dim=1)


# --- UAV (simplified rigid body, SI units; neuralplane_tpu/ops/dynamics.py:188-230) ---
UAV_M = 300.0
UAV_G = 9.81
UAV_IX = UAV_IY = UAV_IZ = 1.0
UAV_IXZ = 0.0
UAV_LBAR = UAV_MM = UAV_NN = 1.0


def nlplant_uav(s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """UAV state derivative. s: [n,12] (SI: m, m/s; body-frame velocities in
    columns 6-8), u: [n,3] body forces (N) -> xdot [n,12] in SI units. The
    body moments are the constants UAV_LBAR, UAV_MM, UAV_NN, as in the
    reference's model."""
    phi, theta, psi = s[:, 3], s[:, 4], s[:, 5]
    U, V, W = s[:, 6], s[:, 7], s[:, 8]
    P, Q, R = s[:, 9], s[:, 10], s[:, 11]
    Fx, Fy, Fz = u[:, 0], u[:, 1], u[:, 2]

    st, ct, tt = torch.sin(theta), torch.cos(theta), torch.tan(theta)
    sphi, cphi = torch.sin(phi), torch.cos(phi)
    spsi, cpsi = torch.sin(psi), torch.cos(psi)

    npos_dot = (U * (ct * cpsi) + V * (sphi * st * cpsi - cphi * spsi)
                + W * (sphi * spsi + cphi * st * cpsi))
    epos_dot = (U * (ct * spsi) + V * (sphi * st * spsi + cphi * cpsi)
                + W * (-sphi * cpsi + cphi * st * spsi))
    alt_dot = U * st - V * (sphi * ct) - W * (cphi * ct)
    phi_dot = P + (R * cphi + Q * sphi) * tt
    theta_dot = Q * cphi - R * sphi
    psi_dot = (R * cphi + Q * sphi) / ct

    U_dot = V * R - W * Q - UAV_G * st + Fx / UAV_M
    V_dot = -U * R + W * P + UAV_G * ct * sphi + Fy / UAV_M
    W_dot = U * Q - V * P + UAV_G * ct * cphi + Fz / UAV_M

    b0 = UAV_LBAR - Q * R * (UAV_IZ - UAV_IY) + P * Q * UAV_IXZ
    b1 = UAV_NN - P * Q * (UAV_IY - UAV_IX) - Q * R * UAV_IXZ
    b2 = UAV_MM - P * R * (UAV_IX - UAV_IZ) - (P * P - R * R) * UAV_IXZ
    denom = UAV_IZ * UAV_IX - UAV_IXZ ** 2
    P_dot = (b0 * UAV_IZ + b1 * UAV_IXZ) / denom
    Q_dot = b2 / UAV_IY
    R_dot = (b0 * UAV_IXZ + b1 * UAV_IX) / denom

    return torch.stack([
        npos_dot, epos_dot, alt_dot, phi_dot, theta_dot, psi_dot,
        U_dot, V_dot, W_dot, P_dot, Q_dot, R_dot,
    ], dim=1)
