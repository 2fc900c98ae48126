"""Total aero-coefficient build-up (counterpart of neuralplane_tpu/ops/buildup.py).

The six body-axis totals (Cx,Cy,Cz force / Cl,Cm,Cn moment) combine the 43
surrogate outputs with rate damping, lef/aileron/rudder increments and the
cg shift (reference `envs/models/F16/F16_dynamics.py:140-213`), over a
generic `get(name) -> tensor` accessor. The CUDA kernels carry the same
arithmetic in `csrc/nlplant.cuh`.
"""
from __future__ import annotations

from typing import Callable, Tuple

# F-16 geometry (Stevens & Lewis; reference F16_dynamics.py:61-74).
B_SPAN = 30.0      # ft
CBAR = 11.32       # ft
XCGR = 0.35
XCG = 0.30


def coeff_buildup(get: Callable[[str], object], *, dlef, dail, drud,
                  P, Q, R, beta_deg, half_cbar_v, half_b_v) -> Tuple:
    """Returns (Cx_tot, Cy_tot, Cz_tot, Cl_tot, Cm_tot, Cn_tot).

    `get(name)` yields the surrogate output vector for AERO_NAMES entry
    `name`; all other arguments are same-shaped vectors. `beta_deg` is
    sideslip in degrees (the delta_Cnbeta/delta_Clbeta terms multiply the
    degree value, matching the reference).
    """
    dXdQ = half_cbar_v * (get("Cxq") + get("delta_Cxq_lef") * dlef)
    Cx_tot = get("Cx") + get("delta_Cx_lef") * dlef + dXdQ * Q
    dZdQ = half_cbar_v * (get("Czq") + get("delta_Cz_lef") * dlef)
    Cz_tot = get("Cz") + get("delta_Cz_lef") * dlef + dZdQ * Q
    dMdQ = half_cbar_v * (get("Cmq") + get("delta_Cmq_lef") * dlef)
    # deep-stall increment delta_Cm_ds is identically zero in the reference
    # (hifi_other_coeffs returns 0), so it is omitted.
    Cm_tot = (get("Cm") * get("eta_el") + Cz_tot * (XCGR - XCG)
              + get("delta_Cm_lef") * dlef + dMdQ * Q + get("delta_Cm"))
    dYdail = get("delta_Cy_a20") + get("delta_Cy_a20_lef") * dlef
    dYdR = half_b_v * (get("Cyr") + get("delta_Cyr_lef") * dlef)
    dYdP = half_b_v * (get("Cyp") + get("delta_Cyp_lef") * dlef)
    Cy_tot = (get("Cy") + get("delta_Cy_lef") * dlef + dYdail * dail
              + get("delta_Cy_r30") * drud + dYdR * R + dYdP * P)
    dNdail = get("delta_Cn_a20") + get("delta_Cn_a20_lef") * dlef
    dNdR = half_b_v * (get("Cnr") + get("delta_Cnr_lef") * dlef)
    dNdP = half_b_v * (get("Cnp") + get("delta_Cnp_lef") * dlef)
    Cn_tot = (get("Cn") + get("delta_Cn_lef") * dlef
              - Cy_tot * (XCGR - XCG) * (CBAR / B_SPAN)
              + dNdail * dail + get("delta_Cn_r30") * drud
              + dNdR * R + dNdP * P + get("delta_Cnbeta") * beta_deg)
    dLdail = get("delta_Cl_a20") + get("delta_Cl_a20_lef") * dlef
    dLdR = half_b_v * (get("Clr") + get("delta_Clr_lef") * dlef)
    dLdP = half_b_v * (get("Clp") + get("delta_Clp_lef") * dlef)
    Cl_tot = (get("Cl") + get("delta_Cl_lef") * dlef + dLdail * dail
              + get("delta_Cl_r30") * drud + dLdR * R + dLdP * P
              + get("delta_Clbeta") * beta_deg)
    return Cx_tot, Cy_tot, Cz_tot, Cl_tot, Cm_tot, Cn_tot
