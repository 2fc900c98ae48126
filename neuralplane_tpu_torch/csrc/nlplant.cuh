// F-16 nlplant as device functions: twin of neuralplane_tpu_torch/ops/
// dynamics.py (nlplant_core, sixdof_eom), ops/buildup.py (coeff_buildup) and
// ops/atmosphere.py (qbar), for one aircraft held in registers.
//
// Constants are folded as the JAX package folds its Python-float
// expressions: a constant sub-expression is evaluated in double and meets
// the float32 operand rounded to float. Built with -fmad=false, so every
// a*b+c rounds twice, as the plain versions do.
#pragma once

namespace np_f16 {

constexpr double G = 32.17, MASS = 636.94, S_AREA = 300.0, HENG = 0.0;
constexpr double JY = 55814.0, JXZ = 982.0, JZ = 63100.0, JX = 9496.0;
constexpr double B_SPAN = 30.0, CBAR = 11.32, XCGR = 0.35, XCG = 0.30;
constexpr double PI_D = 3.141592653589793;
constexpr float R2D = (float)(180.0 / PI_D);
constexpr float RHO0 = 2.377e-3f;

// AERO_NAMES indices (neuralplane_tpu_torch/ops/aero.py).
enum Coef {
  Cx, Cz, Cm, Cy, Cn, Cl,
  Cxq, Cyr, Cyp, Czq, Clr, Clp, Cmq, Cnr, Cnp,
  dCx_lef, dCz_lef, dCm_lef, dCy_lef, dCn_lef, dCl_lef,
  dCxq_lef, dCyr_lef, dCyp_lef, dCzq_lef, dClr_lef, dClp_lef, dCmq_lef,
  dCnr_lef, dCnp_lef,
  dCy_r30, dCn_r30, dCl_r30,
  dCy_a20, dCy_a20_lef, dCn_a20, dCn_a20_lef, dCl_a20, dCl_a20_lef,
  dCnbeta, dClbeta, dCm, eta_el,
  N_COEF
};

// The six body-axis totals (Cx, Cy, Cz, Cl, Cm, Cn) from the 43 raw
// coefficients (ops/buildup.py:coeff_buildup); hc = CBAR / (2 vt),
// hb = B_SPAN / (2 vt).
__device__ __forceinline__ void coeff_buildup(const float c[N_COEF], float dlef, float dail,
                                              float drud, float P, float Q, float R,
                                              float beta_deg, float hc, float hb,
                                              float tot[6]) {
  const float dXdQ = hc * (c[Cxq] + c[dCxq_lef] * dlef);
  const float Cx_tot = c[Cx] + c[dCx_lef] * dlef + dXdQ * Q;
  const float dZdQ = hc * (c[Czq] + c[dCz_lef] * dlef);
  const float Cz_tot = c[Cz] + c[dCz_lef] * dlef + dZdQ * Q;
  const float dMdQ = hc * (c[Cmq] + c[dCmq_lef] * dlef);
  const float Cm_tot = c[Cm] * c[eta_el] + Cz_tot * (float)(XCGR - XCG)
                       + c[dCm_lef] * dlef + dMdQ * Q + c[dCm];
  const float dYdail = c[dCy_a20] + c[dCy_a20_lef] * dlef;
  const float dYdR = hb * (c[Cyr] + c[dCyr_lef] * dlef);
  const float dYdP = hb * (c[Cyp] + c[dCyp_lef] * dlef);
  const float Cy_tot = c[Cy] + c[dCy_lef] * dlef + dYdail * dail
                       + c[dCy_r30] * drud + dYdR * R + dYdP * P;
  const float dNdail = c[dCn_a20] + c[dCn_a20_lef] * dlef;
  const float dNdR = hb * (c[Cnr] + c[dCnr_lef] * dlef);
  const float dNdP = hb * (c[Cnp] + c[dCnp_lef] * dlef);
  const float Cn_tot = c[Cn] + c[dCn_lef] * dlef
                       - Cy_tot * (float)(XCGR - XCG) * (float)(CBAR / B_SPAN)
                       + dNdail * dail + c[dCn_r30] * drud
                       + dNdR * R + dNdP * P + c[dCnbeta] * beta_deg;
  const float dLdail = c[dCl_a20] + c[dCl_a20_lef] * dlef;
  const float dLdR = hb * (c[Clr] + c[dClr_lef] * dlef);
  const float dLdP = hb * (c[Clp] + c[dClp_lef] * dlef);
  const float Cl_tot = c[Cl] + c[dCl_lef] * dlef + dLdail * dail
                       + c[dCl_r30] * drud + dLdR * R + dLdP * P
                       + c[dClbeta] * beta_deg;
  tot[0] = Cx_tot;
  tot[1] = Cy_tot;
  tot[2] = Cz_tot;
  tot[3] = Cl_tot;
  tot[4] = Cm_tot;
  tot[5] = Cn_tot;
}

// s[12] state, u[5] control (T, el, ail, rud, lef), c[43] raw coefficients
// -> xd[12] state derivative.
__device__ __forceinline__ void nlplant_core(const float s[12], const float u[5],
                                             const float c[N_COEF], float xd[12]) {
  const float alt = s[2], phi = s[3], theta = s[4], psi = s[5];
  const float alpha_r = s[7], beta_r = s[8], P = s[9], Q = s[10], R = s[11];
  const float T = u[0], ail = u[2], rud = u[3], lef = u[4];
  const float vt = fmaxf(s[6], 0.01f);
  const float beta_deg = beta_r * R2D;

  const float dail = ail / 21.5f;
  const float drud = rud / 30.0f;
  const float dlef = 1.0f - lef / 25.0f;

  // atmos: qbar only
  const float tfac = 1.0f - 0.703e-5f * alt;
  const float rho = RHO0 * powf(tfac, 4.14f);
  const float qbar = 0.5f * rho * vt * vt;

  const float inv_2v = 1.0f / (2.0f * vt);
  float tot[6];
  coeff_buildup(c, dlef, dail, drud, P, Q, R, beta_deg, (float)CBAR * inv_2v,
                (float)B_SPAN * inv_2v, tot);
  const float Cx_tot = tot[0], Cy_tot = tot[1], Cz_tot = tot[2];
  const float Cl_tot = tot[3], Cm_tot = tot[4], Cn_tot = tot[5];

  // sixdof_eom
  const float sa = sinf(alpha_r), ca = cosf(alpha_r);
  const float sb = sinf(beta_r), cb = cosf(beta_r);
  const float st = sinf(theta), ct = cosf(theta), tt = tanf(theta);
  const float sphi = sinf(phi), cphi = cosf(phi);
  const float spsi = sinf(psi), cpsi = cosf(psi);

  const float U = vt * ca * cb;
  const float V = vt * sb;
  const float W = vt * sa * cb;
  xd[0] = U * (ct * cpsi) + V * (sphi * cpsi * st - cphi * spsi)
          + W * (cphi * st * cpsi + sphi * spsi);
  xd[1] = U * (ct * spsi) + V * (sphi * spsi * st + cphi * cpsi)
          + W * (cphi * st * spsi - sphi * cpsi);
  xd[2] = U * st - V * (sphi * ct) - W * (cphi * ct);
  xd[3] = P + tt * (Q * sphi + R * cphi);
  xd[4] = Q * cphi - R * sphi;
  xd[5] = (Q * sphi + R * cphi) / ct;

  const float qS_m = qbar * (float)S_AREA / (float)MASS;
  const float Udot = R * V - Q * W - (float)G * st + qS_m * Cx_tot + T / (float)MASS;
  const float Vdot = P * W - R * U + (float)G * ct * sphi + qS_m * Cy_tot;
  const float Wdot = Q * U - P * V + (float)G * ct * cphi + qS_m * Cz_tot;
  const float vt_dot = (U * Udot + V * Vdot + W * Wdot) / vt;
  xd[6] = vt_dot;
  xd[7] = (U * Wdot - W * Udot) / (U * U + W * W);
  xd[8] = (Vdot * vt - V * vt_dot) / (vt * vt * cb);

  const float L_tot = Cl_tot * qbar * (float)S_AREA * (float)B_SPAN;
  const float M_tot = Cm_tot * qbar * (float)S_AREA * (float)CBAR;
  const float N_tot = Cn_tot * qbar * (float)S_AREA * (float)B_SPAN;
  const float denom = (float)(JX * JZ - JXZ * JXZ);
  xd[9] = ((float)JZ * L_tot + (float)JXZ * N_tot
           - (float)(JZ * (JZ - JY) + JXZ * JXZ) * Q * R
           + (float)(JXZ * (JX - JY + JZ)) * P * Q + (float)JXZ * Q * (float)HENG)
          / denom;
  xd[10] = (M_tot + (float)(JZ - JX) * P * R - (float)JXZ * (P * P - R * R)
            - R * (float)HENG) / (float)JY;
  xd[11] = ((float)JX * N_tot + (float)JXZ * L_tot
            + (float)(JX * (JX - JY) + JXZ * JXZ) * P * Q
            - (float)(JXZ * (JX - JY + JZ)) * Q * R + (float)JX * Q * (float)HENG)
           / denom;
}

}  // namespace np_f16
