"""One step of the F-16 control tasks (heading, control, tracking) on
[m] rows, in plain PyTorch: the reference the benchmark judges the
program's env step against.

Per aircraft: the done flags of the last step select a reset (altitude
and speed drawn from the configuration's ranges, the task's targets
resampled from them), the actuators lag towards the clipped action, the
aero surrogate gives the 43 coefficients, the F-16 equations of motion
(Stevens and Lewis; the NeuralPlane reference's nlplant) give xdot at the
step's start, one Euler step integrates it, and the task layer gives the
22-slot observation with Gaussian sensor noise, six terminations and the
reward. Python float constants are folded in double and meet the tensors
as float32, as the program's plain versions fold them.

Precision: the configuration states a bf16 surrogate (bf16 operands,
float32 sums, each hidden sum rounded to bf16 and added to the bf16 bias
in bf16) and float32 everywhere else. `surrogate="fp8"` rounds every
operand of the surrogate's products to float8 e4m3 with one scale per
tensor instead: the control that a correct step must be told apart from.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import philox

PI = math.pi
R2D = 180.0 / math.pi
FT = 0.3048
THRUST_NORM = 0.3048 / (0.225 * 76300.0)
THRUST_SCALE = 0.225 * 76300.0 / 0.3048
SURFACE_SCALE = 45.0
# F-16 mass, geometry and inertia (US units: slug, ft)
G = 32.17
MASS = 636.94
S_AREA = 300.0
B_SPAN = 30.0
CBAR = 11.32
XCGR, XCG = 0.35, 0.30
JX, JY, JZ, JXZ, HENG = 9496.0, 55814.0, 63100.0, 982.0, 0.0
RHO0 = 2.377e-3
GAMMA_R = 1.4 * 1716.3

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

# the distilled trunk's hinge features (its npz states the same knots)
ALPHA_KNOTS = np.linspace(-20.0, 90.0, 45, dtype=np.float32)[1:-1]
BETA_KNOTS = np.linspace(-30.0, 30.0, 17, dtype=np.float32)[1:-1]
EL_KNOTS = np.linspace(-25.0, 25.0, 9, dtype=np.float32)[1:-1]
IN_SCALE = np.array([35.0, 18.0, 15.0], np.float32)
IN_MEAN = np.array([35.0, 0.0, 0.0], np.float32)

COND_NAMES = ("overload", "low_altitude", "high_speed", "low_speed",
              "extreme_state", "unreach")


# ------------------------------------------------------------ rounding

def to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale per tensor (amax to 448)."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def operand_round(precision: str):
    if precision == "bf16":
        return to_bf16
    if precision == "fp8":
        return lambda x: to_fp8(to_bf16(x))
    raise ValueError(f"surrogate precision must be bf16 or fp8, got {precision!r}")


# ------------------------------------------------------------- weights

def load_surrogate(kind: str, path: str, device) -> Dict[str, torch.Tensor]:
    """The surrogate's leaves from its raw npz, float32 on `device`:
    "distilled" W1 [H, F], b1, W2 [H, H], b2, W3 [43+, H + F], b3, out_mean,
    out_std; "nets43" W1 [43, 3, 20], b1, W2 [43, 20, 20], b2, W3 [43, 20,
    10], b3, W4 [43, 10], b4."""
    leaves = {"distilled": ("W1", "b1", "W2", "b2", "W3", "b3", "out_mean", "out_std"),
              "nets43": ("W1", "b1", "W2", "b2", "W3", "b3", "W4", "b4")}[kind]
    with np.load(path) as z:
        if tuple(str(n) for n in z["names"]) != AERO_NAMES:
            raise ValueError(f"{path}: coefficient order differs from the reference's")
        if kind == "distilled":
            for key, want in (("alpha_knots", ALPHA_KNOTS), ("beta_knots", BETA_KNOTS),
                              ("el_knots", EL_KNOTS), ("in_scale", IN_SCALE),
                              ("in_mean", IN_MEAN)):
                if not np.allclose(z[key], want):
                    raise ValueError(f"{path}: {key} differs from the reference's")
        return {k: torch.from_numpy(np.asarray(z[k]).astype(np.float32)).to(device)
                for k in leaves}


def _mm(a: torch.Tensor, b: torch.Tensor, rnd) -> torch.Tensor:
    return torch.matmul(rnd(a), rnd(b))


def distilled_coeffs(w, alpha_deg, beta_deg, el, precision: str) -> torch.Tensor:
    """[43, m] raw coefficients of the distilled trunk: 68 hinge features ->
    relu -> relu, readout over [hidden ; features], z * std + mean."""
    rnd = operand_round(precision)
    bf = torch.bfloat16
    cols = [(alpha_deg - float(IN_MEAN[0])) / float(IN_SCALE[0]),
            beta_deg / float(IN_SCALE[1]), el / float(IN_SCALE[2])]
    cols += [torch.relu(alpha_deg - float(k)) / float(IN_SCALE[0]) for k in ALPHA_KNOTS]
    cols += [torch.relu(beta_deg - float(k)) / float(IN_SCALE[1]) for k in BETA_KNOTS]
    cols += [torch.relu(el - float(k)) / float(IN_SCALE[2]) for k in EL_KNOTS]
    f = to_bf16(torch.stack(cols, dim=1))                       # [m, F]
    h = torch.relu(_mm(f, w["W1"].T, rnd).to(bf) + w["b1"].to(bf)).float()
    h = torch.relu(_mm(h, w["W2"].T, rnd).to(bf) + w["b2"].to(bf)).float()
    z = _mm(torch.cat([h, f], dim=1), w["W3"].T, rnd) + w["b3"]
    return (z * w["out_std"] + w["out_mean"]).T[:len(AERO_NAMES)]


def nets43_coeffs(w, alpha_deg, beta_deg, el, precision: str,
                  chunk: int = 65536) -> torch.Tensor:
    """[43, m] raw coefficients of the 43 nets [3 -> 20 -> 20 -> 10 -> 1]
    on raw degrees, one net per coefficient."""
    rnd = operand_round(precision)
    bf = torch.bfloat16
    k = w["W1"].shape[0]
    x = torch.stack([alpha_deg, beta_deg, el], dim=1)
    out = []
    for xc in x.split(chunk):
        h = xc.unsqueeze(0).expand(k, -1, -1)
        for W, b in ((w["W1"], w["b1"]), (w["W2"], w["b2"]), (w["W3"], w["b3"])):
            h = torch.relu(torch.bmm(rnd(h), rnd(W)).to(bf) + b.to(bf)[:, None, :]).float()
        out.append(torch.bmm(rnd(h), rnd(w["W4"])[:, :, None])[:, :, 0] + w["b4"][:, None])
    return torch.cat(out, dim=1)


# ------------------------------------------------------------ dynamics

def wrap_PI(angle: torch.Tensor) -> torch.Tensor:
    res = torch.remainder(angle, 2.0 * PI)
    res = torch.where(res < 0.0, res + 2.0 * PI, res)
    return torch.where(res > PI, res - 2.0 * PI, res)


def nlplant(s, u, get):
    """xdot (12 rows) from 12 state rows, 5 control rows and the surrogate's
    coefficients `get(name)`: atmosphere, coefficient build-up, six-DOF
    equations of motion."""
    _, _, alt, phi, theta, psi, vt_raw, alpha_r, beta_r, P, Q, R = s
    T, _, ail, rud, lef = u
    vt = torch.clamp(vt_raw, min=0.01)
    beta_deg = beta_r * R2D
    dail, drud, dlef = ail / 21.5, rud / 30.0, 1.0 - lef / 25.0
    tfac = 1.0 - 0.703e-5 * alt
    rho = RHO0 * torch.pow(tfac, 4.14)
    qbar = 0.5 * rho * vt * vt
    inv_2v = 1.0 / (2.0 * vt)
    hc, hb = CBAR * inv_2v, B_SPAN * inv_2v

    Cx = (get("Cx") + get("delta_Cx_lef") * dlef
          + hc * (get("Cxq") + get("delta_Cxq_lef") * dlef) * Q)
    # the NeuralPlane model's pitch-rate term of Cz adds delta_Cz_lef (not
    # delta_Czq_lef, which enters no total)
    Cz = (get("Cz") + get("delta_Cz_lef") * dlef
          + hc * (get("Czq") + get("delta_Cz_lef") * dlef) * Q)
    Cm = (get("Cm") * get("eta_el") + Cz * (XCGR - XCG) + get("delta_Cm_lef") * dlef
          + hc * (get("Cmq") + get("delta_Cmq_lef") * dlef) * Q + get("delta_Cm"))
    Cy = (get("Cy") + get("delta_Cy_lef") * dlef
          + (get("delta_Cy_a20") + get("delta_Cy_a20_lef") * dlef) * dail
          + get("delta_Cy_r30") * drud + hb * (get("Cyr") + get("delta_Cyr_lef") * dlef) * R
          + hb * (get("Cyp") + get("delta_Cyp_lef") * dlef) * P)
    Cn = (get("Cn") + get("delta_Cn_lef") * dlef - Cy * (XCGR - XCG) * (CBAR / B_SPAN)
          + (get("delta_Cn_a20") + get("delta_Cn_a20_lef") * dlef) * dail
          + get("delta_Cn_r30") * drud + hb * (get("Cnr") + get("delta_Cnr_lef") * dlef) * R
          + hb * (get("Cnp") + get("delta_Cnp_lef") * dlef) * P
          + get("delta_Cnbeta") * beta_deg)
    Cl = (get("Cl") + get("delta_Cl_lef") * dlef
          + (get("delta_Cl_a20") + get("delta_Cl_a20_lef") * dlef) * dail
          + get("delta_Cl_r30") * drud + hb * (get("Clr") + get("delta_Clr_lef") * dlef) * R
          + hb * (get("Clp") + get("delta_Clp_lef") * dlef) * P
          + get("delta_Clbeta") * beta_deg)

    sa, ca = torch.sin(alpha_r), torch.cos(alpha_r)
    sb, cb = torch.sin(beta_r), torch.cos(beta_r)
    st, ct, tt = torch.sin(theta), torch.cos(theta), torch.tan(theta)
    sphi, cphi = torch.sin(phi), torch.cos(phi)
    spsi, cpsi = torch.sin(psi), torch.cos(psi)
    U, V, W = vt * ca * cb, vt * sb, vt * sa * cb
    npos_dot = (U * (ct * cpsi) + V * (sphi * cpsi * st - cphi * spsi)
                + W * (cphi * st * cpsi + sphi * spsi))
    epos_dot = (U * (ct * spsi) + V * (sphi * spsi * st + cphi * cpsi)
                + W * (cphi * st * spsi - sphi * cpsi))
    alt_dot = U * st - V * (sphi * ct) - W * (cphi * ct)
    phi_dot = P + tt * (Q * sphi + R * cphi)
    theta_dot = Q * cphi - R * sphi
    psi_dot = (Q * sphi + R * cphi) / ct
    qS_m = qbar * S_AREA / MASS
    Udot = R * V - Q * W - G * st + qS_m * Cx + T / MASS
    Vdot = P * W - R * U + G * ct * sphi + qS_m * Cy
    Wdot = Q * U - P * V + G * ct * cphi + qS_m * Cz
    vt_dot = (U * Udot + V * Vdot + W * Wdot) / vt
    alpha_dot = (U * Wdot - W * Udot) / (U * U + W * W)
    beta_dot = (Vdot * vt - V * vt_dot) / (vt * vt * cb)
    L = Cl * qbar * S_AREA * B_SPAN
    M = Cm * qbar * S_AREA * CBAR
    N = Cn * qbar * S_AREA * B_SPAN
    den = JX * JZ - JXZ * JXZ
    P_dot = (JZ * L + JXZ * N - (JZ * (JZ - JY) + JXZ * JXZ) * Q * R
             + JXZ * (JX - JY + JZ) * P * Q + JXZ * Q * HENG) / den
    Q_dot = (M + (JZ - JX) * P * R - JXZ * (P * P - R * R) - R * HENG) / JY
    R_dot = (JX * N + JXZ * L + (JX * (JX - JY) + JXZ * JXZ) * P * Q
             - JXZ * (JX - JY + JZ) * Q * R + JX * Q * HENG) / den
    return [npos_dot, epos_dot, alt_dot, phi_dot, theta_dot, psi_dot,
            vt_dot, alpha_dot, beta_dot, P_dot, Q_dot, R_dot]


# ---------------------------------------------------------------- task

def new_targets(task: str, sc: dict, du, alt0, vt0):
    """A reset row's targets from its init draws and the uniforms du[2:5]."""
    if task == "heading":
        if sc.get("heading_random_increments", False):
            d_hdg = (du[2] - 0.5) * 2.0 * float(sc["max_heading_increment"])
            d_alt = (du[3] - 0.5) * 2.0 * float(sc["max_altitude_increment"])
            d_vt = (du[4] - 0.5) * 2.0 * float(sc["max_velocities_u_increment"])
        else:   # the NeuralPlane reference's fixed increments
            d_hdg, d_alt, d_vt = 2.0 * math.pi / 3.0, 1000.0, 0.0
        return (alt0 + d_alt, wrap_PI(torch.zeros_like(alt0) + d_hdg), vt0 + d_vt)
    if task == "control":
        d_pitch = (du[2] - 0.5) * 2.0 * float(sc["max_pitch_increment"])
        d_hdg = (du[3] - 0.5) * 2.0 * float(sc["max_heading_increment"])
        d_vt = (du[4] - 0.5) * 2.0 * float(sc["max_velocities_u_increment"])
        return (wrap_PI(d_pitch), wrap_PI(d_hdg), vt0 + d_vt)
    if task == "tracking":
        lo, hi = float(sc["min_distance"]), float(sc["max_distance"])
        dist = du[2] * (hi - lo) + lo
        th1 = du[3] * (math.pi / 3.0) - math.pi / 6.0
        th2 = du[4] * (math.pi / 3.0) - math.pi / 6.0
        return (dist * torch.cos(th1) * torch.cos(th2),
                dist * torch.cos(th1) * torch.sin(th2), alt0 + dist * torch.sin(th1))
    raise ValueError(f"unknown task {task!r}")


def task_layer(task: str, sc: dict, s, u, xd, tg, step_count):
    """Observation rows (22), done, bad, reward and the six conditions at
    the post-step state s with the step-start derivative xd."""
    npos, epos, alt, roll, pitch, hdg, vt, alpha, beta, P, Q, R = s
    T, el, ail, rud, lef = u
    t0, t1, t2 = tg
    if task == "heading":
        head = [(alt - t0) * FT / 1000.0, wrap_PI(hdg - t1), (vt - t2) * FT / 340.0]
    elif task == "control":
        head = [wrap_PI(pitch - t0), wrap_PI(hdg - t1), (vt - t2) * FT / 340.0]
    else:
        head = [(npos - t0) * FT / 1000.0, (epos - t1) * FT / 1000.0,
                (alt - t2) * FT / 1000.0]
    tfac = 1.0 - 0.703e-5 * alt
    eas2tas = torch.sqrt(1.0 / torch.pow(tfac, 4.14))
    TAS = vt + float(sc["airspeed"])
    EAS = TAS / eas2tas
    sin_a, cos_a = torch.sin(alpha), torch.cos(alpha)
    sin_b, cos_b = torch.sin(beta), torch.cos(beta)
    obs = head + [alt * FT / 5000.0, torch.sin(roll), torch.cos(roll),
                  torch.sin(pitch), torch.cos(pitch), EAS * FT / 340.0,
                  sin_a, cos_a, sin_b, cos_b, P, Q, R, T * THRUST_NORM,
                  el / 45.0, ail / 45.0, rud / 45.0, lef / 45.0, eas2tas]

    vel_u, vel_v, vel_w = vt * cos_b * cos_a, vt * sin_b, vt * cos_b * sin_a
    vt_d, al_d, be_d = xd[6], xd[7], xd[8]
    u_dot = cos_b * cos_a * vt_d - vt * sin_b * cos_a * be_d - vt * cos_b * sin_a * al_d
    v_dot = sin_b * vt_d + vt * cos_b * be_d
    w_dot = cos_b * sin_a * vt_d - vt * sin_b * sin_a * be_d + vt * cos_b * cos_a * al_d
    ax = u_dot + Q * vel_w - R * vel_v
    ay = v_dot + R * vel_u - P * vel_w
    az = w_dot + P * vel_v - Q * vel_u
    acc = torch.sqrt(ax * ax + ay * ay + az * az)
    mach = TAS * FT / 340.0
    alpha_deg, beta_deg = alpha * R2D, beta * R2D
    c_overload = acc > float(sc["acceleration_limit"])
    c_low_alt = alt < float(sc["altitude_limit"])
    c_high = mach >= float(sc["max_velocity"])
    c_low = mach <= float(sc["min_velocity"])
    c_extreme = ((alpha_deg < float(sc["min_alpha"])) | (alpha_deg > float(sc["max_alpha"]))
                 | (beta_deg < float(sc["min_beta"])) | (beta_deg > float(sc["max_beta"])))
    over_max = step_count >= int(sc["max_check_interval"])
    if task == "heading":
        off = ((torch.abs(wrap_PI(hdg - t1)) >= PI / 36.0) | (torch.abs(alt - t0) >= 100.0)
               | (torch.abs(vt - t2) >= 20.0))
        goal = (~off) & (~over_max) & (step_count >= int(sc["min_check_interval"]))
        d = ((alt - t0) * FT / 1000.0, wrap_PI(hdg - t1) / PI, (vt - t2) * FT / 340.0)
        base = -(d[0] * d[0]) - (d[1] * d[1]) - (d[2] * d[2])
    elif task == "control":
        off = ((torch.abs(wrap_PI(hdg - t1)) >= PI / 36.0)
               | (torch.abs(wrap_PI(pitch - t0)) >= PI / 36.0) | (torch.abs(vt - t2) >= 20.0))
        goal = (~off) & (~over_max)
        d = (wrap_PI(pitch - t0) / PI, wrap_PI(hdg - t1) / PI, (vt - t2) * FT / 340.0)
        base = -(d[0] * d[0]) - (d[1] * d[1]) - (d[2] * d[2])
    else:
        off = ((torch.abs(npos - t0) >= 100.0) | (torch.abs(epos - t1) >= 100.0)
               | (torch.abs(alt - t2) >= 100.0))
        goal = (~off) & (~over_max)
        d = ((npos - t0) * FT / 1000.0, (epos - t1) * FT / 1000.0, (alt - t2) * FT / 1000.0)
        base = 0.1 * (-(d[0] * d[0]) - (d[1] * d[1]) - (d[2] * d[2]))
    unreach_bad = over_max & off
    bad = c_overload | c_low_alt | c_high | c_low | c_extreme | unreach_bad
    done = goal
    reward = base + 200.0 * done.float() - 200.0 * bad.float()
    conds = [c_overload, c_low_alt, c_high, c_low, c_extreme, unreach_bad | goal]
    return obs, done, bad, reward, conds


# --------------------------------------------------------------- draws

N_DRAW_ROWS = 8      # reset uniforms per aircraft: alt, vt, three targets, three unused


def draws(gen_state: torch.Tensor, device, n: int, rows: torch.Tensor,
          noise_scale: float):
    """The step's random draws of the aircraft `rows` of n, rebuilt from the
    state of the env's generator before the step: (du [8, m], noise [m, 22]).

    The step first draws two int32 seed words from the generator. On the
    card the step kernel keys Philox with them: counter blocks 0-1 give the
    reset uniforms, blocks 2-4 the Box-Muller radii and 5-7 the angles of
    observation slots k and 12 + k. On the CPU the program draws from the
    generator itself: 8 x n uniforms, then n x 22 normals."""
    g = torch.Generator(device=device)
    g.set_state(gen_state)
    words = torch.randint(0, 2 ** 31 - 1, (2,), generator=g, device=device,
                          dtype=torch.int32)
    if torch.device(device).type == "cuda":
        seed = tuple(int(v) for v in words.cpu())
        du = torch.from_numpy(philox.uniforms(seed, rows.cpu().numpy(), range(8))).to(device)
        rad = du[8:20].clamp_min(1e-7).log().mul(-2.0).sqrt()
        th = (2.0 * math.pi) * du[20:32]
        noise = torch.cat([rad * torch.cos(th), rad * torch.sin(th)])[:22].T * noise_scale
        return du[:N_DRAW_ROWS], noise
    du = torch.rand((N_DRAW_ROWS, n), generator=g, device=device)
    noise = torch.randn((n, 22), generator=g, device=device) * noise_scale
    return du[:, rows], noise[rows]


# ---------------------------------------------------------------- step

def step(task: str, sc: dict, kind: str, w, x: Dict[str, torch.Tensor],
         du: torch.Tensor, noise: torch.Tensor, precision: str = "bf16"
         ) -> Dict[str, torch.Tensor]:
    """One step of the rows in `x`: sf [12, m], uf [5, m] (feature-major,
    before the reset), action [m, A], tg0..tg2 [m] (before the resample),
    step_count [m] int32, is_done, bad_done, exceed [m] bool.

    Returns sf, uf (the new state), ds, du_ (the state's and the controls'
    change over the step, from the post-reset state), tg0..tg2,
    step_count, obs [m, 22], reward, done, bad, conds [6, m]."""
    mask = x["is_done"] | x["bad_done"] | x["exceed"]
    lo_alt, lo_vt = float(sc["min_altitude"]), float(sc["min_vt"])
    alt0 = lo_alt + du[0] * (float(sc["max_altitude"]) - lo_alt)
    vt0 = lo_vt + du[1] * (float(sc["max_vt"]) - lo_vt)
    t_new = new_targets(task, sc, du, alt0, vt0)
    tg = [torch.where(mask, t_new[i], x[f"tg{i}"]) for i in range(3)]
    step_count = torch.where(mask, 0, x["step_count"]) + 1
    s = [torch.where(mask, alt0 if i == 2 else vt0 if i == 6 else 0.0, x["sf"][i])
         for i in range(12)]
    init_T = float(sc["init_state"]["init_T"])
    a = x["action"]
    if a.shape[1] < 4:   # narrower action spaces are zero-padded
        a = torch.cat([a, a.new_zeros((a.shape[0], 4 - a.shape[1]))], dim=1)
    scales = (THRUST_SCALE, SURFACE_SCALE, SURFACE_SCALE, SURFACE_SCALE)
    u_prev = [torch.where(mask, init_T if i == 0 else 0.0, x["uf"][i]) for i in range(4)]
    u = [0.9 * u_prev[i] + 0.1 * torch.clamp(a[:, i], -1.0, 1.0) * scales[i]
         for i in range(4)]
    u.append(torch.zeros_like(u[0]))
    surrogate = distilled_coeffs if kind == "distilled" else nets43_coeffs
    c = surrogate(w, s[7] * R2D, s[8] * R2D, u[1], precision)
    xd = nlplant(s, u, lambda name: c[IDX[name]])
    dt = float(sc["dt"])
    s_new = [s[i] + dt * xd[i] for i in range(12)]
    obs, done, bad, reward, conds = task_layer(task, sc, s_new, u, xd, tg, step_count)
    obs = torch.stack(obs, dim=1) + noise
    sf = torch.stack(s_new)
    uf = torch.stack(u)
    return {"sf": sf, "uf": uf, "ds": sf - torch.stack(s),
            "du": uf - torch.stack(u_prev + [torch.zeros_like(u[0])]),
            "tg0": tg[0], "tg1": tg[1], "tg2": tg[2], "step_count": step_count,
            "obs": obs, "reward": reward, "done": done, "bad": bad,
            "conds": torch.stack(conds)}


def step_rows(task: str, sc: dict, kind: str, w, x: Dict[str, torch.Tensor],
              gen_state: torch.Tensor, n: int, rows: torch.Tensor,
              precision: str = "bf16", block: int = 1 << 18
              ) -> Dict[str, torch.Tensor]:
    """`step` of the sampled `rows` of n, in blocks of rows so that it fits
    beside nothing else; the draws are rebuilt for those rows."""
    device = x["sf"].device
    du, noise = draws(gen_state, device, n, rows, float(sc["noise_scale"]))
    m = rows.numel()
    parts = []
    for lo in range(0, m, block):
        sl = slice(lo, min(m, lo + block))
        xb = {k: (v[:, sl] if k in ("sf", "uf") else v[sl]) for k, v in x.items()}
        parts.append(step(task, sc, kind, w, xb, du[:, sl], noise[sl], precision))
    if len(parts) == 1:
        return parts[0]
    feat_major = ("sf", "uf", "ds", "du", "conds")
    return {k: torch.cat([p[k] for p in parts], dim=1 if k in feat_major else 0)
            for k in parts[0]}

