"""Whole env step: the Hopper kernels and their plain version (counterpart
of neuralplane_tpu/ops/step_pallas.py, distilled and grouped mode).

One step, per aircraft: masked reset select (optionally with the init draws
and the target resample drawn in the kernel), actuator lag, aero surrogate
(the distilled trunk for DistilledAeroWeights, the 43-net ensemble for
GroupedAeroWeights), nlplant, Euler, and the task layer (22-slot observation
with optional sensor noise, six terminations, reward, per-condition counts).
The two modes share the draws, the noise, the counts and the outputs.

`env_step(...)` launches `csrc/env_step.cu` on CUDA tensors and runs
`env_step_plain` on CPU tensors; nothing else.

Layouts: the state and control are feature-major, sf [12, n] and uf [5, n]
(the TPU's sublane padding to 16/8 rows is dropped); the action is [n, 4]
(narrower action spaces are zero-padded by the caller); the observation
comes back [n, 22].
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import cuda_build
from .aero import IDX, DistilledAeroWeights, GroupedAeroWeights
from .aero_cuda import distilled_coeff_rows, distilled_feature_rows
from .aero_grouped_cuda import grouped_coeff_rows
from .dynamics import R2D, nlplant_core
from .task import N_CND, N_OBS, VARIANTS, task_consts, task_rows
from ..utils.math import wrap_PI

THRUST_SCALE = 0.225 * 76300.0 / 0.3048
SURFACE_SCALE = 45.0
N_S, N_U, N_ACT = 12, 5, 4
N_DRAWS = 8          # uniforms per aircraft for the reset: alt, vt, 3 targets, 3 spare


def reset_consts(cfg, variant: str) -> dict:
    """Config scalars for the in-kernel init draws and target resample
    (step_pallas.py:83-104)."""
    rc = {
        "min_alt": float(cfg.min_altitude), "max_alt": float(cfg.max_altitude),
        "min_vt": float(cfg.min_vt), "max_vt": float(cfg.max_vt),
    }
    if variant == "heading":
        rc["random_inc"] = bool(cfg.heading_random_increments)
        rc["max_hdg_inc"] = float(cfg.max_heading_increment)
        rc["max_alt_inc"] = float(cfg.max_altitude_increment)
        rc["max_vu_inc"] = float(cfg.max_velocities_u_increment)
    elif variant == "control":
        rc["max_pitch_inc"] = float(cfg.max_pitch_increment)
        rc["max_hdg_inc"] = float(cfg.max_heading_increment)
        rc["max_vu_inc"] = float(cfg.max_velocities_u_increment)
    elif variant == "tracking":
        rc["min_dist"] = float(cfg.min_distance)
        rc["max_dist"] = float(cfg.max_distance)
    return rc


def _resample_targets(variant: str, rc: dict, du, alt_init, vt_init):
    """Post-reset targets from the uniform rows du[2:5]
    (step_pallas.py:107-133)."""
    if variant == "heading":
        if rc["random_inc"]:
            d_hdg = (du[2] - 0.5) * 2.0 * rc["max_hdg_inc"]
            d_alt = (du[3] - 0.5) * 2.0 * rc["max_alt_inc"]
            d_vt = (du[4] - 0.5) * 2.0 * rc["max_vu_inc"]
        else:  # reference fixed increments (heading_task.py:60-69)
            d_hdg = 2.0 * math.pi / 3.0
            d_alt = 1000.0
            d_vt = 0.0
        return (alt_init + d_alt, wrap_PI(torch.zeros_like(alt_init) + d_hdg),
                vt_init + d_vt)
    if variant == "control":
        d_pitch = (du[2] - 0.5) * 2.0 * rc["max_pitch_inc"]
        d_hdg = (du[3] - 0.5) * 2.0 * rc["max_hdg_inc"]
        d_vt = (du[4] - 0.5) * 2.0 * rc["max_vu_inc"]
        return (wrap_PI(d_pitch), wrap_PI(d_hdg), vt_init + d_vt)
    dist = du[2] * (rc["max_dist"] - rc["min_dist"]) + rc["min_dist"]
    th1 = du[3] * (math.pi / 3.0) - math.pi / 6.0
    th2 = du[4] * (math.pi / 3.0) - math.pi / 6.0
    return (dist * torch.cos(th1) * torch.cos(th2),
            dist * torch.cos(th1) * torch.sin(th2),
            alt_init + dist * torch.sin(th1))


def _check_weights(w) -> bool:
    """True for the grouped (43-net) container, False for the distilled one."""
    if isinstance(w, GroupedAeroWeights):
        return True
    if isinstance(w, DistilledAeroWeights):
        return False
    raise TypeError(f"the step kernel takes DistilledAeroWeights or "
                    f"GroupedAeroWeights, got {type(w).__name__}")


def env_step_plain(variant: str, cfg, w,
                   sf: torch.Tensor, uf: torch.Tensor, action4: torch.Tensor,
                   reset_mask: torch.Tensor, alt_init: Optional[torch.Tensor],
                   vt_init: Optional[torch.Tensor], targets: Tuple,
                   step_count: torch.Tensor, hidden_bf16: bool = True,
                   noise_scale: float = 0.0, reset_draws: bool = False,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> Tuple:
    """Plain PyTorch twin of the step kernel.

    Draws come either explicitly (alt_init/vt_init, POST-resample targets,
    and `noise` [n, 22] added as it is) or, with `reset_draws` and/or
    `noise_scale > 0`, from `generator` (alt_init/vt_init ignored, targets
    PRE-resample, and the post-resample targets appended to the result).
    Returns (sf' [12,n], uf' [5,n], obs [n,22], done bool[n], bad bool[n],
    reward f32[n], counts int32[6]) [+ (t0, t1, t2)]."""
    n = sf.shape[1]
    m = reset_mask.bool()
    tr = tuple(targets)
    if reset_draws:
        if generator is None:
            raise ValueError("reset_draws on the plain path needs a generator")
        rc = reset_consts(cfg, variant)
        du = torch.rand((N_DRAWS, n), generator=generator, device=sf.device)
        alt_init = rc["min_alt"] + du[0] * (rc["max_alt"] - rc["min_alt"])
        vt_init = rc["min_vt"] + du[1] * (rc["max_vt"] - rc["min_vt"])
        t_new = _resample_targets(variant, rc, du, alt_init, vt_init)
        tr = tuple(torch.where(m, t_new[i], tr[i]) for i in range(3))

    # 1. masked reset select
    s_rows = []
    for i in range(N_S):
        init = alt_init if i == 2 else vt_init if i == 6 else 0.0
        s_rows.append(torch.where(m, init, sf[i]))
    # 2. actuator lag on the post-reset control
    init_T = float(cfg.init_state.init_T)
    u_prev = [torch.where(m, init_T, uf[0])] + \
        [torch.where(m, 0.0, uf[i]) for i in (1, 2, 3)]
    scales = (THRUST_SCALE, SURFACE_SCALE, SURFACE_SCALE, SURFACE_SCALE)
    u_rows = [0.9 * u_prev[i]
              + 0.1 * torch.clamp(action4[:, i], -1.0, 1.0) * scales[i]
              for i in range(N_ACT)]
    u_rows.append(torch.zeros_like(u_rows[0]))
    # 3. xdot at (post-reset s, lagged u)
    if _check_weights(w):
        c = grouped_coeff_rows(w, s_rows[7] * R2D, s_rows[8] * R2D, u_rows[1],
                               hidden_bf16)
    else:
        ft = distilled_feature_rows(s_rows[7] * R2D, s_rows[8] * R2D, u_rows[1])
        c = distilled_coeff_rows(ft, w, hidden_bf16)
    xd = nlplant_core(tuple(s_rows), tuple(u_rows), lambda nm: c[IDX[nm]])
    # 4. Euler
    dt = float(cfg.dt)
    s_new = [s_rows[i] + dt * xd[i] for i in range(N_S)]
    # 5. task layer at the post-step state with the step-start xdot
    obs_rows, done, bad, reward, conds = task_rows(
        variant, task_consts(cfg), s_new, u_rows, xd, tr, step_count)
    obs = torch.stack(obs_rows, dim=1)
    if noise is not None:
        obs = obs + noise
    elif noise_scale > 0.0:
        if generator is None:
            raise ValueError("noise_scale > 0 on the plain path needs a generator")
        obs = obs + torch.randn((n, N_OBS), generator=generator,
                                device=sf.device) * noise_scale
    counts = torch.stack([cd.sum() for cd in conds]).to(torch.int32)
    out = (torch.stack(s_new), torch.stack(u_rows), obs, done, bad, reward,
           counts)
    return out + tr if reset_draws else out


class StepParams(ctypes.Structure):
    """Scalars of one step launch; must match `struct StepParams` in
    csrc/env_step.cu field for field. Spans are folded in double, as the
    JAX package's Python-float expressions are."""
    _fields_ = [
        ("n", ctypes.c_int), ("variant", ctypes.c_int),
        ("reset_draws", ctypes.c_int), ("hidden_bf16", ctypes.c_int),
        ("H", ctypes.c_int), ("max_check", ctypes.c_int),
        ("min_check", ctypes.c_int), ("random_inc", ctypes.c_int),
        ("noise_scale", ctypes.c_float), ("dt", ctypes.c_float),
        ("init_T", ctypes.c_float),
        ("airspeed", ctypes.c_float), ("acc_limit", ctypes.c_float),
        ("alt_limit", ctypes.c_float), ("max_mach", ctypes.c_float),
        ("min_mach", ctypes.c_float), ("min_alpha", ctypes.c_float),
        ("max_alpha", ctypes.c_float), ("min_beta", ctypes.c_float),
        ("max_beta", ctypes.c_float),
        ("min_alt", ctypes.c_float), ("alt_span", ctypes.c_float),
        ("min_vt", ctypes.c_float), ("vt_span", ctypes.c_float),
        ("max_hdg_inc", ctypes.c_float), ("max_alt_inc", ctypes.c_float),
        ("max_vu_inc", ctypes.c_float), ("max_pitch_inc", ctypes.c_float),
        ("min_dist", ctypes.c_float), ("dist_span", ctypes.c_float),
    ]


def step_params(variant: str, cfg, n: int, H: int, hidden_bf16: bool,
                noise_scale: float, reset_draws: bool) -> StepParams:
    tc = task_consts(cfg)
    rc = reset_consts(cfg, variant)
    return StepParams(
        n=n, variant=VARIANTS.index(variant), reset_draws=int(reset_draws),
        hidden_bf16=int(hidden_bf16), H=H, max_check=tc["max_check"],
        min_check=tc["min_check"], random_inc=int(rc.get("random_inc", False)),
        noise_scale=noise_scale, dt=float(cfg.dt),
        init_T=float(cfg.init_state.init_T),
        airspeed=tc["airspeed"], acc_limit=tc["acc_limit"],
        alt_limit=tc["alt_limit"], max_mach=tc["max_mach"],
        min_mach=tc["min_mach"], min_alpha=tc["min_alpha"],
        max_alpha=tc["max_alpha"], min_beta=tc["min_beta"],
        max_beta=tc["max_beta"],
        min_alt=rc["min_alt"], alt_span=rc["max_alt"] - rc["min_alt"],
        min_vt=rc["min_vt"], vt_span=rc["max_vt"] - rc["min_vt"],
        max_hdg_inc=rc.get("max_hdg_inc", 0.0),
        max_alt_inc=rc.get("max_alt_inc", 0.0),
        max_vu_inc=rc.get("max_vu_inc", 0.0),
        max_pitch_inc=rc.get("max_pitch_inc", 0.0),
        min_dist=rc.get("min_dist", 0.0),
        dist_span=rc.get("max_dist", 0.0) - rc.get("min_dist", 0.0))


_P = ctypes.c_void_p
# sf uf act mask alt vt tg0 tg1 tg2 sc seed | weights | params |
# sf' uf' obs done bad reward counts tg0' tg1' tg2' | stream; the weights
# are the distilled image, or (frags, vec) of the 43 nets
ENV_STEP_ARGTYPES = [_P] * 11 + [_P] + [StepParams] + [_P] * 10 + [_P]
ENV_STEP_GROUPED_ARGTYPES = [_P] * 11 + [_P] * 2 + [StepParams] + [_P] * 10 + [_P]


def _lib():
    lib = cuda_build.load("env_step")
    if not getattr(lib, "_np_typed", False):
        lib.np_env_step.argtypes = ENV_STEP_ARGTYPES
        lib.np_env_step.restype = ctypes.c_int
        lib.np_env_step_grouped.argtypes = ENV_STEP_GROUPED_ARGTYPES
        lib.np_env_step_grouped.restype = ctypes.c_int
        lib._np_typed = True
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def env_step(variant: str, cfg, w, sf: torch.Tensor,
             uf: torch.Tensor, action4: torch.Tensor, reset_mask: torch.Tensor,
             alt_init: Optional[torch.Tensor], vt_init: Optional[torch.Tensor],
             targets: Tuple, step_count: torch.Tensor,
             hidden_bf16: bool = True,
             noise_seed: Optional[torch.Tensor] = None,
             noise_scale: float = 0.0, reset_draws: bool = False,
             generator: Optional[torch.Generator] = None) -> Tuple:
    """Fused env step with the inputs and outputs of env_step_pallas
    (step_pallas.py:235-376): PRE-reset sf [12,n] / uf [5,n], action [n,4],
    last step's done mask, init draws, POST-resample targets (PRE-resample
    with reset_draws) and the post-reset step count (already
    `where(mask, 0, sc) + 1`). Returns (sf', uf', obs [n,22], done, bad,
    reward, counts int32[6]) [+ post-resample targets with reset_draws].
    `w` is the distilled container or the grouped 43-net one.

    On CUDA tensors the kernel draws from Philox keyed by `noise_seed`
    (int32 [2] on the device, needed when noise_scale > 0 or reset_draws);
    on CPU tensors the plain version draws from `generator`.
    `env_step.launches` counts kernel launches."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    grouped = _check_weights(w)
    n = sf.shape[1]
    if sf.shape != (N_S, n) or uf.shape != (N_U, n) or action4.shape != (n, N_ACT):
        raise ValueError(f"want sf [12,n], uf [5,n], action4 [n,4]; got "
                         f"{tuple(sf.shape)}, {tuple(uf.shape)}, "
                         f"{tuple(action4.shape)}")
    if sf.device != w.device:
        raise ValueError(f"state on {sf.device}, weights on {w.device}")
    if sf.device.type != "cuda":
        return env_step_plain(variant, cfg, w, sf, uf, action4, reset_mask,
                              alt_init, vt_init, targets, step_count,
                              hidden_bf16=hidden_bf16, noise_scale=noise_scale,
                              reset_draws=reset_draws, generator=generator)
    draws = noise_scale > 0.0 or reset_draws
    if draws and (noise_seed is None or noise_seed.shape != (2,)
                  or noise_seed.dtype != torch.int32
                  or noise_seed.device != sf.device):
        raise ValueError("in-kernel draws need noise_seed: int32 [2] on the device")
    if not reset_draws and (alt_init is None or vt_init is None):
        raise ValueError("without reset_draws, alt_init and vt_init are required")
    f32 = [sf, uf, action4, *targets] + ([] if reset_draws else [alt_init, vt_init])
    for t in f32:
        if t.dtype != torch.float32 or t.device != sf.device:
            raise TypeError("state, action, targets and init draws must be "
                            "float32 on the weights' device")
    sf, uf, action4 = sf.contiguous(), uf.contiguous(), action4.contiguous()
    if action4.data_ptr() % 16:  # the kernel reads one float4 per aircraft
        action4 = action4.clone()
    mask = reset_mask.to(torch.bool).contiguous()
    sc = step_count.to(torch.int32).contiguous()
    tg = [t.contiguous() for t in targets]
    a_init = v_init = None
    if not reset_draws:
        a_init, v_init = alt_init.contiguous(), vt_init.contiguous()

    dev = sf.device
    sf_o = torch.empty_like(sf)
    uf_o = torch.empty_like(uf)
    obs = torch.empty((n, N_OBS), dtype=torch.float32, device=dev)
    done = torch.empty(n, dtype=torch.bool, device=dev)
    bad = torch.empty(n, dtype=torch.bool, device=dev)
    reward = torch.empty(n, dtype=torch.float32, device=dev)
    counts = torch.zeros(N_CND, dtype=torch.int32, device=dev)
    tg_o = [torch.empty(n, dtype=torch.float32, device=dev)
            for _ in range(3)] if reset_draws else [None] * 3
    params = step_params(variant, cfg, n, 0 if grouped else w.hidden, hidden_bf16,
                         float(noise_scale), reset_draws)
    if n:
        lib = _lib()
        weights = w.packed() if grouped else (w.packed(),)
        launch = lib.np_env_step_grouped if grouped else lib.np_env_step
        code = launch(
            sf.data_ptr(), uf.data_ptr(), action4.data_ptr(), mask.data_ptr(),
            _ptr(a_init), _ptr(v_init), *(t.data_ptr() for t in tg),
            sc.data_ptr(), _ptr(noise_seed if draws else None),
            *(t.data_ptr() for t in weights), params,
            sf_o.data_ptr(), uf_o.data_ptr(), obs.data_ptr(), done.data_ptr(),
            bad.data_ptr(), reward.data_ptr(), counts.data_ptr(),
            *(_ptr(t) for t in tg_o),
            torch.cuda.current_stream(dev).cuda_stream)
        env_step.launches += 1
        cuda_build.check(code, "env_step", lib)
    out = (sf_o, uf_o, obs, done, bad, reward, counts)
    return out + tuple(tg_o) if reset_draws else out


env_step.launches = 0
