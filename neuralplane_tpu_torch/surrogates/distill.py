"""Distilled aero surrogate: the trunk the kernels run and its training
(counterpart of neuralplane_tpu/surrogates/distill.py).

One shared trunk [68 hinge features -> H -> H] with a [43, H + 68] readout
over [hidden ; features] replaces the 43-net ensemble. The net runs in
z-space; raw coefficients are z * out_std + out_mean.

bf16 rounding points, as the TPU kernel has them: features are computed in
float32 (by division by IN_SCALE) and cast to bf16; every product takes bf16
operands with a float32 accumulator; with `hidden_bf16` each hidden
accumulator is rounded to bf16 and added to the bf16-cast bias in bf16
before the ReLU; the readout keeps its float32 accumulator.

Training (`fit`, `Distiller`): the target is the 43-net ensemble in plain
float32 (`ops/aero.aero_coeffs_stacked`, not a bf16 kernel), the loss the
weighted per-coefficient z-MSE plus the error of the six body-axis totals of
the coefficient build-up at dlef = 1 with sampled rates and surfaces; Adam
(eps 1e-8) on a cosine schedule to 1% of `lr`, and a Polyak average of the
trajectory corrected for its bias once at the end. Every draw comes from a
torch.Generator on the weights' device; the draws differ from the JAX
package's threefry ones, so the tests pass the same batches to both.
`evaluate` and `xdot_fidelity` (the acceptance gate) run where the weights
are, in plain tensor ops at any hidden width; `to_npz` writes what
`ops/aero.load_distilled` reads.
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


# ---------------------------------------------------------------- training
# (neuralplane_tpu/surrogates/distill.py:115-371)

# operational envelope (degrees) - the NASA table domain
CORE_LO = np.array([-20.0, -30.0, -25.0], np.float32)
CORE_HI = np.array([90.0, 30.0, 25.0], np.float32)
# extended box for extrapolation agreement
EXT_LO = np.array([-45.0, -45.0, -40.0], np.float32)
EXT_HI = np.array([120.0, 45.0, 40.0], np.float32)

OUT_PAD = 64  # rows of W3 / b3 / out_mean / out_std on disk (ops/aero.OUT)
STATS_SAMPLES = 1 << 18  # core-envelope samples of the output scaling

# loss upweighting for the alpha-only damping derivatives (rows 6-14 and
# 21-29 of AERO_NAMES): they multiply the body rates in the moment
# equations, so their relative error dominates the P/Q/R xdot rows that
# gate acceptance (xdot_fidelity)
_DAMPING_ROWS = tuple(range(6, 15)) + tuple(range(21, 30))


def _uniform(shape, lo, hi, generator: torch.Generator) -> torch.Tensor:
    """Uniform draws on [lo, hi); lo and hi are numbers or per-column arrays.
    The bounds enter as Python floats: a tensor made from them on the host
    and copied to the card would synchronize the host with the device at
    every training step."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    if np.ndim(lo) == 0:
        return u * float(hi - lo) + float(lo)
    return torch.stack([u[..., i] * float(h - l) + float(l)
                        for i, (l, h) in enumerate(zip(lo, hi))], dim=-1)


def sample_inputs(n: int, generator: torch.Generator, core_frac: float = 0.8) -> torch.Tensor:
    """Mixture of core-envelope and extended-box uniform samples, [n, 3]
    degrees, on the generator's device."""
    core = _uniform((n, 3), CORE_LO, CORE_HI, generator)
    ext = _uniform((n, 3), EXT_LO, EXT_HI, generator)
    pick = torch.rand((n, 1), generator=generator, device=generator.device) < core_frac
    return torch.where(pick, core, ext)


def oracle_coeffs(w43, x: torch.Tensor) -> torch.Tensor:
    """The 43-net ensemble in plain float32 (the distillation target):
    [n, 3] -> [n, K]. `w43` is the stacked container (ops/aero.AeroWeights)."""
    from ..ops.aero import aero_coeffs_stacked
    return aero_coeffs_stacked(w43, x[:, 0], x[:, 1], x[:, 2])


def coeff_loss_weights() -> np.ndarray:
    from ..ops.aero import K
    w = np.ones(K, np.float32)
    w[list(_DAMPING_ROWS)] = 4.0
    return w


def _buildup_totals(coeffs_raw: torch.Tensor, beta_deg: torch.Tensor,
                    mults: torch.Tensor) -> torch.Tensor:
    """[n, K] raw coefficients -> [n, 6] body-axis totals at dlef = 1.

    mults: [n, 6] = (P, Q, R, inv_2v, dail, drud) sampled per example."""
    from ..ops.aero import IDX
    from ..ops.buildup import B_SPAN, CBAR, coeff_buildup
    P, Q, R, inv_2v, dail, drud = (mults[:, i] for i in range(6))
    totals = coeff_buildup(lambda nm: coeffs_raw[:, IDX[nm]], dlef=torch.ones_like(P),
                           dail=dail, drud=drud, P=P, Q=Q, R=R, beta_deg=beta_deg,
                           half_cbar_v=CBAR * inv_2v, half_b_v=B_SPAN * inv_2v)
    return torch.stack(totals, dim=1)


def sample_buildup_mults(n: int, generator: torch.Generator) -> torch.Tensor:
    """(P, Q, R, inv_2v, dail, drud) draws covering the operational ranges
    (rates +-2 rad/s, vt 300-1500 ft/s, full aileron/rudder throw)."""
    pqr = _uniform((n, 3), -2.0, 2.0, generator)
    vt = _uniform((n, 1), 300.0, 1500.0, generator)
    ad = _uniform((n, 2), -1.0, 1.0, generator)
    return torch.cat([pqr, 1.0 / (2.0 * vt), ad], dim=1)


def init_params(hidden: int = 128, generator: torch.Generator = None) -> DistilledParams:
    """He-normal weights, zero biases, drawn from a CPU generator (the same
    values on every device)."""
    from ..ops.aero import K
    g = generator if generator is not None else torch.Generator().manual_seed(0)

    def he(shape, fan):
        return torch.randn(shape, generator=g) * float(np.sqrt(2.0 / fan))
    return DistilledParams(
        W1=he((hidden, N_FEAT), N_FEAT), b1=torch.zeros(hidden),
        W2=he((hidden, hidden), hidden), b2=torch.zeros(hidden),
        W3=he((K, hidden + N_FEAT), hidden), b3=torch.zeros(K))


def forward(p: DistilledParams, x: torch.Tensor) -> torch.Tensor:
    """x [n, 3] raw degrees -> [n, K] z-scored coefficient predictions, in
    float32 (the training forward)."""
    f = featurize(x)
    h = torch.relu(f @ p.W1.T + p.b1)
    h = torch.relu(h @ p.W2.T + p.b2)
    return torch.cat([h, f], dim=1) @ p.W3.T + p.b3


def output_stats(w43, x: torch.Tensor, mults: torch.Tensor):
    """(out_mean [K], out_std [K], tot_std [6]) of the oracle on the core
    sample x [n, 3] with build-up multipliers [n, 6]: the z-scaling of the
    outputs and the normalization of the build-up loss."""
    with torch.no_grad():
        ys = oracle_coeffs(w43, x)
        mean = ys.mean(0)
        std = ys.std(0, unbiased=False) + 1e-6
        tot_std = _buildup_totals(ys, x[:, 1], mults).std(0, unbiased=False) + 1e-6
    return mean, std, tot_std


def cosine_lr(lr: float, steps: int, count: int, alpha: float = 1e-2) -> float:
    """optax.cosine_decay_schedule(lr, steps, alpha) at update `count`
    (the first update is count 0 and takes lr)."""
    frac = min(count, steps) / steps
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + np.cos(np.pi * frac)) + alpha)


class Distiller:
    """One distillation run: the parameters on the device of `w43`, Adam, the
    Polyak average and the generator of the batches.

    `stats` = (out_mean, out_std, tot_std) as `output_stats` returns them;
    by default they are computed on STATS_SAMPLES (2^18) core-envelope
    samples drawn first from the generator, as the JAX fit does."""

    def __init__(self, w43, hidden: int = 128, steps: int = 20000, batch: int = 65536,
                 lr: float = 3e-3, seed: int = 0, ema_decay: float = 0.999, stats=None):
        dev = w43.device
        self.w43, self.steps, self.batch, self.lr = w43, steps, batch, lr
        self.ema_decay = ema_decay
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        if stats is None:
            xs = sample_inputs(STATS_SAMPLES, self.generator, core_frac=1.0)
            stats = output_stats(w43, xs, sample_buildup_mults(xs.shape[0], self.generator))
        self.mean, self.std, self.tot_std = (
            torch.as_tensor(v, dtype=torch.float32).to(dev) for v in stats)
        self.loss_w = torch.from_numpy(coeff_loss_weights()).to(dev)
        init = init_params(hidden, torch.Generator().manual_seed(seed))
        self.params = DistilledParams(*(t.to(dev).requires_grad_() for t in init))
        self.optimizer = torch.optim.Adam(self.params, lr=lr, eps=1e-8)
        self.ema = [torch.zeros_like(t) for t in self.params]
        self.count = 0

    def loss(self, x: torch.Tensor, mults: torch.Tensor) -> torch.Tensor:
        """Weighted z-MSE plus 4 x the normalized MSE of the six body-axis
        totals: the combination the dynamics consume (it includes the
        Cm * eta_el product and the cg-shift couplings)."""
        with torch.no_grad():
            y_raw = oracle_coeffs(self.w43, x)
            y = (y_raw - self.mean) / self.std
            y_tot = _buildup_totals(y_raw, x[:, 1], mults)
        z = forward(self.params, x)
        err = z - y
        p_tot = _buildup_totals(z * self.std + self.mean, x[:, 1], mults)
        tot_err = (p_tot - y_tot) / self.tot_std
        return (err * err * self.loss_w).mean() + 4.0 * (tot_err * tot_err).mean()

    def step(self, x: torch.Tensor = None, mults: torch.Tensor = None) -> torch.Tensor:
        """One Adam step on a batch (drawn from the generator unless given);
        returns the loss before the step as a 0-d device tensor."""
        if x is None:
            x = sample_inputs(self.batch, self.generator)
            mults = sample_buildup_mults(self.batch, self.generator)
        for group in self.optimizer.param_groups:
            group["lr"] = cosine_lr(self.lr, self.steps, self.count)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(x, mults)
        loss.backward()
        self.optimizer.step()
        with torch.no_grad():
            torch._foreach_mul_(self.ema, self.ema_decay)
            torch._foreach_add_(self.ema, list(self.params), alpha=1.0 - self.ema_decay)
        self.count += 1
        return loss.detach()

    def result(self):
        """(params, out_mean, out_std): the bias-corrected Polyak average
        (the raw parameters when ema_decay is 0), detached on the device, and
        the output scaling as numpy."""
        with torch.no_grad():
            if self.ema_decay:
                corr = 1.0 - self.ema_decay ** self.count
                out = DistilledParams(*(e / corr for e in self.ema))
            else:
                out = DistilledParams(*(t.detach().clone() for t in self.params))
        return out, self.mean.cpu().numpy(), self.std.cpu().numpy()


def fit(w43, hidden: int = 128, steps: int = 20000, batch: int = 65536, lr: float = 3e-3,
        seed: int = 0, log_every: int = 2000, log_fn=print, ema_decay: float = 0.999):
    """Distill the 43-net ensemble into one trunk on the device of `w43`.

    Returns (params_in_z_space, out_mean [K], out_std [K]); the params are
    the bias-corrected EMA (decay `ema_decay`) of the training trajectory;
    ema_decay=0 returns the raw final step."""
    d = Distiller(w43, hidden=hidden, steps=steps, batch=batch, lr=lr, seed=seed,
                  ema_decay=ema_decay)
    for i in range(steps):
        loss = d.step()
        if log_every and (i % log_every == 0 or i == steps - 1):
            log_fn(f"distill step {i}: z-mse {float(loss):.3e}")
    return d.result()


def _params_on(p, device) -> DistilledParams:
    return DistilledParams(*(torch.as_tensor(np.asarray(t) if not isinstance(t, torch.Tensor)
                                             else t, dtype=torch.float32).to(device)
                             for t in p))


def _r2(pred: np.ndarray, want: np.ndarray) -> np.ndarray:
    err = pred - want
    return 1.0 - err.var(axis=0) / (want.var(axis=0) + 1e-12)


def evaluate(w43, p, mean: np.ndarray, std: np.ndarray, n: int = 1 << 18, seed: int = 123,
             quantized: bool = True, x: torch.Tensor = None) -> dict:
    """Held-out fidelity vs the ensemble on the core envelope, on the device
    of `w43` (x: [n, 3] degrees, drawn from `seed` unless given).
    quantized=True evaluates with the kernel's bf16 rounding points, so the
    gate covers quantization too."""
    from ..ops.aero import AERO_NAMES
    dev = w43.device
    if x is None:
        x = sample_inputs(n, torch.Generator(device=dev).manual_seed(seed), core_frac=1.0)
    p = _params_on(p, dev)
    with torch.no_grad():
        y = oracle_coeffs(w43, x).cpu().numpy()
        z = quantized_coeffs_z(p, x) if quantized else forward(p, x)
    yp = z.cpu().numpy() * std + mean
    err = yp - y
    r2 = _r2(yp, y)
    return {
        "r2": r2,
        "r2_min": float(r2.min()),
        "worst": AERO_NAMES[int(np.argmin(r2))],
        "mae": np.abs(err).mean(axis=0),
        "max_abs": np.abs(err).max(axis=0),
    }


def fidelity_states(n: int, generator: torch.Generator):
    """(s [n, 12], u [n, 5]): the random envelope states of the acceptance
    gate and its fixed controls (T 5000, el 2, ail -1, rud 0.5)."""
    s = torch.zeros((n, 12), device=generator.device)
    for col, lo, hi in ((2, 3000., 30000.), (3, -1., 1.), (4, -0.5, 0.5), (5, -3., 3.),
                        (6, 300., 1500.), (7, -0.3, 0.7), (8, -0.4, 0.4)):
        s[:, col] = _uniform((n,), lo, hi, generator)
    s[:, 9:12] = _uniform((n, 3), -1., 1., generator)
    u = torch.zeros((n, 5), device=generator.device)
    u[:, 0], u[:, 1], u[:, 2], u[:, 3] = 5000., 2.0, -1.0, 0.5
    return s, u


def xdot_fidelity(w43, p, mean: np.ndarray, std: np.ndarray, n: int = 8192, seed: int = 7,
                  s: torch.Tensor = None, u: torch.Tensor = None) -> dict:
    """THE acceptance gate: per-row R^2 of the full state derivative with the
    quantized trunk against the float32 43-net oracle over random envelope
    states (drawn from `seed` unless given), on the device of `w43`. Both
    sides are plain tensor ops (the trunk at any hidden width)."""
    from ..ops.aero import IDX
    from ..ops.dynamics import R2D, nlplant_core
    dev = w43.device
    if s is None:
        s, u = fidelity_states(n, torch.Generator(device=dev).manual_seed(seed))
    p = _params_on(p, dev)
    sv = tuple(s[:, i] for i in range(12))
    uv = tuple(u[:, i] for i in range(5))
    with torch.no_grad():
        c = quantized_coeffs(p, mean, std, sv[7] * R2D, sv[8] * R2D, uv[1])
        xd = torch.stack(nlplant_core(sv, uv, lambda nm: c[IDX[nm]]), dim=1)
        co = oracle_coeffs(w43, torch.stack([sv[7] * R2D, sv[8] * R2D, uv[1]], dim=1))
        xd_o = torch.stack(nlplant_core(sv, uv, lambda nm: co[:, IDX[nm]]), dim=1)
    r2 = _r2(xd.cpu().numpy(), xd_o.cpu().numpy())
    return {"xdot_r2": r2, "xdot_r2_min": float(r2.min())}


def to_npz(path: str, p, mean: np.ndarray, std: np.ndarray, meta: dict) -> None:
    """Save kernel-ready weights: z-space net + per-coefficient out_mean /
    out_std, W3/b3/mean/std padded to OUT_PAD rows in AERO_NAMES order.
    float32 on disk; `ops/aero.load_distilled` casts the weights to bf16."""
    from ..ops.aero import AERO_NAMES, K
    p = DistilledParams(*(t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor)
                          else np.asarray(t, np.float32) for t in p))
    H = p.W3.shape[1]
    W3 = np.zeros((OUT_PAD, H), np.float32)
    b3 = np.zeros(OUT_PAD, np.float32)
    mu = np.zeros(OUT_PAD, np.float32)
    sd = np.ones(OUT_PAD, np.float32)
    W3[:K], b3[:K], mu[:K], sd[:K] = p.W3, p.b3, mean, std
    np.savez(path, W1=p.W1, b1=p.b1, W2=p.W2, b2=p.b2,
             W3=W3, b3=b3, out_mean=mu, out_std=sd,
             alpha_knots=ALPHA_KNOTS, beta_knots=BETA_KNOTS,
             el_knots=EL_KNOTS, in_scale=IN_SCALE, in_mean=IN_MEAN,
             names=np.array(AERO_NAMES),
             r2_vs_ensemble=np.asarray(meta.get("r2", [])),
             xdot_r2=np.asarray(meta.get("xdot_r2", [])),
             hidden=np.int32(p.W1.shape[0]))
