#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (neuralplane_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # full run: n = 10^6 aircraft
    python3 chip_smoke.py --n 4096   # short build-and-check run

Phases, each reported on its own line:
  1. the card (nvidia-smi name and power limit);
  2. the kernel build (nvcc, one process per source, started together);
  3. nlplant_distilled against its plain version, shipped weights, both
     hidden_bf16 modes; and a yardstick for the trunk: its three products
     as torch.matmul on bf16 tensors (timed here, called nowhere in the port);
  4. env_step against env_step_plain for heading, control and tracking over
     chained steps with rows flagged for reset, draws explicit, noise off;
  5. the kernel's Philox draws: rebuilt exactly on the host, the step
     re-checked with draws on, and the noise and target statistics;
  6. the main path: ControlEnv("heading") at n aircraft, reset, 200 timed
     steps with the config's defaults (in-kernel draws and noise on);
  7. the portable branch (Euler and RK4) at a smaller n;
  8. the 43-net kernels against their plain versions: the coefficient query
     in both output layouts, the totals, xdot in both hidden_bf16 modes; a
     yardstick for the sweep (its products as torch.bmm on bf16 tensors,
     timed here, called nowhere in the port) and the SASS instruction count
     of one trip of each kernel's net loop where cuobjdump is present;
  9. as 4, 10. as 5, on the 43-net container (the step kernel's grouped mode);
 11. task_step against its plain version, three variants;
 12. as 6 with aero_backend="pallas": the 43-net main path;
 13. as 7 with aero_backend="pallas", and five steps on "stacked";
 14. the public query path on the fleet's state: ops.aero.aero_coeffs_t and
     aero_coeffs, aero_totals, nlplant_f16 and task_step;
 15. PPO training on the card, the repo's heading run configuration (3000
     envs, buffer 1000, distilled backend, default networks) for two
     episodes of collect + update through F16SimRunner.run; the policy on
     the card against the same modules on the CPU;
 16. the JAX package's committed heading policy
     (results/heading/policy_checkpoint.pkl) flown by the port's eval on the
     43-net main path, against the JAX package's own eval value;
 17. PPO training of the hierarchical planning env at the repo's tracking
     run configuration (10,000 envs, buffer 100, the committed control
     policy as the frozen low level, distilled backend) for one episode:
     100 launches of nlplant_distilled per high-level step, no env_step;
     one high-level step profiled, one run under CUDA's sync debug mode;
 18. the JAX package's committed tracking policy flown by the port on the
     planning env against the JAX package's eval, then one high-level step
     with the xdot kernel against the same step with its plain version;
 19. the committed control, UAV and C172P policies flown by the port against
     the JAX package's evals: env_step once per step for the control
     policy, no kernel at all for the UAV and the C172P;
 20. both combat envs on "distilled": SingleCombatEnv(1000, "selfplay") and
     MultipleCombatEnv(500, "multiple_selfplay"), one step with the xdot
     kernel against the same step with its plain version, 200 timed steps
     of random actions (11 and 3 launches of nlplant_distilled per step, no
     env_step), a profile of 5 steps, one step under CUDA's sync debug mode;
 21. 1v1 self-play training at the repo's run configuration
     (scripts/train_selfplay.sh) through the CLI's make_env and
     SelfplayRunner.run for one episode, then one ELO eval at a cut horizon;
     one collect step profiled;
 22. the JAX package's committed 1v1 policy (results/selfplay) flying both
     sides of SingleCombatEnv(1000, "selfplay", "distilled") for 500 steps,
     the ego team's mean reward per agent-step against the JAX package's;
 23. as 20 on the missile envs at the widths of their run scripts,
     SingleCombatShootEnv(1000, "selfplay_shoot") and
     MultipleCombatShootEnv(500, "multiple_selfplay_shoot"), the shoot bit
     on 30% of the rows (launches and hits per step reported), and the one
     step kernel vs plain from a state with missiles in the air also on the
     evadable variants (missile state, ammo, cooldown and counts);
 24. 1v1 missile self-play training at scripts/train_shoot.sh's
     configuration (PPO, the ShootTuple head with its Beta launch prior)
     through the CLI for one episode, then one stochastic ELO eval at 100
     steps; one collect step profiled;
 25. 2v2 missile MAPPO self-play at scripts/train_multiplecombat_shoot.sh's
     configuration, the same way; the MAPPO policy on the card against its
     CPU copy;
 26. the committed missile policies (results/shoot_1v1, the actor of
     results/mappo_2v2_shoot) flying both sides of their envs for 500
     steps: the ego mean reward per agent-step and the missile launches
     (and, for the team, hits) per step against the JAX package's.

 27. distillation on the card (surrogates/distill.py) at the README's
     configuration (hidden 256, batch 65,536) for 2,000 of its 80,000 steps:
     ms per step, the falling loss, evaluate and xdot_fidelity of the fit;
     the fit through to_npz and load_distilled into nlplant_distilled
     against its plain version; the shipped npz's gate R^2 on the card
     against the CPU's on the same states;
 28. train_surrogate on one lo-fi table at the reference recipe for 100
     epochs, and ops/lofi.py at 10^6 points on the card against the CPU;
 29. scripts/render.py in-process in each mode (ppo and pid 500 frames,
     planning 200, 1v1 missile combat five episodes of 300): ACMI grammar,
     channels, metrics, the kernel launches per frame;
 30. the heading and 1v1 missile actors exported (utils/export.py,
     scripts/export.py) and run in a torch-only process against the live
     policies;
 31. utils/profiling.py around ten main-path steps at 10^6, and
     scripts/supervise.py over one leg of the train CLI at phase 15's
     configuration;

 32. data parallelism at world size 1 over NCCL in this process: phase 15's
     configuration cut to buffer 104, one episode, with a mesh and without
     one from the same seed, bit for bit;
 33. two ranks sharing the card over gloo, spawned from here: (a) phase 15's
     configuration at 3000 envs in all (1500 per rank), buffer 1000, one
     episode through make_env and F16SimRunner.run, the ranks' parameters
     equal and a fixed batch's all-reduced gradient against one process's;
     (b) one episode of train_selfplay.sh's configuration at 1000 envs in
     all and one ELO eval cut to 100 steps, the ranks' ELO and pool equal;
     (c) the train CLI under torch.distributed.run with --use-mesh at a small
     Control configuration;

 34. the throughput harness (measure.py, scripts/bench.py): (a) the bench
     CLI in a subprocess with --aero distilled and --aero pallas at n and
     the timed steps of 6 and 12, its last line's keys, its s/step beside
     theirs; (b) measure_sweep, the heading step at 10^0..10^6 aircraft for
     50 steps per row; (c) measure_combat_sweep, the four combat envs at
     10^1..10^5 aircraft for 20 steps per row, the shoot bit held high on
     the missile envs, then one measured step of each under CUDA's sync
     debug mode; (d) measure_combat_step for the 1v1 envs on
     aero_backend="pallas" (nlplant_grouped) at 10^3 and 10^5 aircraft, one
     step at 10^5 against the plain 43-net xdot.

The launch counters are set to 0 just before phases 6, 7, 12, 13, 14, 15,
16, 17, 18, each eval of 19, each timed run of 20 and 23, the runs of 21,
24 and 25, the evals of 22 and 26, each render of 29, each run of 32,
each rank's runs in 33 and each row of 34(b-d), and read just after; a
kernel of the path that did not launch, or one that launched off its path
in 17-26, 29 and 32-34, fails the run. Any
mismatch, non-finite value or failed check exits non-zero. The
second-to-last line is the kernel table as JSON, the last line the device
record.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# Peaks of one H100 SXM (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# One of the 43 nets is [3 -> 20 -> 20 -> 10 -> 1]: multiply-adds of real
# work per aircraft, whatever padding a kernel multiplies as well.
SWEEP_FLOPS = 43 * 2 * (3 * 20 + 20 * 20 + 20 * 10 + 10)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trunk_flops(w, n: int) -> float:
    """Multiply-adds the surrogate needs per call: 68 features -> H -> H,
    readout of the 43 real coefficients over H + 68 (the padding rows and
    columns the kernel also multiplies are not counted)."""
    H, F = w.W1.shape
    return 2.0 * n * (H * F + H * H + 43 * (H + F))


def is_grouped(w) -> bool:
    from neuralplane_tpu_torch.ops.aero import GroupedAeroWeights
    return isinstance(w, GroupedAeroWeights)


def surrogate_flops(w, n: int) -> float:
    return float(SWEEP_FLOPS) * n if is_grouped(w) else trunk_flops(w, n)


def weight_bytes(w) -> int:
    """Bytes of the weights as the kernels read them."""
    tensors = w.packed() if is_grouped(w) else (w.packed(),)
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Mismatch(AssertionError):
    pass


def compare_cols(name: str, got: torch.Tensor, want: torch.Tensor, limits=None) -> float:
    """Columns of got/want [n, c] (or [n]) agree when, per column and
    relative to the column's RMS: the median |got - want| is within MED_REL,
    at most FLIP_SHARE of the rows differ by more than FLIP_REL, and no row
    by more than MAX_REL (or the four of `limits`, in that order). Returns
    the largest absolute error; the worst relative figures are kept in
    STATS."""
    med_rel, flip_rel, flip_share, max_rel = limits or (MED_REL, FLIP_REL, FLIP_SHARE,
                                                        MAX_REL)
    g = got.double().reshape(got.shape[0], -1)
    w = want.double().reshape(want.shape[0], -1)
    if not torch.isfinite(g).all() or not torch.isfinite(w).all():
        raise Mismatch(f"{name}: non-finite values")
    err = (g - w).abs() / w.pow(2).mean(0).sqrt().clamp_min(1e-12)
    med = err.median(0).values.max().item()
    share = (err > flip_rel).double().mean(0).max().item()
    worst = err.max().item()
    for k, v in (("median", med), ("share", share), ("max", worst)):
        STATS[k] = max(STATS.get(k, 0.0), v)
    if med > med_rel or share > flip_share or worst > max_rel:
        raise Mismatch(f"{name}: |err|/rms median {med:.3e} (limit {med_rel}), "
                       f"share above {flip_rel} {share:.3e} (limit {flip_share}), "
                       f"max {worst:.3e} (limit {max_rel})")
    return float((g - w).abs().max())


# Tolerances of kernel vs plain version on the same inputs, relative to each
# output column's RMS. Both round the same values to bf16 at the same
# points, but the tensor cores sum the bf16 x bf16 products in another order
# than the plain float32 product, so an accumulator can land on the other
# side of a bf16 rounding boundary: one hidden unit of one aircraft then
# moves by one bf16 ulp (2^-8 of its value), which is the surrogate's own
# resolution and moves that aircraft's coefficients by up to a few percent
# of their spread. So: the bulk agrees to float32 rounding and the
# transcendentals' ulps (median), flipped rows are rare (share), and no row
# moves by more than a few bf16 ulps' worth (max).
MED_REL = 1e-5
FLIP_REL, FLIP_SHARE = 1e-3, 1e-2
MAX_REL = 0.1
STATS: dict = {}
# A flipped rounding can also move a row across a termination threshold;
# at most this share of rows may disagree on a flag.
FLAG_SHARE = 1e-4


def random_states(n: int, g: torch.Generator, dev):
    """[n, 12] states and [n, 5] controls spread over the flight envelope."""
    def U(lo, hi, size=(n,)):
        return lo + (hi - lo) * torch.rand(size, generator=g, device=dev)
    s = torch.stack([U(-5e3, 5e3), U(-5e3, 5e3), U(5e3, 3e4), U(-1.0, 1.0),
                     U(-0.5, 0.5), U(-3.0, 3.0), U(300.0, 1500.0), U(-0.3, 0.7),
                     U(-0.4, 0.4), U(-1.0, 1.0), U(-1.0, 1.0), U(-1.0, 1.0)], 1)
    u = torch.stack([U(1e3, 1.5e4), U(-20.0, 20.0), U(-20.0, 20.0),
                     U(-25.0, 25.0), torch.zeros(n, device=dev)], 1)
    return s, u


def phase_nlplant(w, n, g, dev, table):
    from neuralplane_tpu_torch.ops import aero_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    s, u = random_states(n, g, dev)
    errs = []
    for hb in (True, False):
        got = aero_cuda.nlplant_distilled(w, s, u, hidden_bf16=hb)
        want = aero_cuda.nlplant_distilled_plain(w, s, u, hidden_bf16=hb)
        torch.cuda.synchronize()
        errs.append(compare_cols(f"nlplant_distilled hidden_bf16={hb}", got,
                                 want))
    ms = cuda_ms(lambda: aero_cuda.nlplant_distilled(w, s, u), 20)
    plain_ms = cuda_ms(lambda: aero_cuda.nlplant_distilled_plain(w, s, u), 3)
    nbytes = (s.nbytes + u.nbytes + s.nbytes + weight_bytes(w))
    b_ms, b_by = bound(trunk_flops(w, n), nbytes)
    log(f"phase 3 nlplant_distilled n={n}: max_abs_err bf16-hidden {errs[0]:.3e} "
        f"f32-hidden {errs[1]:.3e}; |err|/rms median {STATS['median']:.2e} "
        f"flip share {STATS['share']:.2e} max {STATS['max']:.2e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}) OK")
    table.setdefault("nlplant_distilled", {}).update(
        name="nlplant_distilled", route="cuda",
        source="neuralplane_tpu_torch/csrc/nlplant_distilled.cu",
        replaces="neuralplane_tpu/ops/aero_pallas.py:606",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)


def phase_trunk_yardstick(w, n, dev, table):
    """The trunk's three products as library calls at the main path's shapes:
    [n, 80] x [80, 256], [n, 256] x [256, 256], [n, 336] x [336, 48] on bf16
    tensors, summed. Not the kernels' function (no features, no rounding
    points, no nlplant, intermediates in device memory), so it is no
    library_ms; it says what the card's own matrix products take for the
    same multiply-adds. It draws from a generator of its own, so that the
    other phases' inputs do not depend on it."""
    from neuralplane_tpu_torch.ops.aero import F_PAD, OUT_N
    g = torch.Generator(device=dev).manual_seed(1)
    H = w.hidden
    bf = torch.bfloat16
    shapes = ((F_PAD, H), (H, H), (H + F_PAD, OUT_N))
    xs = [torch.randn((n, k), generator=g, device=dev).to(bf) for k, _ in shapes]
    ws = [torch.randn((k, m), generator=g, device=dev).to(bf) for k, m in shapes]
    ms = [cuda_ms(lambda x=x, wt=wt: torch.matmul(x, wt), 20) for x, wt in zip(xs, ws)]
    total = sum(ms)
    log(f"phase 3 trunk yardstick n={n}: trunk_matmul_ms {total:.4f} "
        f"({' + '.join(f'{t:.4f}' for t in ms)}; torch.matmul on bf16, "
        f"{' '.join(f'[n,{k}]x[{k},{m}]' for k, m in shapes)}; not the same function)")
    for key in ("nlplant_distilled", "env_step"):
        table.setdefault(key, {})["trunk_matmul_ms"] = total


def step_inputs(n, g, dev, cfg, variant):
    s, u = random_states(n, g, dev)
    act = torch.rand((n, 4), generator=g, device=dev) * 2.4 - 1.2
    mask = torch.rand(n, generator=g, device=dev) < 0.1
    alt0 = cfg.min_altitude + torch.rand(n, generator=g, device=dev) \
        * (cfg.max_altitude - cfg.min_altitude)
    vt0 = cfg.min_vt + torch.rand(n, generator=g, device=dev) * (cfg.max_vt - cfg.min_vt)
    tg = [s[:, 2] + 300.0, torch.rand(n, generator=g, device=dev) * 2 - 1,
          s[:, 6] + 10.0] if variant != "tracking" else \
        [s[:, 0] + 50.0, s[:, 1] - 50.0, s[:, 2] + 50.0]
    sc = torch.randint(0, 2600, (n,), generator=g, device=dev, dtype=torch.int32)
    return (s.T.contiguous(), u.T.contiguous(), act, mask, alt0, vt0,
            [t.contiguous() for t in tg], sc)


STEP_OUTPUTS = ("sf", "uf", "obs", "done", "bad", "reward", "counts")
TASK_OUTPUTS = ("obs", "done", "bad", "reward", "counts")


def compare_step(tag, got, want, n, names=STEP_OUTPUTS):
    """Compare two env_step (or task_step) result tuples; returns the
    largest abs error."""
    # the reward carries +-200 for the flags: compare it where they agree
    i_done, i_bad = names.index("done"), names.index("bad")
    agree = (got[i_done] == want[i_done]) & (got[i_bad] == want[i_bad])
    errs = []
    for i, nm in enumerate(names):
        g, w = got[i], want[i]
        if nm in ("done", "bad"):
            share = float((g != w).float().mean())
            if share > FLAG_SHARE:
                raise Mismatch(f"{tag} {nm}: {share:.2e} of rows disagree "
                               f"(limit {FLAG_SHARE})")
        elif nm == "counts":
            slack = math.ceil(FLAG_SHARE * n)
            if ((g.long() - w.long()).abs() > slack).any():
                raise Mismatch(f"{tag} counts {g.tolist()} vs {w.tolist()} "
                               f"(slack {slack})")
        else:
            gg = g.T if nm in ("sf", "uf") else g[agree] if nm == "reward" else g
            ww = w.T if nm in ("sf", "uf") else w[agree] if nm == "reward" else w
            errs.append(compare_cols(f"{tag} {nm}", gg, ww))
    for i in range(len(names), len(got)):
        errs.append(compare_cols(f"{tag} target {i - len(names)}", got[i], want[i]))
    return max(errs)


def phase_step(w, n, g, dev, table, key="env_step", phase=4):
    """The step kernel in the mode that `w` selects (distilled trunk or the
    43 nets) against env_step_plain."""
    from neuralplane_tpu_torch.ops import step_cuda
    STATS.clear()
    from neuralplane_tpu_torch.utils.config import load_config
    err = 0.0
    timed = {}
    for variant in ("heading", "control", "tracking"):
        cfg = load_config(variant)
        sf, uf, act, mask, alt0, vt0, tg, sc = step_inputs(n, g, dev, cfg, variant)
        for k in range(3):
            args = (variant, cfg, w, sf, uf, act, mask, alt0, vt0, tg, sc)
            got = step_cuda.env_step(*args)
            want = step_cuda.env_step_plain(*args)
            torch.cuda.synchronize()
            err = max(err, compare_step(f"{key} {variant} step {k}", got, want, n))
            if variant == "heading" and k == 0:
                # the f32-hidden mode on the same inputs
                err = max(err, compare_step(
                    f"{key} heading hidden_bf16=False",
                    step_cuda.env_step(*args, hidden_bf16=False),
                    step_cuda.env_step_plain(*args, hidden_bf16=False), n))
                timed = dict(
                    ms=cuda_ms(lambda: step_cuda.env_step(*args), 20),
                    plain_ms=cuda_ms(lambda: step_cuda.env_step_plain(*args), 3))
            # chain: the plain result is the next step's input for both
            sf, uf = want[0], want[1]
            mask = want[3] | want[4] | (torch.rand(n, generator=g, device=dev) < 0.05)
            act = torch.rand((n, 4), generator=g, device=dev) * 2.4 - 1.2
            sc = torch.where(mask, 0, sc) + 1
        log(f"phase {phase} {key} {variant} n={n}: 3 chained steps agree "
            f"(flags: <= {FLAG_SHARE} of rows may differ) OK")
    log(f"phase {phase} {key} max_abs_err {err:.3e}; |err|/rms median "
        f"{STATS['median']:.2e} flip share {STATS['share']:.2e} max "
        f"{STATS['max']:.2e}; heading kernel "
        f"{timed['ms']:.4f} ms, plain {timed['plain_ms']:.4f} ms")
    table.setdefault(key, {}).update(
        name=key, route="cuda", source="neuralplane_tpu_torch/csrc/env_step.cu",
        replaces="neuralplane_tpu/ops/step_pallas.py:329", max_abs_err=err,
        library_ms=None, **timed)


def ks_distance(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    return float(np.abs(np.searchsorted(a, grid, side="right") / a.size
                        - np.searchsorted(b, grid, side="right") / b.size).max())


def phase_draws(w, n, g, dev, table, key="env_step", phase=5):
    """The kernel's Philox draws: exact host rebuild, then statistics."""
    from neuralplane_tpu_torch.ops import philox, step_cuda
    from neuralplane_tpu_torch.utils.config import load_config
    for variant in ("heading", "control", "tracking"):
        cfg = load_config(variant)
        rc = step_cuda.reset_consts(cfg, variant)
        sf, uf, act, mask, _, _, tg, sc = step_inputs(n, g, dev, cfg, variant)
        seed_words = (int(torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device=dev)),
                      int(torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device=dev)))
        seed = torch.tensor(seed_words, dtype=torch.int32, device=dev)
        scale = 0.01
        got = step_cuda.env_step(variant, cfg, w, sf, uf, act, mask, None, None, tg,
                                 sc, noise_seed=seed, noise_scale=scale,
                                 reset_draws=True)
        # rebuild the draws on the host from the seed words
        du = torch.from_numpy(philox.uniforms(seed_words, n, range(8))).to(dev)
        alt0 = rc["min_alt"] + du[0] * (rc["max_alt"] - rc["min_alt"])
        vt0 = rc["min_vt"] + du[1] * (rc["max_vt"] - rc["min_vt"])
        t_new = step_cuda._resample_targets(variant, rc, du, alt0, vt0)
        tr = [torch.where(mask, t_new[i], tg[i]) for i in range(3)]
        for i in range(3):
            d = float((got[7 + i] - tr[i]).abs().max())
            lim = 1e-6 * float(tr[i].abs().max()) + 1e-6
            if d > lim:
                raise Mismatch(f"draws {variant}: target {i} differs from the host "
                               f"rebuild by {d:.3e} (limit {lim:.3e})")
        nb = du[8:20].clamp_min(1e-7).log().mul(-2.0).sqrt()
        th = (2.0 * math.pi) * du[20:32]
        noise = (torch.cat([nb * torch.cos(th), nb * torch.sin(th)])[:22].T * scale)
        want = step_cuda.env_step_plain(variant, cfg, w, sf, uf, act, mask, alt0,
                                        vt0, tr, sc, noise=noise)
        compare_step(f"{key} {variant} with draws", got[:7], want, n)
        # the same inputs without noise: the difference is the noise itself
        quiet = step_cuda.env_step(variant, cfg, w, sf, uf, act, mask, None, None,
                                   tg, sc, noise_seed=seed, reset_draws=True)
        for i in (0, 1):
            if not torch.equal(got[i], quiet[i]):
                raise Mismatch(f"draws {variant}: noise fed back into the state")
        nz = (got[2] - quiet[2]).double()
        seed2 = seed + 1
        nz2 = (step_cuda.env_step(variant, cfg, w, sf, uf, act, mask, None, None, tg,
                                  sc, noise_seed=seed2, noise_scale=scale,
                                  reset_draws=True)[2] - quiet[2]).double()
        mu, sd = float(nz.mean()), float(nz.std())
        kurt = float(((nz - mu) ** 4).mean() / nz.var() ** 2)
        corr = float(torch.corrcoef(torch.stack([nz.flatten(), nz2.flatten()]))[0, 1])
        noise_ok = (abs(mu) < 3 * scale / math.sqrt(nz.numel())
                    and abs(sd / scale - 1) < 0.02 and abs(kurt - 3) < 0.1
                    and abs(corr) < 0.01)
        # every row reset: target marginals vs the Generator path
        allm = torch.ones(n, dtype=torch.bool, device=dev)
        tk = step_cuda.env_step(variant, cfg, w, sf, uf, act, allm, None, None, tg,
                                sc, noise_seed=seed, reset_draws=True)[7:10]
        tp = step_cuda.env_step_plain(variant, cfg, w, sf, uf, act, allm, None, None,
                                      tg, sc, reset_draws=True, generator=g)[7:10]
        ks = [ks_distance(a.cpu().numpy(), b.cpu().numpy()) for a, b in zip(tk, tp)]
        kept = all(torch.equal(got[7 + i][~mask], tg[i][~mask]) for i in range(3))
        if variant == "heading":   # the main path's mode: draws and noise in the kernel
            table[key]["ms_with_draws"] = cuda_ms(lambda: step_cuda.env_step(
                variant, cfg, w, sf, uf, act, mask, None, None, tg, sc, noise_seed=seed,
                noise_scale=scale, reset_draws=True), 20)
        log(f"phase {phase} {key} draws {variant}: targets = host rebuild, step with draws "
            f"agrees; noise mean {mu:+.2e} std {sd:.5f} kurtosis {kurt:.3f} "
            f"lag-corr {corr:+.4f}; KS {['%.4f' % d for d in ks]}; "
            f"unflagged targets kept {kept}")
        # two samples of n from one distribution differ by ~1.4 / sqrt(n) in
        # KS distance: the limit is 0.01 from n = 10^5 on, wider for a short run
        ks_limit = max(0.01, 2.0 * math.sqrt(2.0 / n))
        if not (noise_ok and all(d < ks_limit for d in ks) and kept):
            raise Mismatch(f"draws {variant}: statistics out of bounds")


def phase_main(n, steps, table, backend="distilled", key="env_step", phase=6):
    """ControlEnv("heading", aero_backend=backend) through measure_env_step,
    counters zeroed just before and read just after."""
    from neuralplane_tpu_torch.measure import measure_env_step
    from neuralplane_tpu_torch.ops import aero_cuda, aero_grouped_cuda, step_cuda
    xdot_kernels = (aero_cuda.nlplant_distilled, aero_grouped_cuda.nlplant_grouped)
    for k in xdot_kernels:
        k.launches = 0
    step_cuda.env_step.launches = 0
    r = measure_env_step(n, steps=steps, scenario="heading", aero_backend=backend)
    launches = step_cuda.env_step.launches
    env, st = r["env"], r["state"]
    s = st.model.s
    alt = s[:, 2]
    finite = bool(torch.isfinite(st.model.sf).all() and torch.isfinite(r["out"].obs).all())
    alt_lo, alt_hi = float(alt.min()), float(alt.max())
    log(f"phase {phase} main path ControlEnv(heading, aero_backend={backend}) "
        f"n={r['n']}: {steps} timed steps "
        f"{r['s_per_step'] * 1e3:.4f} ms/step, {r['agent_steps_per_s']:.4e} "
        f"agent-steps/s, peak memory {r['peak_mem_mb']:.1f} MiB; launches "
        f"env_step {launches} xdot kernels {sum(k.launches for k in xdot_kernels)}; "
        f"finite {finite}, altitude [{alt_lo:.1f}, {alt_hi:.1f}] ft")
    if launches != steps + 1:
        raise Mismatch(f"env_step launched {launches} times for {steps + 1} steps")
    if is_grouped(env.model.weights) != (backend == "pallas"):
        raise Mismatch(f"aero_backend={backend} built {type(env.model.weights).__name__}")
    profile_steps(env, st, phase=phase)
    if not finite or alt_lo < 0.0 or alt_hi > 40000.0:
        raise Mismatch("main path state not finite or altitude out of range")
    # bytes of one main-path step: state, control, action, flags, targets,
    # step count in; state, control, obs, reward, flags, targets out
    w = env.model.weights
    n = r["n"]
    nbytes = n * (4 * 12 + 4 * 5 + 4 * 4 + 1 + 4 * 3 + 4) \
        + n * (4 * 12 + 4 * 5 + 4 * 22 + 4 + 2 + 4 * 3) + weight_bytes(w)
    table[key]["bound_ms"], table[key]["bound_by"] = bound(
        surrogate_flops(w, n), nbytes)
    table[key]["launches"] = launches
    table[key]["step_ms"] = r["s_per_step"] * 1e3
    return r


def device_rows(prof):
    """(device us, name, count) of the device's own events (kernels, copies),
    largest first; the host ops that launched them are left out, so that no
    time is counted twice."""
    from torch.autograd import DeviceType
    rows = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, reverse=True)


def profile_steps(env, st, steps: int = 20, phase: int = 6) -> None:
    """Device time by kernel over a short window of main-path steps
    (torch.profiler; after the counted run, so its launches are not counted).
    The idle share is 1 - device time / wall time of the window."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.zeros((env.n, env.num_actions), device="cuda")
    a[:, 0] = 1.0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            st, _ = env.step(st, a)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"phase {phase} profile: the profiler saw no device time (not measured)")
        return
    top = "; ".join(f"{k[:40]} {t / steps:.1f} us/step x{c // steps}" for t, k, c in rows[:5])
    log(f"phase {phase} profile ({steps} steps): device busy {busy / steps:.1f} us/step of "
        f"{wall_us / steps:.1f} us/step wall, idle share {1 - busy / wall_us:.3f}; {top}")


def phase_portable(n, table, backend="distilled", key="nlplant_distilled", phase=7):
    """The portable branch (fused_task_kernel off) on a fused aero backend:
    one xdot kernel per derivative and no step kernel."""
    from neuralplane_tpu_torch.envs import ControlEnv
    from neuralplane_tpu_torch.ops import aero_cuda, aero_grouped_cuda, step_cuda
    kernels = {"nlplant_distilled": aero_cuda.nlplant_distilled,
               "nlplant_grouped": aero_grouped_cuda.nlplant_grouped}
    total = 0
    for solver, per_step in (("euler", 1), ("rk4", 4)):
        env = ControlEnv(num_envs=n, config="heading", aero_backend=backend,
                         device="cuda")
        env.config = env.config.replace(fused_task_kernel=False, solver=solver)
        env.model.solver = solver
        st, _ = env.reset(1)
        a = torch.zeros((n, 4), device="cuda")
        a[:, 0] = 1.0
        for k in kernels.values():
            k.launches = 0
        step_cuda.env_step.launches = 0
        for _ in range(5):
            st, out = env.step(st, a)
        torch.cuda.synchronize()
        got = kernels[key].launches
        others = sum(k.launches for k in kernels.values()) - got \
            + step_cuda.env_step.launches
        finite = bool(torch.isfinite(st.model.s).all() and torch.isfinite(out.obs).all())
        log(f"phase {phase} portable branch aero_backend={backend} {solver} n={n}: "
            f"5 steps, launches {key} {got}, other kernels {others}, finite {finite}")
        if got != 5 * per_step or others or not finite:
            raise Mismatch(f"portable {backend} {solver}: wrong launches or "
                           "non-finite state")
        total += got
    table[key]["launches"] = total
    table[key]["launches_path"] = "portable branch (euler + rk4)"


def phase_stacked(n, phase=13):
    """aero_backend="stacked": the plain float32 query through the env, no
    hand-written kernel on the path."""
    from neuralplane_tpu_torch.envs import ControlEnv
    from neuralplane_tpu_torch.ops import aero_cuda, aero_grouped_cuda, step_cuda
    kernels = (aero_cuda.nlplant_distilled, aero_grouped_cuda.nlplant_grouped,
               aero_grouped_cuda.aero_coeffs_grouped, step_cuda.env_step)
    env = ControlEnv(num_envs=n, config="heading", aero_backend="stacked", device="cuda")
    st, _ = env.reset(1)
    a = torch.zeros((n, 4), device="cuda")
    a[:, 0] = 1.0
    for k in kernels:
        k.launches = 0
    for _ in range(5):
        st, out = env.step(st, a)
    torch.cuda.synchronize()
    launched = sum(k.launches for k in kernels)
    finite = bool(torch.isfinite(st.model.s).all() and torch.isfinite(out.obs).all())
    log(f"phase {phase} aero_backend=stacked n={n}: 5 steps, fused {env.fused}, "
        f"kernel launches {launched}, finite {finite}")
    if env.fused or launched or not finite:
        raise Mismatch("stacked backend: fused, launched a kernel or non-finite")


def sass_net_loops(lib_path: str, kernel: str = "grouped_kernel"):
    """Instructions of one trip of the 43-net loop, from `cuobjdump -sass`:
    per kernel of the library whose name holds `kernel`, the shortest
    backward branch whose span holds tensor-core instructions, as
    {name: (instructions, HMMA among them)}. None where there is no
    cuobjdump."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None
    sass = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True).stdout
    code, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            code[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name:
            code[name].append((int(m.group(1), 16), m.group(2)))
    loops = {}
    for name, ins in code.items():
        if kernel not in name:
            continue
        best = None
        for at, (addr, text) in enumerate(ins):
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
            if not m or int(m.group(1), 16) > addr:
                continue
            span = [t for a, t in ins[:at + 1] if a >= int(m.group(1), 16)]
            hmma = sum("HMMA" in t for t in span)
            if hmma and (best is None or len(span) < best[0]):
                best = (len(span), hmma)
        if best:
            loops[name] = best
    return loops


def totals_feats(s, u):
    """The feature-major [10, n] input of aero_totals from states and
    controls, as nlplant_core derives it."""
    from neuralplane_tpu_torch.ops.dynamics import R2D
    return torch.stack([s[:, 7] * R2D, s[:, 8] * R2D, u[:, 1], 1.0 - u[:, 4] / 25.0,
                        u[:, 2] / 21.5, u[:, 3] / 30.0, s[:, 9], s[:, 10], s[:, 11],
                        1.0 / (2.0 * s[:, 6].clamp_min(0.01))]).contiguous()


def phase_sweep(gw, n, g, dev, table, phase=8):
    """The three kernels over the 43-net sweep against their plain versions."""
    from neuralplane_tpu_torch.ops import aero_grouped_cuda as grp
    from neuralplane_tpu_torch.ops.dynamics import R2D
    src = "neuralplane_tpu_torch/csrc/aero_grouped.cu"
    ref = "neuralplane_tpu/ops/aero_pallas.py"
    s, u = random_states(n, g, dev)
    a, b, e = (s[:, 7] * R2D).contiguous(), (s[:, 8] * R2D).contiguous(), u[:, 1].contiguous()
    feats = totals_feats(s, u)
    wb = weight_bytes(gw)
    flops = float(SWEEP_FLOPS) * n
    # name -> (kernel call, plain call, rows-first views, bytes moved, replaces)
    cases = {
        "aero_coeffs_grouped[K,n]": (
            lambda: grp.aero_coeffs_grouped(gw, a, b, e),
            lambda: grp.aero_coeffs_grouped_plain(gw, a, b, e),
            lambda t: t.T, n * 4 * (3 + 43) + wb, f"{ref}:229"),
        "aero_coeffs_grouped[n,K]": (
            lambda: grp.aero_coeffs_grouped(gw, a, b, e, row_major=True),
            lambda: grp.aero_coeffs_grouped_plain(gw, a, b, e, row_major=True),
            lambda t: t, n * 4 * (3 + 43) + wb, f"{ref}:181"),
        "aero_totals": (
            lambda: grp.aero_totals(gw, feats),
            lambda: grp.aero_totals_plain(gw, feats),
            lambda t: t.T, n * 4 * (10 + 6) + wb, f"{ref}:310"),
        "nlplant_grouped": (
            lambda: grp.nlplant_grouped(gw, s, u),
            lambda: grp.nlplant_grouped_plain(gw, s, u),
            lambda t: t, n * 4 * (12 + 5 + 12) + wb, f"{ref}:428"),
    }
    for name, (kernel, plain, rows, nbytes, replaces) in cases.items():
        STATS.clear()
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = compare_cols(name, rows(got), rows(want))
        if name == "nlplant_grouped":   # the f32-hidden mode on the same inputs
            err = max(err, compare_cols(
                "nlplant_grouped hidden_bf16=False",
                grp.nlplant_grouped(gw, s, u, hidden_bf16=False),
                grp.nlplant_grouped_plain(gw, s, u, hidden_bf16=False)))
        del got, want
        ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 2)
        b_ms, b_by = bound(flops, nbytes)
        log(f"phase {phase} {name} n={n}: max_abs_err {err:.3e}; |err|/rms median "
            f"{STATS['median']:.2e} flip share {STATS['share']:.2e} max "
            f"{STATS['max']:.2e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}) OK")
        table[name] = dict(name=name, route="cuda", source=src, replaces=replaces,
                           max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None)
    table["nlplant_grouped"]["ms_f32_hidden"] = cuda_ms(
        lambda: grp.nlplant_grouped(gw, s, u, hidden_bf16=False), 20)
    log(f"phase {phase} nlplant_grouped hidden_bf16=False: kernel "
        f"{table['nlplant_grouped']['ms_f32_hidden']:.4f} ms")


def phase_sweep_yardstick(gw, n, dev, table, phase=8, chunk=1 << 18):
    """The sweep's three products and its readout as library calls at the
    main path's shapes: torch.bmm on bf16 tensors, [43, n, 3] x [43, 3, 20],
    [43, n, 20] x [43, 20, 20], [43, n, 20] x [43, 20, 10] and
    [43, n, 10] x [43, 10, 1], in chunks of `chunk` aircraft so that the
    operands fit. Not the kernels' function (no bias, no ReLU, no rounding
    points, every intermediate through device memory), so it is no
    library_ms; timed here and called nowhere in the port."""
    from neuralplane_tpu_torch.ops.aero import N_H1, N_H2, N_H3, N_IN
    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    k = gw.W1.shape[0]
    shapes = ((N_IN, N_H1), (N_H1, N_H2), (N_H2, N_H3), (N_H3, 1))
    ws = [torch.randn((k, i, o), generator=g, device=dev).to(bf) for i, o in shapes]
    ms = []
    for (i, _), wt in zip(shapes, ws):
        xs = [torch.randn((k, min(chunk, n - at), i), generator=g, device=dev).to(bf)
              for at in range(0, n, chunk)]
        ms.append(cuda_ms(lambda xs=xs, wt=wt: [torch.bmm(x, wt) for x in xs], 5))
        del xs
    total = sum(ms)
    log(f"phase {phase} sweep yardstick n={n}: sweep_bmm_ms {total:.4f} "
        f"({' + '.join(f'{t:.4f}' for t in ms)}; torch.bmm on bf16, "
        f"{' '.join(f'[43,n,{i}]x[43,{i},{o}]' for i, o in shapes)}; not the same function)")
    for key in ("aero_coeffs_grouped[K,n]", "aero_coeffs_grouped[n,K]", "aero_totals",
                "nlplant_grouped", "env_step_grouped"):
        table.setdefault(key, {})["sweep_bmm_ms"] = total


def log_sass_net_loops(phase=8):
    """One log line per grouped kernel: the SASS instructions of one trip of
    its net loop. Skipped where there is no cuobjdump."""
    from neuralplane_tpu_torch.ops import cuda_build
    for source in ("aero_grouped", "env_step"):
        loops = sass_net_loops(cuda_build.library_path(source))
        if loops is None:
            return
        for name, (count, hmma) in sorted(loops.items()):
            log(f"phase {phase} SASS {source} {name}: {count} instructions per net and "
                f"warp tile, {hmma} of them HMMA")


# float32 operations of the task layer per aircraft, counted from
# ops/task.py:task_rows with a transcendental as one: the observation (~60),
# the overload check (~45), the other checks and the reward (~45).
TASK_FLOPS = 150


def phase_task(gw, n, g, dev, table, phase=11):
    """task_step against its plain version, fed the xdot kernel's output."""
    from neuralplane_tpu_torch.ops import aero_grouped_cuda as grp
    from neuralplane_tpu_torch.ops import task_cuda
    from neuralplane_tpu_torch.utils.config import load_config
    STATS.clear()
    err = 0.0
    timed = {}
    for variant in ("heading", "control", "tracking"):
        cfg = load_config(variant)
        sf, uf, _, _, _, _, tg, sc = step_inputs(n, g, dev, cfg, variant)
        s, u = sf.T.contiguous(), uf.T.contiguous()
        xdot = grp.nlplant_grouped(gw, s, u)
        args = (variant, cfg, s, u, xdot, tuple(tg), sc)
        got, want = task_cuda.task_step(*args), task_cuda.task_step_plain(*args)
        torch.cuda.synchronize()
        err = max(err, compare_step(f"task_step {variant}", got, want, n, TASK_OUTPUTS))
        if variant == "heading":
            timed = dict(ms=cuda_ms(lambda: task_cuda.task_step(*args), 20),
                         plain_ms=cuda_ms(lambda: task_cuda.task_step_plain(*args), 3))
    nbytes = n * (4 * (12 + 5 + 12 + 3 + 1) + 4 * 22 + 4 + 2)
    b_ms, b_by = bound(float(TASK_FLOPS) * n, nbytes, PEAK_F32_FLOPS)
    log(f"phase {phase} task_step n={n}: three variants agree (flags: <= {FLAG_SHARE} "
        f"of rows may differ); max_abs_err {err:.3e}; |err|/rms median "
        f"{STATS['median']:.2e} max {STATS['max']:.2e}; heading kernel "
        f"{timed['ms']:.4f} ms, plain {timed['plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}) OK")
    table["task_step"] = dict(
        name="task_step", route="cuda", source="neuralplane_tpu_torch/csrc/task_step.cu",
        replaces="neuralplane_tpu/ops/task_pallas.py:257", max_abs_err=err,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, **timed)


def phase_public(r, table, phase=14):
    """The public query functions on the state the 43-net main path ended
    in: what a user calls to look at the fleet's aerodynamics and task
    status outside a step. Counters zeroed just before, read after each."""
    from neuralplane_tpu_torch.models.f16 import from_fm
    from neuralplane_tpu_torch.ops import aero, aero_grouped_cuda as grp, task_cuda
    from neuralplane_tpu_torch.ops.dynamics import R2D, nlplant_f16
    env, st = r["env"], r["state"]
    gw, n = env.model.weights, env.n
    m = from_fm(st.model)
    s, u = m.s, m.u
    a, b, e = (s[:, 7] * R2D).contiguous(), (s[:, 8] * R2D).contiguous(), u[:, 1].contiguous()
    kernels = (grp.aero_coeffs_grouped, grp.aero_totals, grp.nlplant_grouped,
               task_cuda.task_step)
    for k in kernels:
        k.launches = 0
    c_t = aero.aero_coeffs_t(gw, a, b, e)                        # [K, n]
    n_t = grp.aero_coeffs_grouped.launches
    c = aero.aero_coeffs(gw, a, b, e)                            # [n, K]
    n_rows = grp.aero_coeffs_grouped.launches - n_t
    totals = grp.aero_totals(gw, totals_feats(s, u))
    xdot = nlplant_f16(gw, s, u)
    obs, done, bad, reward, counts = task_cuda.task_step(
        env.task.kernel_variant, env.config, s, u, xdot,
        env.task.kernel_targets(st.task), st.step_count)
    torch.cuda.synchronize()
    launches = {"aero_coeffs_grouped[K,n]": n_t, "aero_coeffs_grouped[n,K]": n_rows,
                "aero_totals": grp.aero_totals.launches,
                "task_step": task_cuda.task_step.launches}
    shapes = (c_t.shape == (43, n) and c.shape == (n, 43) and totals.shape == (6, n)
              and xdot.shape == (n, 12) and obs.shape == (n, 22)
              and done.shape == bad.shape == reward.shape == (n,))
    finite = all(bool(torch.isfinite(t).all()) for t in (c_t, totals, xdot, obs, reward))
    same = torch.equal(c, c_t.T)
    # every bad row raised a condition, every done row the last one
    flags = (int(bad.sum()) <= int(counts.sum()) and int(done.sum()) <= int(counts[5])
             and int(counts.max()) <= n)
    log(f"phase {phase} public queries n={n}: launches {launches} nlplant_grouped "
        f"{grp.nlplant_grouped.launches}; shapes {shapes}, finite {finite}, "
        f"[n,K] == [K,n].T {same}, counts {counts.tolist()} bad {int(bad.sum())} "
        f"done {int(done.sum())}")
    if not (shapes and finite and same and flags) or grp.nlplant_grouped.launches != 1:
        raise Mismatch("public queries: wrong shape, non-finite, layouts disagree "
                       "or counts inconsistent")
    for name, k in launches.items():
        table[name]["launches"] = k
        table[name]["launches_path"] = "public query functions on the main path's state"


REPO = os.path.dirname(os.path.abspath(__file__))
# The JAX package's F16SimRunner.eval of results/heading/policy_checkpoint.pkl
# on the CPU, 1000 envs, 2500 steps, sensor noise 0.01, on the same backend as
# phase 16: aero_backend="pallas" (the 43 nets with the fused kernels' bf16
# rounding points, Pallas in interpret mode): the mean over the runner's first
# five eval keys (-107.4274, -103.2024, -98.9555, -105.7008, -100.6751), by
# `python tools/heading_eval.py --package jax --backend pallas --interpret
# --repeats 5`. On "stacked" (float32 hidden units, the JAX package's CPU
# default) the same policy scores ~8% higher, -95.65 / -93.40 / -97.30
# (`--backend stacked`); the port's stacked backend gives the same.
JAX_HEADING_EVAL = -103.19224395751954
JAX_HEADING_EVAL_STACKED = -95.65023040771484
EVAL_REL_LIMIT = 0.10
# card against CPU for the same policy modules and inputs, relative to each
# output's RMS: both are float32 throughout (TF32 off), in other summation orders
POLICY_REL = 1e-4


def dist_tensors(dist) -> list:
    """The parameter tensors of an action distribution (nested NamedTuples
    of tensors: DiagGaussian, Categorical, Bernoulli and their products)."""
    if isinstance(dist, torch.Tensor):
        return [dist]
    return [t for part in dist for t in dist_tensors(part)]


def policy_card_vs_cpu(policy, batch, rows: int = 4096, length: int = 8) -> float:
    """The policy's actor and critic on the card and a CPU copy of the same
    modules, on `rows` rows of a collected batch: one step and one chunk of
    `length` steps (the critic on the batch's share_obs where it has them).
    Returns the largest |card - cpu| / RMS(cpu) over the outputs (each
    tensor of the action distribution, the values, the hidden states);
    raises above POLICY_REL."""
    import copy
    cpu = copy.deepcopy(policy).to("cpu")
    obs, masks = batch.obs[:length, :rows], batch.masks[:length, :rows]
    cent = getattr(batch, "share_obs", batch.obs)[:length, :rows]
    h_a, h_c = batch.rnn_states_actor[0, :rows], batch.rnn_states_critic[0, :rows]
    with torch.no_grad():
        outs = {}
        for dev_name, pol in (("cuda", policy), ("cpu", cpu)):
            def d(t):
                return t.to(dev_name)
            a_step, h_step = pol.actor.dist_step(d(obs[0]), d(h_a), d(masks[0]))
            c_step = pol.critic.step(d(cent[0]), d(h_c), d(masks[0]))
            a_seq = pol.actor.dist_seq(d(obs), d(h_a), d(masks))
            c_seq = pol.critic.seq(d(cent), d(h_c), d(masks))
            outs[dev_name] = {"actor_step h": h_step, "critic_step value": c_step[0],
                              "critic_step h": c_step[1], "critic_seq value": c_seq[0],
                              "critic_seq h": c_seq[1]}
            for tag, dist in (("actor_step", a_step), ("actor_seq", a_seq)):
                for i, t in enumerate(dist_tensors(dist)):
                    outs[dev_name][f"{tag} dist {i}"] = t
    worst = 0.0
    for name, want in outs["cpu"].items():
        got = outs["cuda"][name].cpu().double()
        want = want.double()
        rel = float((got - want).abs().max() / want.pow(2).mean().sqrt().clamp_min(1e-12))
        if not math.isfinite(rel) or rel > POLICY_REL:
            raise Mismatch(f"policy {name}: card vs CPU |err|/rms {rel:.3e} "
                           f"(limit {POLICY_REL})")
        worst = max(worst, rel)
    return worst


def timed_runner(base=None):
    """`base` (default F16SimRunner) with collect and train timed on the
    host clock between synchronizations, the kernel launches of each
    collect counted, and the last collected batch kept."""
    from neuralplane_tpu_torch.runner import F16SimRunner

    class Timed(base or F16SimRunner):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.times = {"collect": [], "train": []}
            self.collect_launches = []
            self.last_batch = None

        def _timed(self, key, fn, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.times[key].append(time.perf_counter() - t0)
            return out

        def collect(self, carry):
            before = read_counts()
            out = self._timed("collect", super().collect, carry)
            self.collect_launches.append({k: v - before[k] for k, v in read_counts().items()})
            self.last_batch = out[1]
            return out

        def train(self, batch):
            return self._timed("train", super().train, batch)
    return Timed


def phase_train(episodes: int, table, phase=15):
    """PPO training on the card at the repo's heading run configuration
    (results/heading/REPORT.md): ControlEnv("heading", "distilled") at 3000
    envs, buffer 1000, chunks of 8, 5 minibatches, 16 epochs, lr 3e-4,
    entropy 1e-3, max grad norm 2, default networks; `episodes` episodes of
    collect + update through F16SimRunner.run. The env_step counter is set
    to 0 just before and read just after."""
    import tempfile
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.envs import ControlEnv
    from neuralplane_tpu_torch.ops import step_cuda
    if torch.backends.cuda.matmul.allow_tf32:
        raise Mismatch("TF32 matmuls are on: the policy is meant to run in float32")

    n, T = 3000, 1000
    cfg = RLConfig(n_rollout_threads=n, buffer_size=T, data_chunk_length=8,
                   num_mini_batch=5, ppo_epoch=16, lr=3e-4, gamma=0.99,
                   entropy_coef=1e-3, max_grad_norm=2.0,
                   num_env_steps=episodes * T * n, log_interval=1, save_interval=1)
    env = ControlEnv(num_envs=n, config="heading", aero_backend="distilled",
                     device="cuda")
    with tempfile.TemporaryDirectory() as run_dir:
        runner = timed_runner()(env, cfg, run_dir=run_dir)
        before = [p.detach().clone() for p in runner.policy.parameters()]
        torch.cuda.synchronize()
        held_mib = torch.cuda.memory_allocated() / 2 ** 20
        torch.cuda.reset_peak_memory_stats()
        step_cuda.env_step.launches = 0
        try:
            runner.run()
        finally:
            runner.close()
        launches = step_cuda.env_step.launches
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        with open(os.path.join(run_dir, "metrics.jsonl"), encoding="utf-8") as f:
            records = [json.loads(line) for line in f]
        saved = sorted(os.listdir(runner.save_dir))
    changed = sum(not torch.equal(a, b) for a, b in zip(before, runner.policy.parameters()))
    for ep, (rec, c_s, t_s) in enumerate(zip(records, runner.times["collect"],
                                             runner.times["train"])):
        log(f"phase {phase} episode {ep}: collect {c_s * 1e3 / T:.4f} ms/step "
            f"({c_s:.3f} s), update {t_s:.3f} s, {T * n / (c_s + t_s):.4e} "
            f"agent-steps/s; metrics {json.dumps(rec)}")
    rel = policy_card_vs_cpu(runner.policy, runner.last_batch)
    c_s, t_s = runner.times["collect"][-1], runner.times["train"][-1]
    log(f"phase {phase} PPO training ControlEnv(heading, distilled) n={n}, buffer {T}, "
        f"{episodes} episodes: env_step launches {launches}, parameters changed "
        f"{changed}/{len(before)}, peak device memory {peak_mib:.1f} MiB "
        f"({held_mib:.1f} MiB of it held before the phase), "
        f"checkpoints {saved}; policy card vs CPU (4096 rows, step and 8-step "
        f"chunk) max |err|/rms {rel:.2e} (limit {POLICY_REL})")
    finite = all(math.isfinite(v) for rec in records for v in rec.values())
    if launches != episodes * T:
        raise Mismatch(f"env_step launched {launches} times for {episodes} x {T} steps")
    if not finite or len(records) != episodes or changed != len(before):
        raise Mismatch("training: non-finite metric, missing record or a parameter "
                       "that did not change")
    table["env_step"]["launches_training"] = launches
    profile_training(runner, phase=phase)


def profile_calls(fn, reps: int):
    """torch.profiler over `reps` calls of fn after one unprofiled call:
    (device busy us, wall us, device launches, top five as text) per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6 / reps
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / reps
    top = "; ".join(f"{k[:36]} {t / reps:.1f} us x{c / reps:g}" for t, k, c in rows[:5])
    return busy, wall, sum(r[2] for r in rows) / reps, top


def profile_training(runner, phase=15, steps=20):
    """Where a training episode's time goes, after the counted run: 20
    collect steps, and one epoch of the update (its 5 minibatches) on the
    last collected batch. Device busy, idle share and device launches per
    call, from torch.profiler."""
    carry = [runner.init_carry(runner.next_seed())]

    @torch.no_grad()
    def collect_step():
        carry[0] = runner._collect_step(carry[0])[0]
    cfg = runner.trainer.cfg
    runner.trainer.cfg = cfg.replace(ppo_epoch=1)
    try:
        for name, fn, reps in (("collect step", collect_step, steps),
                               ("update epoch (5 minibatches)",
                                lambda: runner.trainer.train(runner.last_batch,
                                                             runner.generator), 1)):
            busy, wall, launches, top = profile_calls(fn, reps)
            if not busy:
                log(f"phase {phase} profile {name}: the profiler saw no device time "
                    "(not measured)")
                continue
            log(f"phase {phase} profile {name}: device busy {busy:.1f} us of "
                f"{wall:.1f} us wall, idle share {1 - busy / wall:.3f}, "
                f"{launches:g} device launches; {top}")
    finally:
        runner.trainer.cfg = cfg


def phase_fly(table, n=1000, steps=2500, phase=16):
    """The JAX package's heading policy (results/heading/policy_checkpoint.pkl,
    read without JAX) flown by the port: F16SimRunner.eval on
    ControlEnv("heading", aero_backend="pallas") at n envs, sensor noise on;
    its average episode reward within EVAL_REL_LIMIT of JAX_HEADING_EVAL."""
    import tempfile
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.envs import ControlEnv
    from neuralplane_tpu_torch.ops import step_cuda
    from neuralplane_tpu_torch.runner import F16SimRunner
    env = ControlEnv(num_envs=n, config="heading", aero_backend="pallas", device="cuda")
    ckpt = os.path.join(REPO, "results", "heading", "policy_checkpoint.pkl")
    with tempfile.TemporaryDirectory() as run_dir:
        runner = F16SimRunner(env, RLConfig(), run_dir=run_dir, model_dir=ckpt)
        runner.close()
    step_cuda.env_step.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value = runner.eval(steps)["eval_average_episode_rewards"]
    wall = time.perf_counter() - t0
    launches = step_cuda.env_step.launches
    rel = abs(value - JAX_HEADING_EVAL) / abs(JAX_HEADING_EVAL)
    log(f"phase {phase} JAX-trained heading policy flown by the port: "
        f"eval_average_episode_rewards {value:.4f} (the JAX package on the CPU: "
        f"pallas {JAX_HEADING_EVAL:.4f}, relative difference {rel:.4f}, limit "
        f"{EVAL_REL_LIMIT}; stacked {JAX_HEADING_EVAL_STACKED:.4f}); n={n}, "
        f"{steps} steps in {wall:.3f} s "
        f"({wall * 1e3 / steps:.4f} ms/step), env_step launches {launches}, "
        f"noise_scale {env.config.noise_scale}")
    if launches != steps or not math.isfinite(value) or rel > EVAL_REL_LIMIT:
        raise Mismatch("phase 16: wrong launches or the port's eval reward is more "
                       f"than {EVAL_REL_LIMIT:.0%} away from the JAX package's")
    table["env_step_grouped"]["launches_eval"] = launches


CONTROL_CKPT = os.path.join(REPO, "results", "control", "policy_checkpoint.pkl")
# The JAX package's F16SimRunner.eval of the other committed policies on the
# CPU at 1000 envs, each on the backend its phase flies, with the scenario's
# sensor noise: the mean over the runner's first five eval keys, by
# `python tools/heading_eval.py ... --repeats 5` (commands in its docstring).
# Each limit is 2.5 times the largest distance of one key from the mean
# (relative), rounded up to a whole percent: the spread of one eval, as
# phase 16's 10% was set from its 4.1%.
# results/tracking over results/control on PlanningEnv("tracking"),
# NEURALPLANE_AERO_BACKEND=distilled (the Pallas xdot kernel in interpret
# mode), 50 high-level steps = one 2500-step episode:
# keys -205.3014, -202.5016, -201.9565, -205.1751, -203.8501 (spread 0.88%)
JAX_TRACKING_EVAL = -203.7569366455078
TRACKING_REL_LIMIT = 0.03
# results/control on ControlEnv("control", "distilled"), Pallas step kernel in
# interpret mode (its draws by jax.random outside the kernel), 2500 steps:
# keys 28.1626, 27.0842, 29.6050, 31.9263, 25.5880 (spread 12.1%: the mean
# is small beside the per-episode rewards, so the relative spread is wide)
JAX_CONTROL_EVAL = 28.473215866088868
CONTROL_REL_LIMIT = 0.31
# results/uav_tracking on ControlEnv("tracking", model="UAV"), 250 steps (the
# airframe tumbles by construction, results/uav_tracking/REPORT.md):
# keys -195.8235, -194.6630, -196.2977, -193.2396, -196.0540 (spread 1.01%)
JAX_UAV_EVAL = -195.215576171875
UAV_REL_LIMIT = 0.03
# results/c172p_heading on ControlEnv("heading_c172p", model="C172P"), 2500 steps:
# keys 99.7438, 102.8926, 105.5634, 103.5138, 103.4567 (spread 3.19%)
JAX_C172P_EVAL = 103.03406219482422
C172P_REL_LIMIT = 0.08
# One high-level planning step with the xdot kernel against the same step
# with its plain version (phase 18): 50 inner steps chain 100 xdot
# evaluations through the frozen actor, so a row whose bf16 rounding flipped
# in one evaluation (2e-4 of rows per evaluation, PERF.md section 3) carries
# the difference on, and the float32 summation-order differences of every
# evaluation pass through the actor 50 times. Per column, relative to its
# RMS: the median stays at the single-call level (measured 5.75e-06, limit
# 1e-4), while the share of rows above 1e-3 grows with the chain (measured
# 9.1e-2 at 50 inner steps, limit 0.25) and so does the largest (measured
# 6.07e-2, limit 0.5); the share of rows whose flags differ was 0 (limit
# 1e-2). Measured on an H100 80GB HBM3 at 700 W, 1000 envs.
PLAN_LIMITS = (1e-4, 1e-3, 0.25, 0.5)
PLAN_FLAG_SHARE = 1e-2


def kernel_counters():
    """Every kernel wrapper of the port, by name."""
    from neuralplane_tpu_torch.ops import aero_cuda, aero_grouped_cuda as grp
    from neuralplane_tpu_torch.ops import step_cuda, task_cuda
    return {"nlplant_distilled": aero_cuda.nlplant_distilled,
            "nlplant_grouped": grp.nlplant_grouped,
            "aero_coeffs_grouped": grp.aero_coeffs_grouped, "aero_totals": grp.aero_totals,
            "task_step": task_cuda.task_step, "env_step": step_cuda.env_step}


def zero_counts() -> None:
    for k in kernel_counters().values():
        k.launches = 0


def read_counts() -> dict:
    return {name: k.launches for name, k in kernel_counters().items()}


def check_counts(what: str, counts: dict, expected: dict) -> None:
    """Every kernel launched exactly as `expected` says, the others never."""
    want = {name: expected.get(name, 0) for name in counts}
    if counts != want:
        raise Mismatch(f"{what}: kernel launches {counts}, want {want}")


def planning_env(n: int):
    """PlanningEnv("tracking", "distilled") over results/control's actor, on
    the card."""
    from neuralplane_tpu_torch.envs import PlanningEnv
    from neuralplane_tpu_torch.envs.planning import load_low_level_ckpt
    return PlanningEnv(num_envs=n, config="tracking", aero_backend="distilled",
                       low_level_params=load_low_level_ckpt(CONTROL_CKPT), device="cuda")


def phase_planning_train(table, phase=17):
    """PPO training of the hierarchical planning env on the card, at the
    repo's tracking run configuration (scripts/train_tracking.sh): 10,000
    envs, buffer 100, chunks of 10, 5 minibatches, 16 epochs, lr 3e-4,
    entropy 1e-3, max grad norm 2, default networks, distilled backend, the
    committed control policy as the frozen low level; one episode (the only
    cut is the number of steps). The counters are set to 0 just before and
    read just after: each high-level step is 2 x low_level_steps launches of
    nlplant_distilled (update and extended_state), and env_step never."""
    import tempfile
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    n, T = 10000, 100
    cfg = RLConfig(n_rollout_threads=n, buffer_size=T, data_chunk_length=10,
                   num_mini_batch=5, ppo_epoch=16, lr=3e-4, gamma=0.99, entropy_coef=1e-3,
                   max_grad_norm=2.0, num_env_steps=T * n, log_interval=1, save_interval=1)
    env = planning_env(n)
    inner = env.low_level_steps
    with tempfile.TemporaryDirectory() as run_dir:
        runner = timed_runner()(env, cfg, run_dir=run_dir)
        torch.cuda.synchronize()
        held_mib = torch.cuda.memory_allocated() / 2 ** 20
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        try:
            runner.run()
        finally:
            runner.close()
        counts = read_counts()
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        with open(os.path.join(run_dir, "metrics.jsonl"), encoding="utf-8") as f:
            records = [json.loads(line) for line in f]
    c_s, t_s = runner.times["collect"][0], runner.times["train"][0]
    log(f"phase {phase} planning training PlanningEnv(tracking, distilled) n={n}, buffer "
        f"{T}, {inner} inner steps: high-level {c_s * 1e3 / T:.4f} ms/step ({c_s:.3f} s "
        f"collect), inner {T * n * inner / c_s:.4e} FDM steps/s, update {t_s:.3f} s, "
        f"{T * n / (c_s + t_s):.4e} training high-level agent-steps/s, peak device memory "
        f"{peak_mib:.1f} MiB ({held_mib:.1f} MiB of it held before the phase); launches "
        f"{counts}; metrics {json.dumps(records[0]) if records else None}")
    check_counts("planning training", counts, {"nlplant_distilled": 2 * inner * T})
    finite = all(math.isfinite(v) for rec in records for v in rec.values())
    if not finite or len(records) != 1:
        raise Mismatch("planning training: non-finite metric or missing record")
    table["nlplant_distilled"]["launches_planning_training"] = counts["nlplant_distilled"]
    profile_planning_step(runner, phase=phase)


def profile_planning_step(runner, phase=17):
    """One high-level collect step under torch.profiler (after the counted
    run), and one env step under CUDA's sync debug mode: the inner loop must
    not make the host wait for the card."""
    carry = [runner.init_carry(runner.next_seed())]

    @torch.no_grad()
    def collect_step():
        carry[0] = runner._collect_step(carry[0])[0]
    busy, wall, launches, top = profile_calls(collect_step, 1)
    if busy:
        log(f"phase {phase} profile one high-level collect step: device busy {busy:.1f} us "
            f"of {wall:.1f} us wall, idle share {1 - busy / wall:.3f}, {launches:g} device "
            f"launches ({launches / runner.env.low_level_steps:.1f} per inner step); {top}")
    else:
        log(f"phase {phase} profile: the profiler saw no device time (not measured)")
    env, c = runner.env, carry[0]
    a = torch.zeros((env.n, env.num_actions), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        env.step(c.env_state, a)
    except RuntimeError as e:
        raise Mismatch(f"the planning step synchronizes the host with the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"phase {phase} one planning step under sync debug mode 'error': no host sync OK")


def planning_step_vs_plain(env, policy, warm: int = 5, phase: int = 18) -> None:
    """From a state carried through `warm` high-level steps of the policy, one
    more high-level step with the xdot kernel and the same step with
    nlplant_distilled's plain version on the card (same generator state,
    same actions), compared under PLAN_LIMITS."""
    import functools
    from neuralplane_tpu_torch.ops import aero_cuda
    st, obs = env.reset(11)
    h = policy.init_rnn_states(env.n)[0]
    masks = torch.ones((env.n, 1), device="cuda")
    with torch.no_grad():
        for _ in range(warm):
            a, h = policy.act(obs, h, masks, deterministic=True)
            st, out = env.step(st, a)
            obs = out.obs
        a, _ = policy.act(obs, h, masks, deterministic=True)
    gen = env.generator.get_state()
    got_st, got = env.step(st, a)
    env.generator.set_state(gen)
    env.model.dynamics = functools.partial(aero_cuda.nlplant_distilled_plain,
                                           env.model.weights)
    try:
        want_st, want = env.step(st, a)
    finally:
        del env.model.dynamics
    torch.cuda.synchronize()
    STATS.clear()
    flags = [float((getattr(got, f) != getattr(want, f)).float().mean())
             for f in ("done", "bad_done", "exceed_time_limit")]
    agree = (got.done == want.done) & (got.bad_done == want.bad_done)
    pairs = (("obs", got.obs, want.obs), ("reward", got.reward[agree], want.reward[agree]),
             ("state", got_st.env.model.s, want_st.env.model.s),
             ("h_low", got_st.h_low.reshape(env.n, -1), want_st.h_low.reshape(env.n, -1)))
    errs, fail = {}, None
    for name, g, w in pairs:
        try:
            errs[name] = compare_cols(f"planning step {name}", g, w, PLAN_LIMITS)
        except Mismatch as e:
            fail = fail or e
    log(f"phase {phase} one planning step, kernel vs plain on the card, n={env.n}, "
        f"{env.low_level_steps} inner steps: |err|/rms median {STATS['median']:.2e} "
        f"share above {PLAN_LIMITS[1]} {STATS['share']:.2e} max {STATS['max']:.2e} "
        f"(limits {PLAN_LIMITS}); flag disagreement {['%.2e' % f for f in flags]} "
        f"(limit {PLAN_FLAG_SHARE}); max_abs_err {errs}")
    if fail is not None:
        raise fail
    if max(flags) > PLAN_FLAG_SHARE:
        raise Mismatch(f"planning step: flags differ on {max(flags):.2e} of rows")


def phase_planning_fly(table, n=1000, steps=50, phase=18):
    """The JAX package's tracking policy (results/tracking, a Planning-env
    policy) flown by the port over results/control's actor:
    F16SimRunner.eval on PlanningEnv("tracking", "distilled") at n envs for
    `steps` high-level steps (one 2500-step episode); its average episode
    reward within TRACKING_REL_LIMIT of JAX_TRACKING_EVAL. Then one
    high-level step, kernel against plain."""
    import tempfile
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.runner import F16SimRunner
    env = planning_env(n)
    ckpt = os.path.join(REPO, "results", "tracking", "policy_checkpoint.pkl")
    with tempfile.TemporaryDirectory() as run_dir:
        runner = F16SimRunner(env, RLConfig(), run_dir=run_dir, model_dir=ckpt)
        runner.close()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value = runner.eval(steps)["eval_average_episode_rewards"]
    wall = time.perf_counter() - t0
    counts = read_counts()
    inner = env.low_level_steps
    log(f"phase {phase} JAX-trained tracking policy flown by the port (PlanningEnv, "
        f"distilled, low level results/control): eval_average_episode_rewards {value:.4f} "
        f"(the JAX package on the CPU: {JAX_TRACKING_EVAL}, limit {TRACKING_REL_LIMIT}); "
        f"n={n}, {steps} high-level steps ({steps * inner} FDM steps) in {wall:.3f} s "
        f"({wall * 1e3 / steps:.4f} ms per high-level step); launches {counts}")
    check_counts("planning eval", counts, {"nlplant_distilled": 2 * inner * steps})
    rel = abs(value - JAX_TRACKING_EVAL) / abs(JAX_TRACKING_EVAL)
    if not math.isfinite(value) or rel > TRACKING_REL_LIMIT:
        raise Mismatch(f"phase {phase}: the port's tracking eval is {rel:.4f} away from the "
                       f"JAX package's (limit {TRACKING_REL_LIMIT})")
    table["nlplant_distilled"]["launches_planning"] = counts["nlplant_distilled"]
    planning_step_vs_plain(env, runner.policy, phase=phase)


def phase_policies(table, n=1000, phase=19):
    """The other committed single-level policies flown by the port's eval,
    each against the JAX package's on the same backend: results/control on
    ControlEnv("control", "distilled") through env_step (one launch per
    step), results/uav_tracking on the UAV and results/c172p_heading on the
    C172P, which launch no kernel at all (eager by design)."""
    import tempfile
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.envs import ControlEnv
    from neuralplane_tpu_torch.runner import F16SimRunner
    cases = (("control", "F16", "control", 2500, JAX_CONTROL_EVAL, CONTROL_REL_LIMIT),
             ("uav_tracking", "UAV", "tracking", 250, JAX_UAV_EVAL, UAV_REL_LIMIT),
             ("c172p_heading", "C172P", "heading_c172p", 2500, JAX_C172P_EVAL,
              C172P_REL_LIMIT))
    for name, model, scenario, steps, ref, limit in cases:
        env = ControlEnv(num_envs=n, config=scenario, model=model,
                         aero_backend="distilled", device="cuda")
        ckpt = os.path.join(REPO, "results", name, "policy_checkpoint.pkl")
        with tempfile.TemporaryDirectory() as run_dir:
            runner = F16SimRunner(env, RLConfig(), run_dir=run_dir, model_dir=ckpt)
            runner.close()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = runner.eval(steps)["eval_average_episode_rewards"]
        wall = time.perf_counter() - t0
        counts = read_counts()
        log(f"phase {phase} results/{name} on ControlEnv({scenario}, model={model}) flown by "
            f"the port: eval_average_episode_rewards {value:.4f} (the JAX package on the "
            f"CPU: {ref}, limit {limit}); n={n}, {steps} steps in {wall:.3f} s "
            f"({wall * 1e3 / steps:.4f} ms/step), fused {env.fused}, launches {counts}, "
            f"noise_scale {env.config.noise_scale}")
        check_counts(f"results/{name} eval", counts,
                     {"env_step": steps} if model == "F16" else {})
        rel = abs(value - ref) / abs(ref)
        if not math.isfinite(value) or rel > limit:
            raise Mismatch(f"phase {phase}: results/{name} in the port is {rel:.4f} away "
                           f"from the JAX package's eval (limit {limit})")
        if model == "F16":
            table["env_step"]["launches_control_eval"] = counts["env_step"]

# One combat step with the xdot kernel against the same step with its plain
# version (phase 20): a 1v1 step chains 11 xdot evaluations through five
# PID-stabilised inner steps, the team step 3 through one. Per column,
# relative to its RMS (as PLAN_LIMITS): the median (measured 3.23e-07 1v1,
# 2.18e-07 team; limit 1e-5), the share of rows above 1e-3 (3.5e-03 and
# 5.0e-04; limit 0.02) and the largest (1.28e-02 and 1.54e-03; limit 0.1);
# the share of rows whose flags differ was 0 (limit 1e-3). Measured on an
# H100 80GB HBM3 at 700 W, 1000 1v1 envs and 500 team envs.
COMBAT_LIMITS = (1e-5, 1e-3, 0.02, 0.1)
COMBAT_FLAG_SHARE = 1e-3
SELFPLAY_CKPT = os.path.join(REPO, "results", "selfplay", "policy_checkpoint.pkl")
# The JAX package's results/selfplay policy flying both sides of
# SingleCombatEnv(1000, "selfplay") deterministically on the CPU with
# NEURALPLANE_AERO_BACKEND=distilled (the Pallas xdot kernel in interpret
# mode), 500 steps: the ego team's mean reward per agent-step for the
# runner's first five keys, by `python tools/heading_eval.py --package jax
# --env-name SingleCombat --scenario selfplay --checkpoint
# results/selfplay/policy_checkpoint.pkl --steps 500 --backend distilled
# --interpret --repeats 5`: keys 0.0125124297, 0.0125076611, 0.0124845645,
# 0.0125317197, 0.0124690625 (spread 0.26%); the limit is 2.5 times the
# largest key's distance from the mean, rounded up to a whole percent.
JAX_SELFPLAY_EVAL = 0.0125010875
SELFPLAY_REL_LIMIT = 0.01
SELFPLAY_EVAL_STEPS = 500
# The missile envs (phases 23-26): the share of rows with the shoot bit set
# in the random actions; the graded fuse's pk_sum, kernel against plain, in
# absolute terms per unit of pk_sum (the binary fuse's is exact).
SHOOT_SHARE = 0.3
PK_ABS = 1e-3
# the self-play ELO evals (phases 21, 24, 25), cut from max_steps = 2000
ELO_EVAL_STEPS = 100
# Phase 26: the JAX package's committed missile policies flying both sides
# deterministically on the CPU, NEURALPLANE_AERO_BACKEND=distilled (the
# Pallas xdot kernel in interpret mode), 500 steps, the Beta prior on, by
# `python tools/heading_eval.py --package jax --env-name SingleCombatShoot
# --scenario selfplay_shoot --checkpoint results/shoot_1v1/policy_checkpoint.pkl
# --n 1000 --steps 500 --backend distilled --interpret --repeats 5` and
# `... --env-name MultipleCombatShoot --scenario multiple_selfplay_shoot
# --checkpoint results/mappo_2v2_shoot/policy_checkpoint.pkl --n 500 ...`.
# Each limit is 2.5 times the largest key's distance from the keys' mean,
# rounded up to a whole percent. The ego mean reward per agent-step is the
# mean of the runner's first five keys: 1v1 0.0106980, 0.0103234,
# 0.0111733, 0.0079924, 0.0095753; 2v2 0.0027069, 0.0024590, 0.0051424,
# -0.0018027, 0.0000521 (one policy on both sides of the team game is near
# zero-sum, so its reward's limit is 514% and the launches and hits carry
# the check). Missile launches and hits per step are rare events whose
# rate varies with the env seed (the 1v1 launches of the first five keys
# span 0.116-0.154, of twenty 0.116-0.208), so theirs come from the first
# twenty keys (`--repeats 20`): 1v1 launches 0.116-0.208, mean 0.1553;
# 2v2 launches 2.704-2.968, mean 2.8266, hits 0.656-0.756, mean 0.7002
# (the 1v1's hits, 0.004-0.018, are too few to hold).
SHOOT_FLY = (
    ("shoot_1v1", "SingleCombatShootEnv", 1000, "selfplay_shoot", 11,
     dict(reward=0.009952481542968749, reward_limit=0.50, launches=0.1553,
          launches_limit=0.85, hits=0.0114, hits_limit=None)),
    ("mappo_2v2_shoot", "MultipleCombatShootEnv", 500, "multiple_selfplay_shoot", 3,
     dict(reward=0.001711543962097168, reward_limit=5.14, launches=2.8266,
          launches_limit=0.13, hits=0.7002, hits_limit=0.20)))


def combat_env(cls, n_envs: int, config: str):
    return cls(num_envs=n_envs, config=config, aero_backend="distilled", device="cuda")


def step_under_sync_debug(env, st, a, what: str) -> None:
    """One env step under CUDA's sync debug mode 'error': the step must not
    make the host wait for the card."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        env.step(st, a)
    except RuntimeError as e:
        raise Mismatch(f"{what} synchronizes the host with the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")


def random_actions(env, g: torch.Generator, fire_share: float = SHOOT_SHARE):
    """Uniform actions in [-1, 1]; on a missile env uniform bin indices and
    the shoot bit on `fire_share` of the rows."""
    nvec = getattr(getattr(env, "action_space", None), "nvec", None)
    if nvec is None:
        return torch.rand((env.n, env.num_actions), generator=g, device="cuda") * 2 - 1
    u = torch.rand((env.n, 5), generator=g, device="cuda")
    idx = (u[:, :4] * torch.tensor(nvec, device="cuda")).floor()
    return torch.cat([idx, (u[:, 4:] < fire_share).float()], dim=1)


def combat_step_vs_plain(env, name: str, warm: int = 5, phase: int = 20) -> None:
    """From a state carried through `warm` steps of random actions (on a
    missile env, steps that fire), one more step with the xdot kernel of the
    env's aero container (nlplant_distilled, or nlplant_grouped on the 43
    nets) and the same step with its plain version on the card (same
    generator state, same actions), under COMBAT_LIMITS; on a missile env
    also the missiles' positions and velocities, and ammo, cooldown, the
    active slots and the launch and hit counts exactly."""
    import functools
    from neuralplane_tpu_torch.ops import aero_cuda, aero_grouped_cuda
    g = torch.Generator(device="cuda").manual_seed(5)

    def act():
        return random_actions(env, g)
    st, _ = env.reset(5)
    for _ in range(warm):
        st, _ = env.step(st, act())
    a = act()
    gen = env.generator.get_state()
    got_st, got = env.step(st, a)
    env.generator.set_state(gen)
    plain = (aero_grouped_cuda.nlplant_grouped_plain if is_grouped(env.model.weights)
             else aero_cuda.nlplant_distilled_plain)
    env.model.dynamics = functools.partial(plain, env.model.weights)
    try:
        want_st, want = env.step(st, a)
    finally:
        del env.model.dynamics
    torch.cuda.synchronize()
    STATS.clear()
    flags = [float((getattr(got, f) != getattr(want, f)).float().mean())
             for f in ("done", "bad_done", "exceed_time_limit")]
    agree = (got.done == want.done) & (got.bad_done == want.bad_done)
    pairs = [("obs", got.obs, want.obs), ("reward", got.reward[agree], want.reward[agree]),
             ("state", got_st.model.s, want_st.model.s),
             ("blood", got_st.blood, want_st.blood)]
    missiles = hasattr(got_st, "missiles")
    if missiles:
        in_air = int(st.missiles.active.sum())
        pairs += [("missile pos", got_st.missiles.pos, want_st.missiles.pos),
                  ("missile vel", got_st.missiles.vel, want_st.missiles.vel)]
        exact = {k: bool(torch.equal(a, b)) for k, a, b in (
            ("ammo", got_st.ammo, want_st.ammo), ("cooldown", got_st.cooldown, want_st.cooldown),
            ("active", got_st.missiles.active, want_st.missiles.active),
            ("launches", got.info["shoot/launches"], want.info["shoot/launches"]),
            ("hits", got.info["shoot/hits"], want.info["shoot/hits"]))}
        pk = (float(got.info["shoot/pk_sum"]), float(want.info["shoot/pk_sum"]))
    errs, fail = {}, None
    for what, gv, wv in pairs:
        try:
            errs[what] = compare_cols(f"{name} step {what}", gv, wv, COMBAT_LIMITS)
        except Mismatch as e:
            fail = fail or e
    log(f"phase {phase} one {name} step, kernel vs plain on the card, n={env.n}, "
        f"{env.inner_steps} inner steps: |err|/rms median {STATS['median']:.2e} "
        f"share above {COMBAT_LIMITS[1]} {STATS['share']:.2e} max {STATS['max']:.2e} "
        f"(limits {COMBAT_LIMITS}); flag disagreement {['%.2e' % f for f in flags]} "
        f"(limit {COMBAT_FLAG_SHARE}); max_abs_err {errs}")
    if fail is not None:
        raise fail
    if max(flags) > COMBAT_FLAG_SHARE:
        raise Mismatch(f"{name} step: flags differ on {max(flags):.2e} of rows")
    if missiles:
        log(f"phase {phase} {name}: {in_air} missiles in the air before the step; exact "
            f"{exact}; launches {int(got.info['shoot/launches'])}, hits "
            f"{int(got.info['shoot/hits'])}, pk_sum kernel {pk[0]} plain {pk[1]}")
        pk_tol = 0.0 if env.config.missile_fuse_outer == 0.0 else PK_ABS * max(1.0, pk[1])
        if not all(exact.values()) or abs(pk[0] - pk[1]) > pk_tol or in_air == 0:
            raise Mismatch(f"{name} step: missile state or counts differ ({exact}, pk_sum "
                           f"{pk}), or no missile in the air")


COMBAT_CASES = (("SingleCombatEnv(selfplay)", "SingleCombatEnv", 1000, "selfplay", 11,
                 "launches_combat"),
                ("MultipleCombatEnv(multiple_selfplay)", "MultipleCombatEnv", 500,
                 "multiple_selfplay", 3, "launches_combat_team"))
# the widths of scripts/train_shoot.sh and train_multiplecombat_shoot.sh
SHOOT_CASES = (("SingleCombatShootEnv(selfplay_shoot)", "SingleCombatShootEnv", 1000,
                "selfplay_shoot", 11, "launches_shoot"),
               ("MultipleCombatShootEnv(multiple_selfplay_shoot)", "MultipleCombatShootEnv",
                500, "multiple_selfplay_shoot", 3, "launches_shoot_team"))
SHOOT_EVADABLE = (("SingleCombatShootEnv(selfplay_shoot_evadable)", "SingleCombatShootEnv",
                   1000, "selfplay_shoot_evadable"),
                  ("MultipleCombatShootEnv(multiple_selfplay_shoot_evadable)",
                   "MultipleCombatShootEnv", 500, "multiple_selfplay_shoot_evadable"))


def phase_combat(table, cases=COMBAT_CASES, steps: int = 200, phase: int = 20) -> None:
    """Combat envs on the card: kernel against plain through one step, then
    `steps` timed steps of random actions (on the missile envs the shoot bit
    on SHOOT_SHARE of the rows) with the counters set to 0 just before and
    read just after, a profile of 5 steps and one step under the sync debug
    mode."""
    from neuralplane_tpu_torch import envs
    for name, cls, n_envs, config, per_step, key in cases:
        env = combat_env(getattr(envs, cls), n_envs, config)
        combat_step_vs_plain(env, name, phase=phase)
        g = torch.Generator(device="cuda").manual_seed(7)
        actions = [random_actions(env, g) for _ in range(steps + 1)]
        st, _ = env.reset(7)
        st, _ = env.step(st, actions[0])   # warm-up
        shots = torch.zeros(2, dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        for a in actions[1:]:
            st, out = env.step(st, a)
            if "shoot/launches" in out.info:
                shots += torch.stack([out.info["shoot/launches"], out.info["shoot/hits"]])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        finite = bool(torch.isfinite(st.model.s).all() and torch.isfinite(out.obs).all()
                      and torch.isfinite(out.reward).all())
        fired = ""
        if "shoot/launches" in out.info:
            launched, hit = shots.tolist()
            fired = (f", missile launches {launched / steps:.3f} and hits {hit / steps:.3f} "
                     f"per step")
            if launched == 0 or hit == 0:
                raise Mismatch(f"{name}: no launch or no hit in {steps} steps")
        log(f"phase {phase} {name} distilled n={env.n}: {steps} steps of random actions "
            f"{wall * 1e3 / steps:.4f} ms/step, {env.n * env.inner_steps * steps / wall:.4e} "
            f"inner FDM steps/s (aircraft x inner steps){fired}, launches {counts}, "
            f"finite {finite}")
        check_counts(f"{name} {steps} steps", counts, {"nlplant_distilled": per_step * steps})
        if not finite:
            raise Mismatch(f"{name}: non-finite state, obs or reward")
        table["nlplant_distilled"][key] = counts["nlplant_distilled"]
        holder = [st]

        def one_step(holder=holder, env=env):
            holder[0], _ = env.step(holder[0], actions[1])
        busy, wall_us, launches, top = profile_calls(one_step, 5)
        if busy:
            log(f"phase {phase} profile {name} step: device busy {busy:.1f} us of "
                f"{wall_us:.1f} us wall, idle share {1 - busy / wall_us:.3f}, {launches:g} "
                f"device launches ({launches / env.inner_steps:.1f} per inner step); {top}")
        else:
            log(f"phase {phase} profile: the profiler saw no device time (not measured)")
        step_under_sync_debug(env, holder[0], actions[2], f"the {name} step")
        log(f"phase {phase} one {name} step under sync debug mode 'error': no host sync OK")


SELFPLAY_TRAIN_ARGS = [
    "--env-name", "SingleCombat", "--scenario-name", "selfplay", "--use-selfplay",
    "--selfplay-algorithm", "fsp", "--n-choose-opponents", "1", "--elo-tie-band", "1.0",
    "--use-eval", "--eval-interval", "10", "--n-rollout-threads", "1000",
    "--num-env-steps", str(1000 * 1000), "--buffer-size", "1000", "--num-mini-batch", "5",
    "--ppo-epoch", "16", "--lr", "3e-4", "--gamma", "0.99", "--entropy-coef", "1e-3",
    "--max-grad-norm", "2", "--min-log-std", "-2.3", "--data-chunk-length", "8",
    "--log-interval", "1", "--save-interval", "1", "--aero-backend", "distilled",
    "--device", "cuda"]


def phase_selfplay_train(table, phase: int = 21) -> None:
    """1v1 self-play training on the card at the repo's run configuration
    (scripts/train_selfplay.sh: 1000 envs, buffer 1000, chunks of 8, 5
    minibatches, 16 epochs, lr 3e-4, entropy 1e-3, max grad norm 2,
    min_log_std -2.3, FSP, one opponent, tie band 1.0), built by the CLI's
    make_env and run by SelfplayRunner.run for one episode on "distilled";
    then one eval_elo at ELO_EVAL_STEPS steps (the run's own horizon is
    max_steps = 2000). Counters set to 0 just before the run and read just
    after: the collect launches nlplant_distilled 11 times per step, the
    reset that starts the run once more, env_step never."""
    n, T = 1000, 1000
    runner, env, counts, peak_mib, held_mib, records, saved, elo, eval_s = selfplay_run(
        SELFPLAY_TRAIN_ARGS)
    c_s, t_s = runner.times["collect"][0], runner.times["train"][0]
    collect_counts = runner.collect_launches[0]
    log(f"phase {phase} self-play training SingleCombatEnv(selfplay, distilled) {n} envs "
        f"({runner.n_ego} ego agents), buffer {T}: collect {c_s * 1e3 / T:.4f} ms/step "
        f"({c_s:.3f} s), update {t_s:.3f} s, {T * runner.n_ego / (c_s + t_s):.4e} training "
        f"agent-steps/s, peak device memory {peak_mib:.1f} MiB ({held_mib:.1f} MiB of it held "
        f"before the phase); launches in the run {counts}, in the collect {collect_counts}; "
        f"checkpoints {saved}; metrics {json.dumps(records[0]) if records else None}")
    log(f"phase {phase} eval_elo at {ELO_EVAL_STEPS} steps (cut from max_steps "
        f"{env.config.max_steps}) in {eval_s:.3f} s ({eval_s * 1e3 / ELO_EVAL_STEPS:.4f} "
        f"ms/step): "
        f"{json.dumps(elo)}; pool {json.dumps(runner.policy_pool)}")
    check_counts("self-play collect", collect_counts, {"nlplant_distilled": 11 * T})
    check_counts("self-play run", counts, {"nlplant_distilled": 11 * T + 1})
    finite = all(math.isfinite(v) for rec in records for v in rec.values())
    pool = [f for f in saved if f.startswith("actor_")]
    if not finite or len(records) != 1 or pool != ["actor_0.pt", "actor_1.pt"] \
            or not math.isfinite(elo["latest_elo"]):
        raise Mismatch("self-play training: non-finite metric, missing record or pool entry")
    table["nlplant_distilled"]["launches_selfplay_training"] = collect_counts["nlplant_distilled"]
    carry = [runner.init_carry(runner.next_seed())]

    @torch.no_grad()
    def collect_step():
        carry[0] = runner._collect_step(carry[0])[0]
    busy, wall, launches, top = profile_calls(collect_step, 1)
    if busy:
        log(f"phase {phase} profile one self-play collect step: device busy {busy:.1f} us of "
            f"{wall:.1f} us wall, idle share {1 - busy / wall:.3f}, {launches:g} device "
            f"launches; {top}")
    else:
        log(f"phase {phase} profile: the profiler saw no device time (not measured)")


def phase_selfplay_fly(table, n_envs: int = 1000, phase: int = 22) -> None:
    """results/selfplay/policy_checkpoint.pkl (read without JAX) flying both
    sides of SingleCombatEnv(n_envs, "selfplay", "distilled") for
    SELFPLAY_EVAL_STEPS deterministic steps, by tools/heading_eval.py's own
    loop: the ego team's mean reward per agent-step within
    SELFPLAY_REL_LIMIT of JAX_SELFPLAY_EVAL."""
    import tempfile
    import types
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.envs import SingleCombatEnv
    from neuralplane_tpu_torch.runner import F16SimRunner
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from heading_eval import port_combat_values
    env = combat_env(SingleCombatEnv, n_envs, "selfplay")
    with tempfile.TemporaryDirectory() as run_dir:
        runner = F16SimRunner(env, RLConfig(), run_dir=run_dir, model_dir=SELFPLAY_CKPT)
        runner.close()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (value,), _ = port_combat_values(
        types.SimpleNamespace(repeats=1, steps=SELFPLAY_EVAL_STEPS), env, runner)
    wall = time.perf_counter() - t0
    counts = read_counts()
    ref = JAX_SELFPLAY_EVAL
    rel = abs(value - ref) / abs(ref)
    log(f"phase {phase} JAX-trained 1v1 policy (results/selfplay) flying both sides, "
        f"deterministic: ego mean reward per agent-step {value:.6f} (the JAX package on the "
        f"CPU: {ref}, relative difference {rel:.4f}, limit {SELFPLAY_REL_LIMIT}); "
        f"n={env.n}, {SELFPLAY_EVAL_STEPS} steps in {wall:.3f} s "
        f"({wall * 1e3 / SELFPLAY_EVAL_STEPS:.4f} ms/step); launches {counts}")
    check_counts("self-play policy eval", counts,
                 {"nlplant_distilled": 11 * SELFPLAY_EVAL_STEPS + 1})
    if not math.isfinite(value) or rel > SELFPLAY_REL_LIMIT:
        raise Mismatch(f"phase {phase}: the port's 1v1 eval is {rel:.4f} away from the JAX "
                       f"package's (limit {SELFPLAY_REL_LIMIT})")
    table["nlplant_distilled"]["launches_selfplay_eval"] = counts["nlplant_distilled"]


def phase_shoot(table, steps: int = 200, phase: int = 23) -> None:
    """Both missile envs at the widths of their run scripts as phase 20 does
    the guns-only ones, and the same kernel-against-plain step on the
    evadable variants."""
    from neuralplane_tpu_torch import envs
    phase_combat(table, SHOOT_CASES, steps=steps, phase=phase)
    for name, cls, n_envs, config in SHOOT_EVADABLE:
        combat_step_vs_plain(combat_env(getattr(envs, cls), n_envs, config), name, phase=phase)


def selfplay_run(argv):
    """A self-play run built by the CLI from `argv` (make_env, the runner the
    CLI picks) for one episode on the card, the counters set to 0 just
    before and read just after, then one eval_elo at ELO_EVAL_STEPS.
    Returns (runner, env, counts, peak MiB, held MiB, records, checkpoint
    files, eval result, eval s)."""
    import tempfile
    from neuralplane_tpu_torch.runner import MAPPOSelfplayRunner, SelfplayRunner
    from neuralplane_tpu_torch.scripts import train as train_cli
    args = train_cli.get_parser().parse_args(argv)
    cfg = train_cli.args_to_config(args)
    env = train_cli.make_env(args)
    base = MAPPOSelfplayRunner if args.algorithm_name == "mappo" else SelfplayRunner
    with tempfile.TemporaryDirectory() as run_dir:
        runner = timed_runner(base)(env, cfg, run_dir=run_dir)
        torch.cuda.synchronize()
        held_mib = torch.cuda.memory_allocated() / 2 ** 20
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        try:
            runner.run()
        finally:
            runner.close()
        counts = read_counts()
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        with open(os.path.join(run_dir, "metrics.jsonl"), encoding="utf-8") as f:
            records = [json.loads(line) for line in f]
        saved = sorted(os.listdir(runner.save_dir))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        elo = runner.eval_elo(ELO_EVAL_STEPS)
        eval_s = time.perf_counter() - t0
    return runner, env, counts, peak_mib, held_mib, records, saved, elo, eval_s


SHOOT_TRAIN_ARGS = ["--use-selfplay", "--use-prior", "--selfplay-algorithm", "fsp",
                    "--n-choose-opponents", "1", "--elo-tie-band", "50", "--use-eval",
                    "--eval-interval", "10", "--eval-stochastic", "--buffer-size", "1000",
                    "--num-mini-batch", "5", "--ppo-epoch", "16", "--lr", "3e-4",
                    "--gamma", "0.99", "--entropy-coef", "1e-3", "--max-grad-norm", "2",
                    "--data-chunk-length", "8", "--log-interval", "1", "--save-interval", "20",
                    "--aero-backend", "distilled", "--device", "cuda"]


def phase_shoot_train(table, team: bool, phase: int) -> None:
    """Missile self-play training on the card at a committed run's
    configuration, cut to one episode: scripts/train_shoot.sh (1v1, 1000
    envs, PPO) or, with `team`, scripts/train_multiplecombat_shoot.sh (2v2,
    500 envs, MAPPO): buffer 1000, chunks of 8, 5 minibatches, 16 epochs,
    lr 3e-4, entropy 1e-3, max grad norm 2, FSP, one opponent, tie band 50,
    the Beta launch prior, stochastic ELO eval (cut to ELO_EVAL_STEPS
    steps). The collect launches nlplant_distilled 11 (1v1) or 3 (team)
    times per step, the run's reset once more, env_step never; the team's
    MAPPO policy on the card is held against its CPU copy."""
    T, per_step = 1000, (3 if team else 11)
    if team:
        n, what = 500, "MAPPO 2v2 MultipleCombatShootEnv(multiple_selfplay_shoot, distilled)"
        argv = ["--env-name", "MultipleCombatShoot", "--scenario-name",
                "multiple_selfplay_shoot", "--algorithm-name", "mappo"]
    else:
        n, what = 1000, "PPO 1v1 SingleCombatShootEnv(selfplay_shoot, distilled)"
        argv = ["--env-name", "SingleCombatShoot", "--scenario-name", "selfplay_shoot"]
    argv += ["--n-rollout-threads", str(n), "--num-env-steps", str(T * n * (2 if team else 1)),
             *SHOOT_TRAIN_ARGS]
    runner, env, counts, peak_mib, held_mib, records, saved, elo, eval_s = selfplay_run(argv)
    c_s, t_s = runner.times["collect"][0], runner.times["train"][0]
    collect_counts = runner.collect_launches[0]
    log(f"phase {phase} missile self-play training {what} {n} envs ({runner.n_ego} ego "
        f"agents), buffer {T}: collect {c_s * 1e3 / T:.4f} ms/step ({c_s:.3f} s), update "
        f"{t_s:.3f} s, {T * runner.n_ego / (c_s + t_s):.4e} training agent-steps/s, peak "
        f"device memory {peak_mib:.1f} MiB ({held_mib:.1f} MiB of it held before the phase); "
        f"launches in the run {counts}, in the collect {collect_counts}; checkpoints {saved}; "
        f"metrics {json.dumps(records[0]) if records else None}")
    log(f"phase {phase} eval_elo at {ELO_EVAL_STEPS} steps (cut from max_steps "
        f"{env.config.max_steps}), stochastic, in {eval_s:.3f} s "
        f"({eval_s * 1e3 / ELO_EVAL_STEPS:.4f} ms/step): {json.dumps(elo)}; pool "
        f"{json.dumps(runner.policy_pool)}")
    check_counts(f"{what} collect", collect_counts, {"nlplant_distilled": per_step * T})
    check_counts(f"{what} run", counts, {"nlplant_distilled": per_step * T + 1})
    finite = all(math.isfinite(v) for rec in records for v in rec.values())
    pool = [f for f in saved if f.startswith("actor_")]
    if not finite or len(records) != 1 or "shoot_launches" not in records[0] \
            or pool != ["actor_0.pt", "actor_1.pt"] or not math.isfinite(elo["latest_elo"]):
        raise Mismatch(f"{what}: non-finite metric, missing record, shoot counter or pool "
                       "entry")
    table["nlplant_distilled"]["launches_shoot_training_team" if team else
                               "launches_shoot_training"] = collect_counts["nlplant_distilled"]
    if team:
        rel = policy_card_vs_cpu(runner.policy, runner.last_batch)
        log(f"phase {phase} MAPPO policy card vs CPU (4096 rows, step and 8-step chunk; the "
            f"centralized critic on share_obs) max |err|/rms {rel:.2e} (limit {POLICY_REL})")
    carry = [runner.init_carry(runner.next_seed())]

    @torch.no_grad()
    def collect_step():
        carry[0] = runner._collect_step(carry[0])[0]
    busy, wall, launches, top = profile_calls(collect_step, 1)
    if busy:
        log(f"phase {phase} profile one collect step: device busy {busy:.1f} us of "
            f"{wall:.1f} us wall, idle share {1 - busy / wall:.3f}, {launches:g} device "
            f"launches; {top}")
    else:
        log(f"phase {phase} profile: the profiler saw no device time (not measured)")


def phase_shoot_fly(table, phase: int = 26) -> None:
    """The committed missile policies (read without JAX) flying both sides
    of their envs on "distilled" for SELFPLAY_EVAL_STEPS deterministic steps
    by tools/heading_eval.py's own loop, the Beta prior on:
    results/shoot_1v1 on SingleCombatShootEnv(1000, "selfplay_shoot"),
    results/mappo_2v2_shoot's actor on MultipleCombatShootEnv(500,
    "multiple_selfplay_shoot"). The ego mean reward per agent-step and the
    missile launches per step within their limits of the JAX package's."""
    import tempfile
    import types
    from neuralplane_tpu_torch import envs
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.runner import F16SimRunner
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from heading_eval import port_combat_values
    for name, cls, n_envs, config, per_step, ref in SHOOT_FLY:
        env = combat_env(getattr(envs, cls), n_envs, config)
        with tempfile.TemporaryDirectory() as run_dir:
            runner = F16SimRunner(env, RLConfig(use_prior=True), run_dir=run_dir,
                                  model_dir=os.path.join(REPO, "results", name,
                                                         "policy_checkpoint.pkl"))
            runner.close()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (value,), ((launched, hit),) = port_combat_values(
            types.SimpleNamespace(repeats=1, steps=SELFPLAY_EVAL_STEPS), env, runner)
        wall = time.perf_counter() - t0
        counts = read_counts()
        rel = abs(value - ref["reward"]) / abs(ref["reward"])
        rel_l = abs(launched - ref["launches"]) / ref["launches"]
        rel_h = abs(hit - ref["hits"]) / ref["hits"]
        log(f"phase {phase} JAX-trained missile policy (results/{name}) flying both sides of "
            f"{cls}({n_envs}, {config}), deterministic: ego mean reward per agent-step "
            f"{value:.6f} (the JAX package on the CPU: {ref['reward']}, relative difference "
            f"{rel:.4f}, limit {ref['reward_limit']}); missile launches per step "
            f"{launched:.3f} (JAX {ref['launches']}, relative difference {rel_l:.4f}, limit "
            f"{ref['launches_limit']}), hits per step {hit:.3f} (JAX {ref['hits']}, relative "
            f"difference {rel_h:.4f}, limit {ref['hits_limit']}); "
            f"n={env.n}, {SELFPLAY_EVAL_STEPS} steps in {wall:.3f} s "
            f"({wall * 1e3 / SELFPLAY_EVAL_STEPS:.4f} ms/step); launches {counts}")
        check_counts(f"results/{name} eval", counts,
                     {"nlplant_distilled": per_step * SELFPLAY_EVAL_STEPS + 1})
        if not math.isfinite(value) or rel > ref["reward_limit"] \
                or rel_l > ref["launches_limit"] \
                or (ref["hits_limit"] is not None and rel_h > ref["hits_limit"]):
            raise Mismatch(f"phase {phase}: results/{name} in the port is {rel:.4f} (reward), "
                           f"{rel_l:.4f} (launches) and {rel_h:.4f} (hits) away from the JAX "
                           "package's eval")
        table["nlplant_distilled"][f"launches_{name}_eval"] = counts["nlplant_distilled"]


# Phase 27: the fit is the README's distillation configuration (hidden 256,
# batch 65,536, lr 3e-3) with its schedule run over a cut of its 80,000 steps.
DISTILL_STEPS = 2000
DISTILL_GATE = 0.999         # the distillation CLI's xdot gate
FIDELITY_CPU_ROW = 1e-5      # the shipped npz's gate R^2, card vs CPU, per row


def phase_distill(table, steps=DISTILL_STEPS, phase=27):
    """Distillation on the card (surrogates/distill.py) at the README's
    configuration, the schedule over `steps` (reduced from 80,000): ms per
    step, the first and last loss (it must fall), evaluate (quantized) and
    xdot_fidelity of the fit; the fit through to_npz and load_distilled into
    nlplant_distilled against its plain version on 65,536 envelope states
    (the phase-3 tolerance block); xdot_fidelity of the shipped npz on the
    card, which must pass the gate and agree with the port's CPU value on
    the same states. Then a profile of one step."""
    import tempfile
    from neuralplane_tpu_torch.ops import aero_cuda
    from neuralplane_tpu_torch.ops.aero import K, load_aero_weights, load_distilled
    from neuralplane_tpu_torch.surrogates import distill
    dev = torch.device("cuda")
    w43 = load_aero_weights(device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = distill.Distiller(w43, hidden=256, steps=steps, batch=65536, lr=3e-3, seed=0)
    first = d.step()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        last = d.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    first, last = float(first), float(last)
    params, mean, std = d.result()
    ev = distill.evaluate(w43, params, mean, std)
    fid = distill.xdot_fidelity(w43, params, mean, std)
    log(f"phase {phase} distillation hidden 256, batch 65536, lr 3e-3, {steps} steps "
        f"(reduced from the README's 80000; the cosine schedule runs over the cut): "
        f"{step_ms:.4f} ms/step, output statistics and first step {setup_s:.3f} s; "
        f"loss {first:.4e} -> {last:.4e}; quantized min coefficient R^2 {ev['r2_min']:.6f} "
        f"({ev['worst']}); xdot R^2 per row {np.round(fid['xdot_r2'], 6).tolist()}, min "
        f"{fid['xdot_r2_min']:.6f}")
    if not (math.isfinite(last) and last < first):
        raise Mismatch(f"phase {phase}: the distillation loss did not fall ({first} -> {last})")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fresh.npz")
        distill.to_npz(path, params, mean, std, {**ev, **fid})
        w = load_distilled(path, device=dev)
    g = torch.Generator(device=dev).manual_seed(27)
    s, u = random_states(65536, g, dev)
    errs = [compare_cols(f"phase {phase} nlplant_distilled fresh weights hidden_bf16={hb}",
                         aero_cuda.nlplant_distilled(w, s, u, hidden_bf16=hb),
                         aero_cuda.nlplant_distilled_plain(w, s, u, hidden_bf16=hb))
            for hb in (True, False)]
    log(f"phase {phase} the fit through to_npz, load_distilled and nlplant_distilled on "
        f"65536 states: kernel vs plain max_abs_err {max(errs):.3e} (phase-3 limits) OK")

    with np.load(os.path.join(REPO, "neuralplane_tpu", "data", "f16_aero_distilled.npz")) as z:
        shipped = distill.DistilledParams(z["W1"], z["b1"], z["W2"], z["b2"], z["W3"][:K],
                                          z["b3"][:K])
        s_mean, s_std = z["out_mean"][:K], z["out_std"][:K]
    s, u = distill.fidelity_states(8192, torch.Generator(device=dev).manual_seed(7))
    card = distill.xdot_fidelity(w43, shipped, s_mean, s_std, s=s, u=u)
    cpu = distill.xdot_fidelity(load_aero_weights(device="cpu"), shipped, s_mean, s_std,
                                s=s.cpu(), u=u.cpu())
    diff = float(np.abs(card["xdot_r2"] - cpu["xdot_r2"]).max())
    log(f"phase {phase} the shipped npz's xdot R^2 on the card: min {card['xdot_r2_min']:.6f} "
        f"(gate {DISTILL_GATE}), per row {np.round(card['xdot_r2'], 6).tolist()}; the "
        f"port's CPU value on the same states differs by at most {diff:.2e} per row "
        f"(limit {FIDELITY_CPU_ROW})")
    if card["xdot_r2_min"] < DISTILL_GATE or diff > FIDELITY_CPU_ROW:
        raise Mismatch(f"phase {phase}: the shipped npz's gate R^2 on the card is "
                       f"{card['xdot_r2_min']} ({diff:.2e} from the CPU)")
    busy, wall, launches, top = profile_calls(d.step, 5)
    if busy:
        log(f"phase {phase} profile one distillation step: device busy {busy:.1f} us of "
            f"{wall:.1f} us wall, idle share {1 - busy / wall:.3f}, {launches:g} device "
            f"launches; {top}")
    else:
        log(f"phase {phase} profile: the profiler saw no device time (not measured)")


# Phase 28: the bound on the test R^2 of one lo-fi table trained at the
# reference recipe for 100 epochs, set from CPU runs at the same
# settings (seeds 0-7: 0.99500-0.99800; PERF.md section 4).
TABLE_R2_BOUND = 0.99
LOFI_REL = 1e-6


def phase_tables(phase=28):
    """surrogates/train.py on the card: train_surrogate on the lo-fi CX table
    over (alpha, elevator) as an in-memory AeroTable, batch 32, subdivide 3,
    100 epochs; then ops/lofi.py at 10^6 random points on the card against
    the CPU (relative to max(|value|, the column's RMS))."""
    from neuralplane_tpu_torch.ops import lofi
    from neuralplane_tpu_torch.surrogates import AeroTable, train_surrogate
    table = AeroTable("Cx", (lofi.ALPHA_AXIS, lofi.DELE_AXIS), lofi._CX.T.copy(),
                      ("alpha", "el"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = train_surrogate(table, seed=0, epochs=100, batch_size=32, subdivide=3, device="cuda")
    wall = time.perf_counter() - t0
    n_points = len(table.dense_grid(3)[0])
    log(f"phase {phase} train_surrogate(lo-fi CX over alpha x elevator, {n_points} grid "
        f"points, batch 32, subdivide 3, 100 epochs) on the card in {wall:.3f} s: test R^2 "
        f"{r['test_r2']:.6f} (bound {TABLE_R2_BOUND})")
    if not r["test_r2"] >= TABLE_R2_BOUND:
        raise Mismatch(f"phase {phase}: the table surrogate's test R^2 is {r['test_r2']}")
    n = 10 ** 6
    g = torch.Generator(device="cuda").manual_seed(28)
    a = -15.0 + 65.0 * torch.rand(n, generator=g, device="cuda")
    b = -35.0 + 70.0 * torch.rand(n, generator=g, device="cuda")
    e = -30.0 + 60.0 * torch.rand(n, generator=g, device="cuda")

    def all_lofi(a, b, e):
        return torch.stack([*lofi.damping(a), *lofi.dmomdcon(a, b), *lofi.clcn(a, b),
                            *lofi.cxcm(a, e), lofi.cz(a, b, e)], dim=1)
    card = all_lofi(a, b, e)
    cpu = all_lofi(a.cpu(), b.cpu(), e.cpu())
    scale = torch.maximum(cpu.abs(), cpu.pow(2).mean(0).sqrt())
    rel = float(((card.cpu() - cpu).abs() / scale).max())
    ms = cuda_ms(lambda: all_lofi(a, b, e), 5)
    log(f"phase {phase} ops/lofi.py at {n} points: the 18 coefficients on the card against "
        f"the CPU, max relative difference {rel:.2e} (limit {LOFI_REL}); {ms:.4f} ms for all "
        f"five functions on the card")
    if not torch.isfinite(card).all() or rel > LOFI_REL:
        raise Mismatch(f"phase {phase}: lo-fi tables on the card differ from the CPU by {rel}")


# frames per render mode: 500 of the CLI's default 2000 for the control
# modes, 200 for planning (each frame is 50 inner steps of ~230 ms of host
# dispatch; the depth cut that keeps the script near half its time limit).
# Missile combat renders COMBAT_SEEDS episodes of 300 frames each: a sampled
# self-play duel launches in the opening geometry or rarely at all (on the
# CPU, 3 of seeds 0-3 launched within 300 frames; the card's seed 0 did not
# in 2000), and a missile flies 200 frames, so each episode shows its
# launches and their removals.
RENDER_FRAMES = {"ppo": 500, "pid": 500, "planning": 200, "combat": 300}
COMBAT_SEEDS = 5
# one ACMI object line: id,T=lon|lat|alt|roll|pitch|yaw,Name=..,Color=..[,Type=..]
ACMI_OBJECT = re.compile(r"^\d+,T=(-?[0-9.e+-]+\|){5}-?[0-9.e+-]+,Name=\w+,Color=\w+"
                         r"(,Type=Missile)?$")
ACMI_HEADER = ["FileType=text/acmi/tacview", "FileVersion=2.0",
               "0,ReferenceTime=2023-04-01T00:00:00Z"]
CONTROL_METRICS = {"mean_G", "mean_TAS", "mean_RoC", "mean_AOA", "ASM", "SSM", "OSM",
                   "AOASM", "AOSSM", "episode_reward", "reached_target", "failed",
                   "success_rate"}


def acmi_grammar(path: str) -> dict:
    """Line kinds of an ACMI file, after checking the header and that every
    line is a frame stamp, an object line or a removal, with finite numbers."""
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    if lines[:3] != ACMI_HEADER:
        raise Mismatch(f"{path}: header {lines[:3]}")
    kinds = {"frames": 0, "objects": 0, "missiles": 0, "removals": 0}
    for line in lines[3:]:
        if re.fullmatch(r"#\d+\.\d\d", line):
            kinds["frames"] += 1
        elif re.fullmatch(r"-\d+", line):
            kinds["removals"] += 1
        elif ACMI_OBJECT.match(line):
            nums = [float(x) for x in line.split(",")[1][2:].split("|")]
            if not all(math.isfinite(x) for x in nums):
                raise Mismatch(f"{path}: non-finite values in {line}")
            kinds["missiles" if line.endswith("Type=Missile") else "objects"] += 1
        else:
            raise Mismatch(f"{path}: a line outside the ACMI grammar: {line!r}")
    return kinds


def phase_render(table, frames=RENDER_FRAMES, phase=29):
    """scripts/render.py in-process, from a temporary directory, for
    `frames[mode]` frames in each mode on "distilled": ppo (results/heading),
    pid, planning (results/tracking over results/control) and 1v1 missile
    combat (results/shoot_1v1, sampled, with its Beta launch prior). Per mode: the
    ACMI frames and grammar (the committed JAX renders' files pass the same
    check), finite numbers, the result/*.npy channels, the metrics' keys,
    the kernel launches per frame and ms per frame."""
    import tempfile
    from neuralplane_tpu_torch.render import TrajectoryRecorder
    from neuralplane_tpu_torch.scripts import render
    res = os.path.join(REPO, "results")
    for committed in ("heading", "shoot_1v1"):
        kinds = acmi_grammar(os.path.join(res, committed, "demo", "recording.txt.acmi"))
        log(f"phase {phase} the JAX render's results/{committed}/demo/recording.txt.acmi: "
            f"{kinds}")
    # kernel launches per frame: the env step, plus one xdot for the frame's
    # G channel (which the PID mode also reads for its next action); one more
    # xdot at the PID's and the combat env's reset
    ckpt = {k: os.path.join(res, k, "policy_checkpoint.pkl")
            for k in ("heading", "tracking", "control", "shoot_1v1")}
    runs = [("ppo", ["--checkpoint", ckpt["heading"]], {"env_step": 1, "nlplant_distilled": 1}, 0),
            ("pid", [], {"env_step": 1, "nlplant_distilled": 1}, 1),
            ("planning", ["--checkpoint", ckpt["tracking"], "--low-level-ckpt", ckpt["control"]],
             {"nlplant_distilled": 101}, 0)]
    runs += [("combat", ["--scenario", "selfplay_shoot", "--checkpoint", ckpt["shoot_1v1"],
                         "--stochastic", "--seed", str(seed)], {"nlplant_distilled": 11}, 1)
             for seed in range(COMBAT_SEEDS)]
    combat = {"episodes": 0, "frames": 0, "launches": 0, "missiles": 0, "removals": 0, "s": 0.0}
    with tempfile.TemporaryDirectory() as tmp:
        for k, (mode, argv, per_frame, at_reset) in enumerate(runs):
            out = os.path.join(tmp, str(k))
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                rec = render.main(["--mode", mode, *argv, "--steps", str(frames[mode]),
                                   "--out", out, "--aero-backend", "distilled"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            kinds = acmi_grammar(os.path.join(out, "recording.txt.acmi"))
            done = rec["steps"] if mode == "combat" else frames[mode]
            figure = ("" if mode == "combat" else "figure skipped (no matplotlib); "
                      if "figure skipped" in printed.getvalue() else "figure written; ")
            seed = f" --seed {argv[-1]}" if mode == "combat" else ""
            log(f"phase {phase} render --mode {mode}{seed}: {done} frames in {wall:.3f} s "
                f"({wall * 1e3 / done:.4f} ms/frame); ACMI {kinds}; launches {counts}; "
                f"{figure}{json.dumps(rec)}")
            check_counts(f"render --mode {mode}", counts,
                         {k: v * done + (at_reset if k == "nlplant_distilled" else 0)
                          for k, v in per_frame.items()})
            for name, v in counts.items():
                if v:
                    key = f"launches_render_{mode}"
                    table[name][key] = table[name].get(key, 0) + v
            values = [v for v in rec.values() if isinstance(v, float)]
            if kinds["frames"] != done or not all(math.isfinite(v) for v in values):
                raise Mismatch(f"render {mode}: {kinds['frames']} frames for {done}, or a "
                               "non-finite metric")
            if mode == "combat":
                # a launched missile is drawn from its launch frame on; a
                # removal follows only a missile that flew
                if set(rec) != {"steps", "blood", "launches", "hits", "ammo"} \
                        or (rec["launches"] > 0) != (kinds["missiles"] > 0) \
                        or kinds["removals"] > rec["launches"]:
                    raise Mismatch(f"render combat: keys {sorted(rec)}, launches "
                                   f"{rec['launches']}, ACMI {kinds}")
                for key, v in (("episodes", 1), ("frames", done), ("launches", rec["launches"]),
                               ("missiles", kinds["missiles"]),
                               ("removals", kinds["removals"]), ("s", wall)):
                    combat[key] += v
                continue
            names = {f[:-4] for f in os.listdir(os.path.join(out, "result"))}
            bufs = [np.load(os.path.join(out, "result", f"{k}.npy")) for k in names]
            if set(rec) != CONTROL_METRICS \
                    or not set(TrajectoryRecorder.CHANNELS) < names \
                    or not all(b.shape == (done,) and np.isfinite(b).all() for b in bufs):
                raise Mismatch(f"render {mode}: metrics {sorted(rec)}, channels {sorted(names)}")
    log(f"phase {phase} render --mode combat over {combat['episodes']} episodes: "
        f"{combat['frames']} frames in {combat['s']:.3f} s "
        f"({combat['s'] * 1e3 / combat['frames']:.4f} ms/frame), {combat['launches']} missile "
        f"launches, {combat['missiles']} missile lines, {combat['removals']} removals")
    if not combat["missiles"] or not combat["removals"]:
        raise Mismatch(f"render combat: no missile flew to its end in {combat['episodes']} "
                       "episodes")


EXPORT_FRESH = r"""
import sys, torch
with torch.no_grad():
    for art, cases, out in zip(*(sys.argv[i::3] for i in (1, 2, 3))):
        m = torch.export.load(art).module()
        cases = torch.load(cases)
        outs = [m(obs, h, mask) for obs, h, mask in cases]
        obs1, h0, mask = cases[-1]
        outs.append(m(obs1.flip(0), m(obs1, h0, mask)[1], mask))   # two chained calls
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(50):
            m(obs1, h0, mask)
        end.record()
        torch.cuda.synchronize()
        torch.save(outs, out)
        print(start.elapsed_time(end) / 50)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("neuralplane_tpu", "neuralplane_tpu_torch", "jax"))
assert not bad, bad
"""
EXPORT_ABS = 1e-6


def phase_export(phase=30):
    """utils/export.py and scripts/export.py on the card: the results/heading
    actor through the CLI and the results/shoot_1v1 actor (ShootTuple with its
    Beta prior) through export_actor; both artifacts loaded in one fresh
    python process that imports only torch, called at n = 1, 5, 64 and 1000
    and twice chained, against the live policy's deterministic act within
    EXPORT_ABS; each artifact's bytes and its ms per call at n = 1000."""
    import tempfile
    from neuralplane_tpu_torch.algorithms.ppo import PPOPolicy
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.envs import SingleCombatShootEnv
    from neuralplane_tpu_torch.envs.planning import load_low_level_ckpt
    from neuralplane_tpu_torch.scripts import export as export_cli
    from neuralplane_tpu_torch.utils.export import export_actor
    res = os.path.join(REPO, "results")
    dev = torch.device("cuda")
    shoot_env = SingleCombatShootEnv(1, "selfplay_shoot", aero_backend="distilled", device=dev)
    policies = {"heading": PPOPolicy(RLConfig(), 22, 4, device=dev),
                "shoot_1v1": PPOPolicy(RLConfig(use_prior=True), shoot_env.num_observation,
                                       act_space=shoot_env.action_space,
                                       prior_slots=shoot_env.shoot_prior_slots, device=dev)}
    g = torch.Generator(device=dev).manual_seed(30)
    with tempfile.TemporaryDirectory() as tmp:
        argv, want, export_s = [], {}, {}
        for name, policy in policies.items():
            ckpt = os.path.join(res, name, "policy_checkpoint.pkl")
            policy.actor.load_state_dict(load_low_level_ckpt(ckpt))
            art = os.path.join(tmp, f"{name}.pt2")
            t0 = time.perf_counter()
            if name == "heading":
                with no_stdout():
                    export_cli.main(["--checkpoint", ckpt, "--obs-dim", "22", "--out", art])
            else:
                with open(art, "wb") as f:
                    f.write(export_actor(policy))
            export_s[name] = time.perf_counter() - t0
            cases = []
            for n in (1, 5, 64, 1000):
                obs = torch.randn((n, policy.spec.obs_dim), generator=g, device=dev).abs()
                h = torch.randn(policy.init_rnn_states(n)[0].shape, generator=g, device=dev)
                cases.append((obs, h * 0.1, torch.ones((n, 1), device=dev)))
            with torch.no_grad():
                want[name] = [policy.act(*c) for c in cases]
                obs1, h0, mask = cases[-1]
                want[name].append(policy.act(obs1.flip(0), policy.act(obs1, h0, mask)[1], mask))
            torch.save(cases, os.path.join(tmp, f"{name}.in"))
            argv += [art, os.path.join(tmp, f"{name}.in"), os.path.join(tmp, f"{name}.out")]
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", EXPORT_FRESH, *argv], cwd=tmp,
                           capture_output=True, text=True, timeout=300)
        fresh_s = time.perf_counter() - t0
        if r.returncode != 0:
            raise Mismatch(f"phase {phase}: the torch-only process failed: {r.stderr[-2000:]}")
        for name, art, out, ms in zip(policies, argv[0::3], argv[2::3], r.stdout.split()):
            got = torch.load(out)
            err = max(float((a - b).abs().max()) for x, y in zip(got, want[name])
                      for a, b in zip(x, y))
            log(f"phase {phase} export results/{name}: {os.path.getsize(art)} bytes, exported "
                f"in {export_s[name]:.3f} s; in a torch-only process "
                f"{float(ms):.4f} ms per call at n=1000; n = 1, 5, 64, 1000 and two chained "
                f"calls against the live policy: max |err| {err:.2e} (limit {EXPORT_ABS})")
            if not err <= EXPORT_ABS:
                raise Mismatch(f"phase {phase}: the exported {name} actor is {err} away")
    log(f"phase {phase} the torch-only process (start, CUDA, both artifacts) took "
        f"{fresh_s:.3f} s")


def no_stdout():
    """Keep a CLI's own printing out of this script's output."""
    return contextlib.redirect_stdout(io.StringIO())


SUPERVISED_TRAIN_ARGS = ["--env-name", "Control", "--scenario-name", "heading",
                         "--n-rollout-threads", "3000", "--buffer-size", "1000",
                         "--num-mini-batch", "5", "--ppo-epoch", "16", "--lr", "3e-4",
                         "--gamma", "0.99", "--entropy-coef", "1e-3", "--max-grad-norm", "2",
                         "--data-chunk-length", "8", "--log-interval", "1",
                         "--aero-backend", "distilled", "--num-env-steps", str(3000 * 1000)]


def phase_profile_supervise(phase=31):
    """utils/profiling.py around ten main-path steps at 10^6 aircraft (the
    trace must name the env_step kernel) and time_fn over ten more; then
    scripts/supervise.py over one leg of the train CLI at phase 15's
    configuration for one episode: exit 0, the merged metrics.jsonl with its
    step, and the leg's checkpoints/state_latest.pt."""
    import tempfile
    from neuralplane_tpu_torch.envs import ControlEnv
    from neuralplane_tpu_torch.scripts import supervise
    from neuralplane_tpu_torch.utils import profiling
    env = ControlEnv(num_envs=10 ** 6, config="heading", aero_backend="distilled",
                     device="cuda")
    st = [env.reset(0)[0]]
    a = torch.zeros((env.n, 4), device="cuda")

    def step():
        st[0] = env.step(st[0], a)[0]
    step()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            for _ in range(10):
                step()
        size = os.path.getsize(os.path.join(tmp, "trace.json"))
        with open(os.path.join(tmp, "trace.json"), encoding="utf-8") as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    kernels = sorted(n for n in names if "env_step_kernel" in n)
    timed = profiling.time_fn(step, iters=10)
    busy = sum(r[0] for r in device_rows(prof)) / 10
    log(f"phase {phase} profiling.trace over 10 heading steps at 10^6: trace.json {size} "
        f"bytes, env_step kernel events {kernels}, device time {busy:.1f} us/step; "
        f"time_fn {json.dumps(timed)}")
    if not kernels or set(timed) != {"mean_s", "total_s", "iters"}:
        raise Mismatch(f"phase {phase}: the trace names no env_step kernel, or time_fn's keys")
    del env, st
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "sup")
        t0 = time.perf_counter()
        cwd = os.getcwd()
        os.chdir(REPO)   # the child runs `python -m neuralplane_tpu_torch.scripts.train`
        try:
            with no_stdout():
                rc = supervise.main(["--run-dir", run_dir, "--stall-timeout", "600",
                                     "--poll-interval", "1", "--", *SUPERVISED_TRAIN_ARGS])
        finally:
            os.chdir(cwd)
        wall = time.perf_counter() - t0
        with open(os.path.join(run_dir, "metrics.jsonl"), encoding="utf-8") as f:
            rows = [json.loads(line) for line in f]
        ckpt = os.path.exists(os.path.join(run_dir, "leg_0", "checkpoints", "state_latest.pt"))
    log(f"phase {phase} supervise: one leg of the heading train CLI (3000 envs, buffer 1000, "
        f"one episode) in {wall:.3f} s (the child's start included): exit {rc}, merged "
        f"metrics {json.dumps(rows)}, checkpoints/state_latest.pt {ckpt}")
    budget = int(SUPERVISED_TRAIN_ARGS[SUPERVISED_TRAIN_ARGS.index("--num-env-steps") + 1])
    if rc != 0 or len(rows) != 1 or rows[0]["step"] != budget or not ckpt:
        raise Mismatch(f"phase {phase}: the supervised leg exited {rc} with {rows}")

# ---- phases 32-33: data parallelism over torch.distributed ----
def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_world_one(table, phase=32):
    """Phase 15's configuration cut to buffer 104 (the multiple of its
    chunk length 8 nearest above 100) and one episode, trained
    twice from the same seed: without a mesh, then with a world-1 mesh over
    an NCCL group made in this process (the backend rule's choice for one
    rank with a card of its own). Parameters, Adam state and the logged
    metrics must agree bit for bit, and each run launch env_step once per
    collected step (counters set to 0 just before each run)."""
    import tempfile
    import torch.distributed as dist
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.envs import ControlEnv
    from neuralplane_tpu_torch.parallel import card_id, choose_backend, make_mesh
    from neuralplane_tpu_torch.runner import F16SimRunner
    n, T = 3000, 104
    cfg = RLConfig(n_rollout_threads=n, buffer_size=T, data_chunk_length=8,
                   num_mini_batch=5, ppo_epoch=16, lr=3e-4, gamma=0.99,
                   entropy_coef=1e-3, max_grad_norm=2.0, num_env_steps=T * n,
                   log_interval=1, save_interval=1)
    backend = choose_backend([card_id("cuda:0")])
    if backend != "nccl":
        raise Mismatch(f"phase {phase}: the backend rule chose {backend} for one rank")
    runs = {}
    for name in ("plain", "mesh"):
        mesh = None
        if name == "mesh":
            dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                                    world_size=1, rank=0)
            mesh = make_mesh("cuda", owns_group=True)
            backend = dist.get_backend()
        env = ControlEnv(num_envs=n, config="heading", aero_backend="distilled",
                         device="cuda")
        with tempfile.TemporaryDirectory() as run_dir:
            runner = F16SimRunner(env, cfg, run_dir=run_dir, mesh=mesh)
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            runner.close()
            with open(os.path.join(run_dir, "metrics.jsonl"), encoding="utf-8") as f:
                records = [{k: v for k, v in json.loads(line).items()
                            if k not in ("wall_s", "fps")} for line in f]
        opt = runner.trainer.optimizer.state_dict()["state"]
        runs[name] = dict(params=runner.policy.state_dict(), records=records, counts=counts,
                          wall=wall, adam=[opt[i]["exp_avg_sq"] for i in sorted(opt)],
                          stats=dict(mesh.stats) if mesh else None)
        del runner, env
        torch.cuda.empty_cache()
    plain, meshed = runs["plain"], runs["mesh"]
    differ = [k for k, v in plain["params"].items() if not torch.equal(v, meshed["params"][k])]
    adam_same = all(torch.equal(a, b) for a, b in zip(plain["adam"], meshed["adam"]))
    log(f"phase {phase} world size 1 over {backend} in-process, ControlEnv(heading, distilled) "
        f"n={n}, buffer {T}, one episode: without a mesh {plain['wall']:.3f} s, with one "
        f"{meshed['wall']:.3f} s ({meshed['stats']['all_reduce_calls']} all-reduces, "
        f"{meshed['stats']['all_reduce_s']:.4f} s); parameters differing {len(differ)}"
        f"/{len(plain['params'])}, Adam state equal {adam_same}, metrics equal "
        f"{plain['records'] == meshed['records']}; launches {plain['counts']} / "
        f"{meshed['counts']}; metrics {json.dumps(meshed['records'])}")
    for name, run in runs.items():
        check_counts(f"phase {phase} {name} run", run["counts"], {"env_step": T})
    if differ or not adam_same or plain["records"] != meshed["records"] \
            or len(plain["records"]) != 1 or torch.distributed.is_initialized():
        raise Mismatch(f"phase {phase}: the world-1 mesh run is not the run without a mesh "
                       f"(parameters {differ[:3]}, Adam {adam_same})")
    table["env_step"]["launches_world_one"] = meshed["counts"]["env_step"]


WORLD = 2                        # two ranks share the one card (gloo)
GRAD_T, GRAD_N = 16, 512         # the fixed batch of phase 33(a): steps, agents in all
# All-reduced gradient against one process's on the same batch, per leaf
# relative to the leaf's largest |g| (tests/test_torch_distributed.py).
GRAD_REL = 1e-4
IDLE_ALL_REDUCES = 20            # timed gradient all-reduces with the card idle


def fixed_batch(dev, obs_dim: int, act_dim: int, hidden: int):
    """A rollout batch of GRAD_N agents and GRAD_T steps from a generator
    seeded 0 on the card: the same on every rank."""
    from neuralplane_tpu_torch.algorithms.ppo.buffer import RolloutBatch
    g = torch.Generator(device=dev).manual_seed(0)
    T, N = GRAD_T, GRAD_N

    def rand(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=g, device=dev) * scale + shift

    def coin(*shape, p):
        return (torch.rand(shape, generator=g, device=dev) > p).float()
    return RolloutBatch(obs=rand(T + 1, N, obs_dim), actions=rand(T, N, act_dim, scale=0.3),
                        rewards=rand(T, N, 1), masks=coin(T + 1, N, 1, p=0.05),
                        bad_masks=coin(T + 1, N, 1, p=0.02),
                        action_log_probs=rand(T, N, 1, scale=0.1, shift=-4.0),
                        value_preds=rand(T + 1, N, 1), rnn_states_actor=rand(T // 8, N, 1, hidden),
                        rnn_states_critic=rand(T // 8, N, 1, hidden))


def full_batch_grads(trainer, batch):
    """The loss gradient of every chunk of `batch` as one minibatch,
    all-reduced over the trainer's mesh."""
    chunks = trainer.chunks(batch)
    idx = torch.arange(chunks[0].shape[0], device=chunks[0].device)
    trainer._backward(trainer.gather_minibatch(chunks, idx))
    return {k: p.grad.detach().clone() for k, p in trainer.policy.named_parameters()}


def same_on_all_ranks(tensors, mesh) -> bool:
    """Whether this rank's tensors equal rank 0's, bit for bit (one
    broadcast of rank 0's flattened copy)."""
    from neuralplane_tpu_torch.parallel import broadcast
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = flat.clone()
    broadcast([ref], mesh)
    return bool(torch.equal(ref, flat))


def rank_control(mesh, run_dir):
    """33(a) on this rank: phase 15's configuration at 3000 envs in all
    through the CLI's make_env and F16SimRunner.run for one episode, then
    the fixed batch's all-reduced gradient (rank 0 also computes it in one
    process on the whole batch)."""
    import copy
    import dataclasses
    from neuralplane_tpu_torch.algorithms.ppo import PPOTrainer
    from neuralplane_tpu_torch.parallel import all_reduce_sum, barrier, shard_batch
    from neuralplane_tpu_torch.runner import F16SimRunner
    from neuralplane_tpu_torch.scripts import train as train_cli
    args = train_cli.get_parser().parse_args(SUPERVISED_TRAIN_ARGS + ["--use-mesh"])
    args.device = str(mesh.device)
    env = train_cli.make_env(args, mesh=mesh)
    runner = timed_runner(F16SimRunner)(env, train_cli.args_to_config(args), run_dir=run_dir,
                                         mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(mesh.stats)
    zero_counts()
    runner.run()
    torch.cuda.synchronize()
    counts = read_counts()
    stats = {k: mesh.stats[k] - before[k] for k in before}
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    runner.close()
    same = same_on_all_ranks([*runner.policy.parameters()], mesh)

    spec = runner.policy.spec
    hidden = runner.cfg.recurrent_hidden_size
    batch = fixed_batch(mesh.device, env.num_observation, spec.act_dim, hidden)
    local = type(batch)(**{k: shard_batch(v, mesh, axis=1)
                           for k, v in dataclasses.asdict(batch).items()})
    grads = full_batch_grads(runner.trainer, local)
    grad_err = None
    if mesh.rank == 0:
        single = full_batch_grads(PPOTrainer(runner.cfg, copy.deepcopy(runner.policy)), batch)
        grad_err = max(float((grads[k] - w).abs().max() / w.abs().max().clamp_min(1e-30))
                       for k, w in single.items())
    # the gradient's all-reduce alone, both ranks' streams idle: what one
    # call costs without waiting for device work
    flat = torch.zeros(sum(g.numel() for g in grads.values()), device=mesh.device)
    barrier(mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(IDLE_ALL_REDUCES):
        all_reduce_sum([flat], mesh)
    torch.cuda.synchronize()
    idle_ms = (time.perf_counter() - t0) * 1e3 / IDLE_ALL_REDUCES
    return dict(counts=counts, collect_s=runner.times["collect"][0],
                train_s=runner.times["train"][0], peak_mib=peak_mib, stats=stats,
                same_params=same, grad_err=grad_err, n_local=env.n, idle_ms=idle_ms,
                grad_floats=flat.numel())


def rank_selfplay(mesh, run_dir):
    """33(b) on this rank: phase 21's configuration (train_selfplay.sh) at
    1000 envs in all through make_env and SelfplayRunner.run for one
    episode, then one eval_elo at ELO_EVAL_STEPS."""
    from neuralplane_tpu_torch.runner import SelfplayRunner
    from neuralplane_tpu_torch.scripts import train as train_cli
    args = train_cli.get_parser().parse_args(SELFPLAY_TRAIN_ARGS + ["--use-mesh"])
    args.device = str(mesh.device)
    env = train_cli.make_env(args, mesh=mesh)
    runner = timed_runner(SelfplayRunner)(env, train_cli.args_to_config(args),
                                          run_dir=run_dir, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(mesh.stats)
    zero_counts()
    runner.run()
    torch.cuda.synchronize()
    counts = read_counts()
    stats = {k: mesh.stats[k] - before[k] for k in before}
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    t0 = time.perf_counter()
    elo = runner.eval_elo(ELO_EVAL_STEPS)
    eval_s = time.perf_counter() - t0
    runner.close()
    return dict(counts=counts, collect_counts=runner.collect_launches[0],
                collect_s=runner.times["collect"][0], train_s=runner.times["train"][0],
                peak_mib=peak_mib, stats=stats, elo=elo, latest_elo=runner.latest_elo,
                pool=dict(runner.policy_pool), eval_s=eval_s, n_ego=runner.n_ego,
                same_params=same_on_all_ranks([*runner.policy.parameters()], mesh))


def rank_worker(rank: int, port: int, out_dir: str) -> None:
    """One of phase 33's two ranks on the one card, as torchrun would start
    it (LOCAL_RANK, LOCAL_WORLD_SIZE): both publish the card's UUID, so
    the backend rule picks gloo."""
    import torch.distributed as dist
    from neuralplane_tpu_torch.parallel import init_distributed, make_global_mesh
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD))
    torch.set_num_threads(1)   # torchrun's default for several ranks on one host
    init_distributed(f"localhost:{port}", WORLD, rank, device="cuda")
    mesh = make_global_mesh("cuda")
    try:
        result = {"backend": dist.get_backend(), "device": str(mesh.device),
                  "control": rank_control(mesh, os.path.join(out_dir, "control")),
                  "selfplay": rank_selfplay(mesh, os.path.join(out_dir, "selfplay"))}
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_two_ranks(table, phase=33):
    """Two ranks on the one H100 over gloo, spawned from here: (a) phase
    15's configuration at 3000 envs in all (1500 per rank), buffer 1000,
    one episode (env_step 1000 times per rank, parameters equal on both
    ranks after the update, the fixed batch's all-reduced gradient within
    GRAD_REL of one process's on the whole batch); (b) one episode of
    train_selfplay.sh's configuration at 1000 envs in all and one eval_elo
    at ELO_EVAL_STEPS (nlplant_distilled 11 times per collected step per
    rank, equal latest_elo and pool ratings on both ranks); (c) the train
    CLI under torch.distributed.run with two ranks at a small Control
    configuration (exit 0, one metrics.jsonl, written by rank 0, with the
    global step count)."""
    import tempfile
    import torch.multiprocessing as mp
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        mp.start_processes(rank_worker, args=(free_port(), out_dir), nprocs=WORLD,
                           join=True, start_method="spawn")
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(WORLD)]
    T, n_all = 1000, 3000
    ctl = [r["control"] for r in ranks]
    for r, c in enumerate(ctl):
        log(f"phase {phase}a rank {r} on {ranks[r]['device']} over {ranks[r]['backend']}: "
            f"{c['n_local']} envs, collect {c['collect_s'] * 1e3 / T:.4f} ms/step "
            f"({c['collect_s']:.3f} s), update {c['train_s']:.3f} s, peak device memory "
            f"{c['peak_mib']:.1f} MiB, all-reduces {c['stats']['all_reduce_calls']} in "
            f"{c['stats']['all_reduce_s']:.4f} s (host time in the calls, waits for "
            f"device work included), launches {c['counts']}; one all-reduce of the "
            f"{c['grad_floats']} gradient floats with the card idle "
            f"{c['idle_ms']:.3f} ms ({IDLE_ALL_REDUCES} calls)")
    slowest = max(c["collect_s"] + c["train_s"] for c in ctl)
    log(f"phase {phase}a two ranks, ControlEnv(heading, distilled) {n_all} envs in all, "
        f"buffer {T}, one episode: {T * n_all / slowest:.4e} training agent-steps/s in all "
        f"(slowest rank {slowest:.3f} s); parameters equal on both ranks "
        f"{[c['same_params'] for c in ctl]}; fixed batch ({GRAD_T} steps x {GRAD_N} agents) "
        f"all-reduced gradient vs one process: max |err| / leaf max {ctl[0]['grad_err']:.3e} "
        f"(limit {GRAD_REL}); spawn to join {spawn_s:.1f} s")
    for r, c in enumerate(ctl):
        check_counts(f"phase {phase}a rank {r}", c["counts"], {"env_step": T})
    if not all(c["same_params"] for c in ctl) or not ctl[0]["grad_err"] <= GRAD_REL \
            or any(r["backend"] != "gloo" for r in ranks):
        raise Mismatch(f"phase {phase}a: parameters differ between the ranks, the gradient "
                       f"is off, or the backend is not gloo")
    sp = [r["selfplay"] for r in ranks]
    for r, c in enumerate(sp):
        log(f"phase {phase}b rank {r}: {c['n_ego']} ego agents, collect "
            f"{c['collect_s'] * 1e3 / T:.4f} ms/step ({c['collect_s']:.3f} s), update "
            f"{c['train_s']:.3f} s, peak device memory {c['peak_mib']:.1f} MiB, all-reduces "
            f"{c['stats']['all_reduce_calls']} in {c['stats']['all_reduce_s']:.4f} s, "
            f"launches in the run {c['counts']}, in the collect {c['collect_counts']}; "
            f"eval_elo {ELO_EVAL_STEPS} steps in {c['eval_s']:.3f} s: {json.dumps(c['elo'])}, "
            f"pool {json.dumps(c['pool'])}")
    slowest = max(c["collect_s"] + c["train_s"] for c in sp)
    log(f"phase {phase}b two ranks, 1v1 self-play 1000 envs in all: "
        f"{T * sum(c['n_ego'] for c in sp) / slowest:.4e} training agent-steps/s in all "
        f"(slowest rank {slowest:.3f} s); latest_elo and pool equal on both ranks "
        f"{sp[0]['latest_elo'] == sp[1]['latest_elo'] and sp[0]['pool'] == sp[1]['pool']}, "
        f"parameters equal {[c['same_params'] for c in sp]}")
    for r, c in enumerate(sp):
        check_counts(f"phase {phase}b rank {r} collect", c["collect_counts"],
                     {"nlplant_distilled": 11 * T})
    if sp[0]["latest_elo"] != sp[1]["latest_elo"] or sp[0]["pool"] != sp[1]["pool"] \
            or not all(c["same_params"] for c in sp) or not math.isfinite(sp[0]["latest_elo"]):
        raise Mismatch(f"phase {phase}b: the ranks' ELO, pool or parameters differ")
    table["env_step"]["launches_two_ranks_per_rank"] = ctl[0]["counts"]["env_step"]
    table["nlplant_distilled"]["launches_two_ranks_selfplay_per_rank"] = \
        sp[0]["collect_counts"]["nlplant_distilled"]
    phase_torchrun(phase)


TORCHRUN_ARGS = ["--env-name", "Control", "--scenario-name", "heading",
                 "--n-rollout-threads", "200", "--buffer-size", "100",
                 "--data-chunk-length", "10", "--num-env-steps", str(2 * 200 * 100),
                 "--ppo-epoch", "2", "--num-mini-batch", "2", "--log-interval", "1",
                 "--aero-backend", "distilled"]


def phase_torchrun(phase=33):
    """(c): `python -m torch.distributed.run --standalone --nproc-per-node 2
    -m neuralplane_tpu_torch.scripts.train --use-mesh` at a small Control
    configuration (200 envs in all, buffer 100, two episodes) on the card."""
    import subprocess
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(WORLD), "-m", "neuralplane_tpu_torch.scripts.train",
               *TORCHRUN_ARGS, "--use-mesh", "--run-dir", run_dir]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        out = proc.stdout + proc.stderr
        records = []
        if os.path.exists(os.path.join(run_dir, "metrics.jsonl")):
            with open(os.path.join(run_dir, "metrics.jsonl"), encoding="utf-8") as f:
                records = [json.loads(line) for line in f]
    backends = sorted(set(re.findall(r"backend (\w+)", out)))
    log(f"phase {phase}c torch.distributed.run, 2 ranks, the train CLI --use-mesh (Control, "
        f"200 envs in all, buffer 100, two episodes): exit {proc.returncode} in {wall:.1f} s, "
        f"backends {backends}, metrics steps {[r.get('step') for r in records]}")
    if proc.returncode != 0 or [r["step"] for r in records] != [20000, 40000] \
            or backends != ["gloo"]:
        raise Mismatch(f"phase {phase}c: the CLI under torch.distributed.run failed: "
                       f"{out[-3000:]}")


# Phase 34: the throughput harness (measure.py, scripts/bench.py). The CLI
# runs at the JAX package's headline width and the default steps of this
# script; the sweeps are cut in depth only (50 heading steps per row, the
# combat sweep to 10^5 aircraft at 20 steps per row; the JAX protocol is
# 500 and 200 steps to 10^6, run outside this script, results/bench_torch).
BENCH_CLI_KEYS = {"metric", "value", "unit", "vs_baseline", "aero_backend", "device"}
BENCH_SWEEP_STEPS = 50
BENCH_COMBAT_MAX_EXP = 5
BENCH_COMBAT_STEPS = 20
# env name -> (agents per env group, FDM steps per env step, xdot launches
# per env step); the reset launches the xdot kernel once
BENCH_COMBAT = {"SingleCombat": (2, 5, 11), "SingleCombatShoot": (2, 5, 11),
                "MultipleCombat": (4, 1, 3), "MultipleCombatShoot": (4, 1, 3)}
# the 1v1 steps on the 43 nets (aero_backend="pallas")
BENCH_PALLAS_N = (10 ** 3, 10 ** 5)


def held_action(env, name: str) -> torch.Tensor:
    """measure_combat_step's action: mid-bin demands with the shoot bit
    held high on the missile envs, the near-trim action on the others."""
    row = [20.0, 20.0, 20.0, 20.0, 1.0] if name.endswith("Shoot") else [1.0, 0.0, 0.0, 0.0]
    return torch.tensor([row], device="cuda").repeat(env.n, 1)


def phase_bench_cli(table, n: int, steps: int, phase=34) -> None:
    """(a): `python -m neuralplane_tpu_torch.scripts.bench --aero distilled`
    and `--aero pallas` in a subprocess (the build cached by phase 2): exit
    0, the last line's keys, its s/step beside phases 6 and 12's."""
    for aero, key in (("distilled", "env_step"), ("pallas", "env_step_grouped")):
        cmd = [sys.executable, "-m", "neuralplane_tpu_torch.scripts.bench", "--aero", aero,
               "--n", str(n), "--steps", str(steps)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise Mismatch(f"phase {phase}a: the bench CLI --aero {aero} exited "
                           f"{proc.returncode}: {(proc.stdout + proc.stderr)[-3000:]}")
        last = json.loads(proc.stdout.strip().splitlines()[-1])
        ms, main_ms = last["value"] * 1e3, table[key]["step_ms"]
        log(f"phase {phase}a bench CLI --aero {aero} --n {n} --steps {steps}: exit 0 in "
            f"{wall:.1f} s, {json.dumps(last)}; {ms:.4f} ms/step against "
            f"{main_ms:.4f} in phase {6 if aero == 'distilled' else 12} "
            f"(ratio {ms / main_ms:.3f})")
        if set(last) != BENCH_CLI_KEYS or last["aero_backend"] != aero \
                or last["device"] != torch.cuda.get_device_name(0):
            raise Mismatch(f"phase {phase}a: the CLI's last line {last}")
        if not 2 / 3 <= ms / main_ms <= 1.5:
            raise Mismatch(f"phase {phase}a: the CLI's {ms:.4f} ms/step is not the main "
                           f"path's {main_ms:.4f}")


def phase_bench_sweep(table, phase=34) -> None:
    """(b): measure_sweep to 10^6 aircraft, BENCH_SWEEP_STEPS steps per row:
    env_step once per step and at the warm-up, nothing else, per row; the
    state finite."""
    from neuralplane_tpu_torch.measure import measure_sweep
    total = 0
    zero_counts()
    for e, row in enumerate(measure_sweep(max_exp=6, steps=BENCH_SWEEP_STEPS)):
        counts = read_counts()
        zero_counts()
        log(f"phase {phase}b {json.dumps(row)} launches {counts}")
        if "error" in row or not row["finite"] or row["n"] != 10 ** e:
            raise Mismatch(f"phase {phase}b: heading sweep row {row}")
        check_counts(f"heading sweep n={row['n']}", counts,
                     {"env_step": BENCH_SWEEP_STEPS + 1})
        total += counts["env_step"]
    table["env_step"]["launches_bench_sweep"] = total


def phase_bench_combat_sweep(table, phase=34) -> None:
    """(c): measure_combat_sweep over the four envs to 10^BENCH_COMBAT_MAX_EXP
    aircraft, BENCH_COMBAT_STEPS steps per row: nlplant_distilled 11 (1v1)
    or 3 (team) times per step, at the warm-up and once at the reset,
    nothing else, per row; n rounded down to whole env groups and the inner
    FDM steps as on the CPU; then one step of each env under CUDA's sync
    debug mode."""
    from neuralplane_tpu_torch.measure import measure_combat_step, measure_combat_sweep
    want = [(name, 10 ** e) for name in BENCH_COMBAT
            for e in range(1, BENCH_COMBAT_MAX_EXP + 1)]
    total = 0
    zero_counts()
    rows = measure_combat_sweep(max_exp=BENCH_COMBAT_MAX_EXP, steps=BENCH_COMBAT_STEPS)
    for (name, asked), row in zip(want, rows, strict=True):
        counts = read_counts()
        zero_counts()
        agents, inner, per_step = BENCH_COMBAT[name]
        log(f"phase {phase}c {json.dumps(row)} launches {counts}")
        groups = max(1, asked // agents)
        if "error" in row or not row["finite"] or row["env"] != name \
                or (row["n"], row["num_envs"], row["inner_fdm_steps"]) != \
                (groups * agents, groups, inner):
            raise Mismatch(f"phase {phase}c: combat sweep row {row} for {name} at n={asked}")
        check_counts(f"{name} sweep n={row['n']}", counts,
                     {"nlplant_distilled": 1 + per_step * (BENCH_COMBAT_STEPS + 1)})
        total += counts["nlplant_distilled"]
    table["nlplant_distilled"]["launches_bench_combat_sweep"] = total
    for name in BENCH_COMBAT:
        r = measure_combat_step(10 ** 3, steps=1, env_name=name)
        env = r["env_obj"]
        step_under_sync_debug(env, r["state"], held_action(env, name), f"the {name} step")
        log(f"phase {phase}c one measured {name} step under sync debug mode 'error': "
            f"no host sync OK")


def phase_bench_pallas(table, phase=34) -> None:
    """(d): measure_combat_step for the 1v1 envs on aero_backend="pallas" at
    BENCH_PALLAS_N aircraft: nlplant_grouped 11 times per step, at the
    warm-up and once at the reset, nothing else; at the larger size one step
    against the same step with the plain 43-net xdot (combat_step_vs_plain)."""
    from neuralplane_tpu_torch.measure import measure_combat_step
    total = 0
    for name in ("SingleCombat", "SingleCombatShoot"):
        for n in BENCH_PALLAS_N:
            zero_counts()
            r = measure_combat_step(n, steps=BENCH_COMBAT_STEPS, env_name=name,
                                    aero_backend="pallas")
            counts = read_counts()
            env = r["env_obj"]
            row = {k: v for k, v in r.items() if k not in ("env_obj", "state", "out")}
            log(f"phase {phase}d {json.dumps(row)} aero_backend=pallas launches {counts}")
            check_counts(f"{name} pallas n={n}", counts,
                         {"nlplant_grouped": 1 + 11 * (BENCH_COMBAT_STEPS + 1)})
            if not r["finite"] or not is_grouped(env.model.weights):
                raise Mismatch(f"phase {phase}d: {name} on pallas: {row}")
            total += counts["nlplant_grouped"]
            if n == BENCH_PALLAS_N[-1]:
                combat_step_vs_plain(env, f"{name}(pallas)", phase=phase)
            del r, env
    table["nlplant_grouped"]["launches_bench_combat_pallas"] = total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10 ** 6, help="aircraft per batch")
    ap.add_argument("--steps", type=int, default=200, help="timed main-path steps")
    ap.add_argument("--portable-n", type=int, default=65536)
    ap.add_argument("--train-episodes", type=int, default=2,
                    help="PPO episodes (collect + update) of phase 15")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    from neuralplane_tpu_torch.ops import cuda_build
    from neuralplane_tpu_torch.ops.aero import load_distilled, select_aero_weights

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log(f"phase 1 card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built = cuda_build.build()
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'cached'})")
    for name in cuda_build.SOURCES:
        with open(cuda_build.library_path(name) + ".log", encoding="utf-8") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    g = torch.Generator(device=dev).manual_seed(0)
    w = load_distilled(device=dev)
    table = {}
    phase_nlplant(w, args.n, g, dev, table)
    phase_trunk_yardstick(w, args.n, dev, table)
    phase_step(w, args.n, g, dev, table)
    phase_draws(w, args.n, g, dev, table)
    phase_main(args.n, args.steps, table)
    phase_portable(args.portable_n, table)

    gw = select_aero_weights("pallas", device=dev)
    phase_sweep(gw, args.n, g, dev, table)
    phase_sweep_yardstick(gw, args.n, dev, table)
    log_sass_net_loops()
    phase_step(gw, args.n, g, dev, table, key="env_step_grouped", phase=9)
    phase_draws(gw, args.n, g, dev, table, key="env_step_grouped", phase=10)
    phase_task(gw, args.n, g, dev, table)
    r = phase_main(args.n, args.steps, table, backend="pallas", key="env_step_grouped",
                   phase=12)
    phase_portable(args.portable_n, table, backend="pallas", key="nlplant_grouped",
                   phase=13)
    phase_stacked(args.portable_n)
    phase_public(r, table)
    del r
    phase_train(args.train_episodes, table)
    phase_fly(table)
    t0 = time.perf_counter()
    phase_planning_train(table)
    phase_planning_fly(table)
    phase_policies(table)
    log(f"phases 17-19: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    phase_combat(table)
    phase_selfplay_train(table)
    phase_selfplay_fly(table)
    log(f"phases 20-22: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    phase_shoot(table)
    phase_shoot_train(table, team=False, phase=24)
    phase_shoot_train(table, team=True, phase=25)
    phase_shoot_fly(table)
    log(f"phases 23-26: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    phase_distill(table)
    phase_tables()
    log(f"phases 27-28: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    phase_render(table)
    phase_export()
    phase_profile_supervise()
    log(f"phases 29-31: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    phase_world_one(table)
    phase_two_ranks(table)
    log(f"phases 32-33: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    phase_bench_cli(table, args.n, args.steps)
    phase_bench_sweep(table)
    phase_bench_combat_sweep(table)
    phase_bench_pallas(table)
    log(f"phase 34: {time.perf_counter() - t0:.1f} s wall")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall in all")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in table.values():
        missing = [key for key in keys if key not in k]
        if missing:
            raise Mismatch(f"{k['name']}: the kernel table lacks {missing}")
        if k["launches"] < 1:
            raise Mismatch(f"{k['name']} was not launched on its path")
    log(card)
    print(json.dumps({"kernels": list(table.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
