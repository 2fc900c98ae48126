"""Train the consolidated aero surrogate (surrogates/distill.py) on the card
and write its npz (counterpart of the repo-root scripts/distill_aero.py).

    python -m neuralplane_tpu_torch.scripts.distill_aero [--hidden 128]
        [--steps 20000] [--gate 0.999] [--out runs/distill/f16_aero_distilled.npz]

The README's configuration of the shipped net is `--hidden 256 --steps
80000`. Prints the fit's time per step, the per-coefficient R^2 against the
43-net ensemble (bf16-quantized, as the kernels compute it) and the per-row
xdot R^2 of the acceptance gate, and refuses to write the npz if the minimum
xdot R^2 misses the gate (exit code 1). The raw z-space parameters are saved
beside the npz (`distill_params_raw.npz`) before any evaluation. Nothing is
written under the package's `data/` directory; `ops/aero.load_distilled(path)`
reads the result, and the CUDA kernels take it at --hidden 256 only.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

DEFAULT_OUT = os.path.join("runs", "distill", "f16_aero_distilled.npz")


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("neuralplane_tpu_torch.distill_aero")
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gate", type=float, default=0.999)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--log-every", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)

    from ..ops.aero import AERO_NAMES, load_aero_weights
    from ..surrogates import distill

    w43 = load_aero_weights(device=args.device)
    sync = torch.cuda.synchronize if w43.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    params, mean, std = distill.fit(
        w43, hidden=args.hidden, steps=args.steps, batch=args.batch, lr=args.lr,
        seed=args.seed, log_every=args.log_every)
    sync()
    wall = time.perf_counter() - t0
    print(f"fit: {args.steps} steps in {wall:.3f} s ({wall * 1e3 / max(args.steps, 1):.4f} "
          f"ms/step, the output statistics included) on {w43.device}")

    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    # crash insurance: raw z-space params saved before any gating/eval
    np.savez(os.path.join(out_dir, "distill_params_raw.npz"),
             **{k: v.cpu().numpy() for k, v in params._asdict().items()},
             out_mean=mean, out_std=std)

    rep = distill.evaluate(w43, params, mean, std)
    rep_f32 = distill.evaluate(w43, params, mean, std, quantized=False)
    print(f"[f32 fit]   min coeff R2 = {rep_f32['r2_min']:.6f} ({rep_f32['worst']})")
    for name, r2, mx in zip(AERO_NAMES, rep["r2"], rep["max_abs"]):
        print(f"  {name:18s} R2 {r2:.6f}  max|err| {mx:.5f}")
    print(f"[quantized] min coeff R2 = {rep['r2_min']:.6f} ({rep['worst']})")

    fid = distill.xdot_fidelity(w43, params, mean, std)
    rep.update(fid)
    print("xdot R2 per row:", np.round(fid["xdot_r2"], 6))
    print(f"xdot R2 min = {fid['xdot_r2_min']:.6f} (gate {args.gate})")
    if fid["xdot_r2_min"] < args.gate:
        print(f"FAILED xdot gate {args.gate}; not writing npz", file=sys.stderr)
        return 1
    distill.to_npz(args.out, params, mean, std, rep)
    print(f"wrote {args.out} (hidden={args.hidden}, xdot R2 min {fid['xdot_r2_min']:.6f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
