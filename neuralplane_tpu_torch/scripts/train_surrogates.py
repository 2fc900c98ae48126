"""CLI: train the 43 aero surrogates from the NASA tables and write
f16_aero.npz (counterpart of neuralplane_tpu/scripts/train_surrogates.py).

Point it at a directory holding the public NASA .dat tables: it trains every
surrogate with the reference recipe on the card, reports each
coefficient's test R^2 (an optional CSV), and assembles the stacked weight
file that both packages' `load_aero_weights(path)` read.

  python -m neuralplane_tpu_torch.scripts.train_surrogates \
      --data-dir /path/to/nasa_tables --out f16_aero.npz --epochs 1000
"""
from __future__ import annotations

import argparse
import csv


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("neuralplane_tpu_torch.train_surrogates")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out", default="f16_aero_retrained.npz")
    p.add_argument("--names", nargs="*", default=None,
                   help="subset of coefficients (default: all 43)")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--subdivide", type=int, default=3)
    p.add_argument("--r2-gate", type=float, default=0.97)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--report", default=None,
                   help="CSV of per-coefficient R^2 (model_name.csv analogue)")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)

    from ..surrogates import assemble_stacked_weights, train_all

    results = train_all(args.data_dir, names=args.names, seed=args.seed,
                        epochs=args.epochs, subdivide=args.subdivide,
                        r2_gate=args.r2_gate, device=args.device)

    if args.report:
        with open(args.report, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["name", "test_r2", "passed"])
            for name, r in results.items():
                w.writerow([name, f"{r['test_r2']:.6f}", r["passed"]])

    failed = [n for n, r in results.items() if not r["passed"]]
    if failed:
        print(f"WARNING: {len(failed)} surrogates below the R^2 gate: "
              f"{failed} - stacked weights NOT written")
        return
    if args.names:
        print("Subset trained; stacked assembly needs all 43 - skipping")
        return
    assemble_stacked_weights(results, args.out)
    print(f"Wrote {args.out}")


if __name__ == "__main__":
    main()
