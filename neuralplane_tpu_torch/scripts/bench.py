"""Throughput CLI of the port (counterpart of the repo's root bench.py): the
F-16 heading env step at 10^6 aircraft, and the sweeps of measure.py.

  python -m neuralplane_tpu_torch.scripts.bench [--n 1000000] [--steps 500]
      [--sweep] [--combat-sweep] [--combat-max-exp 6]
      [--aero auto|pallas|stacked|distilled] [--device cuda]

The last line of stdout is one JSON object with bench.py's keys, `metric`
(f16_heading_env_step_1M_agents), `value` (s/step at --n), `unit`,
`vs_baseline` and `aero_backend`, and one more, `device`: the card's name
(`cpu` with --device cpu). The sweep rows go to stderr, one JSON line per
row as it finishes: the heading step at n = 10^0 .. 10^6 for
min(--steps, 500) steps, the four combat envs at n = 10^1 ..
10^--combat-max-exp for min(--steps, 200) steps.

`vs_baseline` is 0.2103 s / value. 0.2103 s/step at 10^6 aircraft is the
reference implementation's own figure on an unnamed GPU (BASELINE.md); it
is not a measurement of this port nor of the card it runs on.

The default device is the card; without one the run fails (no CPU
fallback). `--device cpu` runs the kernels' plain versions, for a quick look
at the protocol at small sizes.
"""
from __future__ import annotations

import argparse
import json
import sys

BASELINE_S_PER_STEP_1M = 0.2103


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("neuralplane_tpu_torch.bench")
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--sweep", action="store_true",
                   help="also print the heading step at n = 10^0..10^6 to stderr")
    p.add_argument("--combat-sweep", action="store_true",
                   help="also print the combat and missile envs (SingleCombat[Shoot], "
                        "MultipleCombat[Shoot] at n = 10^1..10^max) to stderr")
    p.add_argument("--combat-max-exp", type=int, default=6)
    p.add_argument("--aero", default="auto",
                   choices=["auto", "pallas", "stacked", "distilled"],
                   help="aero backend of the headline step; 'auto' = distilled")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    from ..measure import measure_combat_sweep, measure_env_step, measure_sweep

    if args.sweep:
        for row in measure_sweep(steps=min(args.steps, 500), device=args.device):
            print(json.dumps(row), file=sys.stderr, flush=True)
    if args.combat_sweep:
        for row in measure_combat_sweep(max_exp=args.combat_max_exp,
                                        steps=min(args.steps, 200), device=args.device):
            print(json.dumps(row), file=sys.stderr, flush=True)

    res = measure_env_step(args.n, steps=args.steps, aero_backend=args.aero,
                           device=args.device)
    print(json.dumps({
        "metric": "f16_heading_env_step_1M_agents",
        "value": round(res["s_per_step"], 6),
        "unit": "s/step",
        "vs_baseline": round(BASELINE_S_PER_STEP_1M / res["s_per_step"], 2),
        "aero_backend": args.aero,
        "device": res["device"],
    }))


if __name__ == "__main__":
    main()
