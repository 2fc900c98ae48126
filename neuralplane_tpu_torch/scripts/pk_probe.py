"""Per-shot kill-probability probe: does a trained policy evade missiles?
(counterpart of tools/pk_probe.py)

Two actors head to head in a missile env; for each side, the missiles fired
and the summed pk they delivered (the envs' `shoot/fire_vec` and
`shoot/pk_dealt_vec`): their ratio is the per-shot kill probability against
the other side (a missile that never detonates adds 0). A policy that
learned to break incoming shots shows a lower Pk against it than a
random-init defender under the same attacker. `SingleCombatShoot` and the
team game `MultipleCombatShoot` (with a `multiple_*` scenario) alike.

  python -m neuralplane_tpu_torch.scripts.pk_probe --ckpt-dir runs/x/checkpoints \\
      --ego 78 --opponent random --scenario selfplay_shoot_evadable \\
      --num-envs 256 --steps 3000 --stochastic both --use-prior

The flags and the last line's keys (`ego_fired, opp_fired, ego_wins,
opp_wins, pk_by_ego, pk_by_opp, pk_against_ego, pk_against_opp, episodes,
ego, opponent, scenario`) are the JAX tool's, plus `--device` (default
`cuda`). Checkpoints resolve as in `scripts/ladder_probe.py`.
`--opponent random` is a fresh actor from `PPOPolicy.init_actor_params`
drawn from a `torch.Generator` seeded with `--seed + 99`: the JAX tool's
random init in distribution (the same initializers), not the same draw.
The match loop is `ladder_probe.match_steps`: tallies on the device, one
read after the last step.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch

from ..envs import MultipleCombatShootEnv, SingleCombatShootEnv
from .ladder_probe import PK_KEYS, add_net_flags, load_actor, make_policy, play_match


def run_match(env, policy, ego_actor, opp_actor, steps: int, seed: int,
              stochastic: bool = True) -> dict:
    """A head-to-head; returns the per-side weapon totals and outcomes of
    tools/pk_probe.py's `run_match`."""
    t = play_match(env, policy, ego_actor, opp_actor, steps, seed, stochastic)
    tot = {k: t[k] for k in sorted(PK_KEYS)}
    tot["pk_against_ego"] = tot["pk_by_opp"] / max(tot["opp_fired"], 1.0)
    tot["pk_against_opp"] = tot["pk_by_ego"] / max(tot["ego_fired"], 1.0)
    return tot


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("neuralplane_tpu_torch.pk_probe")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--ego", default="latest")
    p.add_argument("--opponent", default="random",
                   help="'random' = fresh random-init actor, else a pool checkpoint name")
    p.add_argument("--scenario", default="selfplay_shoot_evadable")
    p.add_argument("--env", default="SingleCombatShoot",
                   choices=["SingleCombatShoot", "MultipleCombatShoot"],
                   help="team probe: MultipleCombatShoot + a multiple_* scenario")
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use-prior", action="store_true")
    p.add_argument("--stochastic", default="both", choices=["none", "both"])
    add_net_flags(p)
    return p


def main(argv: Optional[list] = None) -> dict:
    args = get_parser().parse_args(argv)
    env_cls = (MultipleCombatShootEnv if args.env == "MultipleCombatShoot"
               else SingleCombatShootEnv)
    env = env_cls(num_envs=args.num_envs, config=args.scenario, device=args.device)
    policy = make_policy(args, env)
    ego = load_actor(policy, args.ckpt_dir, args.ego)
    if args.opponent == "random":
        opp = policy.init_actor_params(torch.Generator().manual_seed(args.seed + 99))
        opp = opp.to(policy.device).requires_grad_(False)
    else:
        opp = load_actor(policy, args.ckpt_dir, args.opponent)
    tot = run_match(env, policy, ego, opp, args.steps, args.seed,
                    stochastic=args.stochastic == "both")
    tot.update(ego=args.ego, opponent=args.opponent, scenario=args.scenario)
    print(json.dumps(tot), flush=True)
    return tot


if __name__ == "__main__":
    main(sys.argv[1:])
