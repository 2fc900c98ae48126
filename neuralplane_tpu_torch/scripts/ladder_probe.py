"""Skill-vs-age ladder probe: a final policy against single historical
checkpoints, head to head (counterpart of tools/ladder_probe.py).

The per-episode average reward of each side under the reference eval
protocol (`runner/selfplay_F16sim_runner.py:197-228`) with an explicit
opponent, and the diff (final - opponent) against a tie band. Works on the
1v1 and the team combat envs, with or without missiles: the ego team flies
the final actor, the enemy team the historical one.

  python -m neuralplane_tpu_torch.scripts.ladder_probe --ckpt-dir runs/x/checkpoints \\
      --opponents 1 10 --env SingleCombat --scenario selfplay --tie-band 1.0

Flags, the per-row JSON keys (`opponent, ego_avg, opp_avg, diff, episodes,
ego_wins, opp_wins, verdict`) and the last line (`{"ladder": rows}`) are the
JAX tool's, plus `--device` (default `cuda`; `--device cpu` runs the
kernels' plain versions). Actors resolve as the render CLI's
`_resolve_pool_ckpt` does: `actor_<name>` or `state_<name>`, the port's `.pt`
or the JAX package's `.pkl` (a whole TrainState or an actor-only pickle),
read without JAX. A committed `results/*/policy_checkpoint*.pkl` is flown
through a directory of links named as pool entries
(`actor_final.pkl -> .../policy_checkpoint_2e9.pkl`).

The match loop (`match_init`, `match_steps`) serves this tool and
`scripts/pk_probe.py`: every tally stays on the device, and the host reads
them once, after the last step. The action draws come from a
`torch.Generator` seeded with `--seed` (the env's reset from the same
seed), not the JAX tool's threefry keys: the same protocol, other samples.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, Optional

import torch

from ..algorithms.networks import first_mismatch
from ..algorithms.ppo import PPOPolicy
from ..algorithms.rl_config import RLConfig
from ..envs import MultipleCombatEnv, MultipleCombatShootEnv, SingleCombatEnv, \
    SingleCombatShootEnv
from ..envs.planning import load_low_level_ckpt
from ..runner.selfplay import team_merge, team_split
from ..utils.config import load_config
from .render import _resolve_pool_ckpt

ENVS = {
    "SingleCombat": (SingleCombatEnv, "selfplay"),
    "SingleCombatShoot": (SingleCombatShootEnv, "selfplay_shoot"),
    "MultipleCombat": (MultipleCombatEnv, "multiple_selfplay"),
    "MultipleCombatShoot": (MultipleCombatShootEnv, "multiple_selfplay_shoot"),
}

# the match's device tallies: the ladder's (tools/ladder_probe.py:60-146)
# and the pk probe's (tools/pk_probe.py:35-98)
LADDER_KEYS = ("ego_sum", "opp_sum", "resets", "ladder_ego_wins", "ladder_opp_wins")
PK_KEYS = ("ego_fired", "opp_fired", "pk_by_ego", "pk_by_opp", "ego_wins", "opp_wins",
           "episodes")


def load_actor(policy: PPOPolicy, ckpt_dir: str, name: str) -> torch.nn.Module:
    """One actor of `policy`'s kind, on its device, from the checkpoint the
    pool name resolves to; a shape that differs from the policy's is an
    error naming the first leaf."""
    path = _resolve_pool_ckpt(ckpt_dir, name)
    params = load_low_level_ckpt(path)
    actor = policy.init_actor_params(torch.Generator().manual_seed(0))
    bad = first_mismatch(params, actor.state_dict())
    if bad is not None:
        raise ValueError(f"{path} does not match this policy's actor: first difference "
                         f"at {bad}")
    actor.load_state_dict(params)
    return actor.to(policy.device).requires_grad_(False)


@dataclasses.dataclass
class MatchCarry:
    env_state: object
    ego_obs: torch.Tensor
    opp_obs: torch.Tensor
    h_ego: torch.Tensor
    h_opp: torch.Tensor
    masks: torch.Tensor            # [n_ego, 1], both sides'
    cum_ego: torch.Tensor          # running episode reward per ego row
    cum_opp: torch.Tensor
    tallies: Dict[str, torch.Tensor]
    generator: torch.Generator


def match_init(env, policy: PPOPolicy, seed: int) -> MatchCarry:
    """Reset the env from `seed`, zero the memories and the tallies (float64
    on the env's device)."""
    env_state, obs = env.reset(seed)
    ego_obs, opp_obs = team_split(env, obs)
    n_ego = env.num_envs * (env.num_agents // 2)
    h, _ = policy.init_rnn_states(n_ego)
    dev = obs.device
    zero = torch.zeros((n_ego, 1), dtype=torch.float32, device=dev)
    tallies = {k: torch.zeros((), dtype=torch.float64, device=dev)
               for k in LADDER_KEYS + PK_KEYS}
    return MatchCarry(env_state=env_state, ego_obs=ego_obs, opp_obs=opp_obs, h_ego=h,
                      h_opp=torch.zeros_like(h), masks=zero + 1.0, cum_ego=zero,
                      cum_opp=zero.clone(), tallies=tallies,
                      generator=torch.Generator(device=dev).manual_seed(seed))


@torch.no_grad()
def match_steps(env, ego_actor, opp_actor, carry: MatchCarry, steps: int,
                sample: bool) -> MatchCarry:
    """`steps` steps of the head-to-head, both sides sampling or both
    playing the mode; makes no host sync. Per step, as both JAX tools: a
    group resets when any agent is done, bad-done or over the time limit;
    its memories are zeroed and the masks (both sides') are 1 - reset; the
    per-side episode rewards are emitted at the reset; `done` at the reset
    is the side's win."""
    num_envs, m = env.num_envs, env.num_agents
    half = m // 2
    c, t = carry, carry.tallies
    for _ in range(steps):
        outs = []
        for actor, obs, h in ((ego_actor, c.ego_obs, c.h_ego), (opp_actor, c.opp_obs, c.h_opp)):
            dist, h = actor.dist_step(obs, h, c.masks)
            outs.append((dist.sample(c.generator) if sample else dist.mode(), h))
        (a_e, h_e), (a_o, h_o) = outs
        c.env_state, out = env.step(c.env_state, team_merge(env, a_e, a_o))
        ended = out.done | out.bad_done | out.exceed_time_limit
        per_env = ended.reshape(num_envs, m).any(dim=1)
        reset_b = per_env[:, None].expand(-1, half).reshape(-1, 1)
        reset = reset_b.float()
        keep = 1.0 - reset
        e_rew, o_rew = team_split(env, out.reward[:, None])
        cum_e, cum_o = c.cum_ego + e_rew, c.cum_opp + o_rew
        e_done, o_done = team_split(env, out.done[:, None])
        e_win = (e_done & reset_b).reshape(num_envs, half)
        o_win = (o_done & reset_b).reshape(num_envs, half)
        t["ego_sum"] += (cum_e * reset).sum()
        t["opp_sum"] += (cum_o * reset).sum()
        t["resets"] += reset.sum()
        t["ladder_ego_wins"] += e_win.any(dim=1).sum()
        t["ladder_opp_wins"] += o_win.any(dim=1).sum()
        t["ego_wins"] += e_win.sum()
        t["opp_wins"] += o_win.sum()
        t["episodes"] += per_env.sum()
        if "shoot/fire_vec" in out.info:
            fire_e, fire_o = team_split(env, out.info["shoot/fire_vec"][:, None])
            pk_e, pk_o = team_split(env, out.info["shoot/pk_dealt_vec"][:, None])
            t["ego_fired"] += fire_e.sum()
            t["opp_fired"] += fire_o.sum()
            t["pk_by_ego"] += pk_e.sum()
            t["pk_by_opp"] += pk_o.sum()
        c.ego_obs, c.opp_obs = team_split(env, out.obs)
        c.h_ego, c.h_opp = h_e * keep[:, :, None], h_o * keep[:, :, None]
        c.masks, c.cum_ego, c.cum_opp = keep, cum_e * keep, cum_o * keep
    return c


def read_tallies(carry: MatchCarry) -> Dict[str, float]:
    """The match's tallies on the host: one transfer."""
    return dict(zip(carry.tallies, torch.stack(list(carry.tallies.values())).tolist()))


def play_match(env, policy: PPOPolicy, ego_actor, opp_actor, steps: int, seed: int,
               sample: bool) -> Dict[str, float]:
    carry = match_init(env, policy, seed)
    return read_tallies(match_steps(env, ego_actor, opp_actor, carry, steps, sample))


def head_to_head(env, policy: PPOPolicy, ego_actor, opp_actor, steps: int, seed: int,
                 stochastic: str = "none"):
    """Head-to-head match; returns (ego per-episode avg, opp per-episode
    avg, episodes ended, ego wins, opp wins) as tools/ladder_probe.py's
    `head_to_head`. stochastic: "none" = both play the mode (the reference
    eval protocol); "both" = both sample (the training-time matchup)."""
    t = play_match(env, policy, ego_actor, opp_actor, steps, seed, stochastic == "both")
    half = env.num_agents // 2
    denom = max(t["resets"], 1.0)
    return (t["ego_sum"] / denom, t["opp_sum"] / denom, t["resets"] / half,
            t["ladder_ego_wins"], t["ladder_opp_wins"])


def both_sides_sum(first, swapped):
    """`head_to_head(final, opp)` and `head_to_head(opp, final)` summed,
    weighted by episodes (tools/ladder_probe.py:225-234): (final avg, opp
    avg, episodes, final wins, opp wins)."""
    e, o, ends, ew, ow = first
    o2, e2, ends2, ow2, ew2 = swapped
    # no episode ended in either orientation: 0, as one orientation gives
    # (the JAX tool divides by zero there)
    total = max(ends + ends2, 1.0)
    return ((e * ends + e2 * ends2) / total, (o * ends + o2 * ends2) / total,
            ends + ends2, ew + ew2, ow + ow2)


def ladder_row(env, policy: PPOPolicy, final, opp, name: str, steps: int, seed: int,
               stochastic: str, both_sides: bool, tie_band: float) -> dict:
    """One rung: the final actor against `opp`; with `both_sides` the
    swapped orientation (the final actor on the odd rows, seed + 1) summed
    in."""
    res = head_to_head(env, policy, final, opp, steps, seed, stochastic)
    if both_sides:
        res = both_sides_sum(res, head_to_head(env, policy, opp, final, steps, seed + 1,
                                               stochastic))
    e, o, ends, ew, ow = res
    diff = e - o
    verdict = "WIN" if diff > tie_band else "LOSS" if diff < -tie_band else "tie"
    return {"opponent": name, "ego_avg": round(e, 3), "opp_avg": round(o, 3),
            "diff": round(diff, 3), "episodes": ends, "ego_wins": ew, "opp_wins": ow,
            "verdict": verdict}


def add_net_flags(p: argparse.ArgumentParser) -> None:
    # network shape must match the checkpoints (train CLI defaults)
    p.add_argument("--hidden-size", default="128 128")
    p.add_argument("--act-hidden-size", default="128 128")
    p.add_argument("--recurrent-hidden-size", type=int, default=128)
    p.add_argument("--device", default="cuda",
                   help="the card by default; 'cpu' runs the kernels' plain versions")


def make_policy(args, env) -> PPOPolicy:
    """The policy the checkpoints were trained with, with the env's
    layout-aware Beta-prior slots (runner/base.py)."""
    cfg = RLConfig(hidden_sizes=tuple(int(x) for x in args.hidden_size.split()),
                   act_hidden_sizes=tuple(int(x) for x in args.act_hidden_size.split()),
                   recurrent_hidden_size=args.recurrent_hidden_size,
                   use_prior=args.use_prior)
    return PPOPolicy(cfg, env.num_observation, env.num_actions,
                     act_space=getattr(env, "action_space", None),
                     prior_slots=getattr(env, "shoot_prior_slots", (11, 13)),
                     device=args.device)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("neuralplane_tpu_torch.ladder_probe")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--final", default="latest", help="checkpoint name of the FINAL policy")
    p.add_argument("--opponents", nargs="+", required=True,
                   help="historical checkpoint names (pool episode numbers)")
    p.add_argument("--env", default="MultipleCombat", choices=list(ENVS))
    p.add_argument("--use-prior", action="store_true",
                   help="apply the Beta shoot prior (match training)")
    p.add_argument("--scenario", default=None)
    p.add_argument("--num-envs", type=int, default=200)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tie-band", type=float, default=50.0)
    p.add_argument("--stochastic", default="none", choices=["none", "both"],
                   help="'both' = sampled actions (training-time behavioral matchup); "
                   "'none' = the reference deterministic protocol")
    p.add_argument("--opp-ckpt-dir", default=None,
                   help="load OPPONENTS from a different run's checkpoint dir")
    p.add_argument("--both-sides", action="store_true",
                   help="also play each match with the sides swapped and report the "
                   "orientation-summed row (cancels the reference side-flag convention's "
                   "home advantage)")
    p.add_argument("--symmetric-side", action="store_true",
                   help="play on an env with symmetric_side_flag=True")
    add_net_flags(p)
    return p


def main(argv: Optional[list] = None) -> list:
    args = get_parser().parse_args(argv)
    env_cls, default_scn = ENVS[args.env]
    env_config = load_config(args.scenario or default_scn)
    if args.symmetric_side:
        env_config = env_config.replace(symmetric_side_flag=True)
    env = env_cls(num_envs=args.num_envs, config=env_config, device=args.device)
    policy = make_policy(args, env)
    final = load_actor(policy, args.ckpt_dir, args.final)
    rows = []
    for name in args.opponents:
        opp = load_actor(policy, args.opp_ckpt_dir or args.ckpt_dir, name)
        row = ladder_row(env, policy, final, opp, name, args.steps, args.seed,
                         args.stochastic, args.both_sides, args.tie_band)
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"ladder": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
