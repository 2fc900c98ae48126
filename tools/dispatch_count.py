"""Count the eager PyTorch ops that one combat step, or one self-play
collect step, dispatches: the host's work per step, which bounds the step
time where each op costs a fixed launch overhead.

    python tools/dispatch_count.py [--n-envs 8] [--json]

Runs the port on the CPU with the "distilled" backend's plain xdot, under a
TorchDispatchMode that counts every aten op except views (a view launches
nothing); each xdot evaluation is counted as one op (on the card it is one
launch of nlplant_distilled, whose plain version here would add its own
ops). Cases: SingleCombatEnv("selfplay"), SingleCombatShootEnv
("selfplay_shoot", the shoot bit on every row in a nose-on WEZ so that the
launch path runs), MultipleCombatEnv("multiple_selfplay"),
MultipleCombatShootEnv("multiple_selfplay_shoot"), and a collect step of
SelfplayRunner on the 1v1 missile env and of MAPPOSelfplayRunner on the
team one (default networks, the Beta launch prior on). The counts do not
depend on n; they are host-side counts, not device metrics.
"""
from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import sys
import tempfile

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class OpCounter(TorchDispatchMode):
    """Counts non-view aten ops by name; `paused` stops counting."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused and not func.is_view:
            self.ops[func.__name__.split(".")[0]] += 1
        return func(*args, **(kwargs or {}))


def count_xdot_as_one(env, counter: OpCounter) -> None:
    """The env's xdot through its plain version, counted as one op."""
    from neuralplane_tpu_torch.ops import aero_cuda
    plain = functools.partial(aero_cuda.nlplant_distilled_plain, env.model.weights)

    def xdot(s, u):
        counter.paused = True
        try:
            return plain(s, u)
        finally:
            counter.paused = False
            counter.ops["nlplant_distilled"] += 1
    env.model.dynamics = xdot


def shoot_actions(env, fire: bool = True) -> torch.Tensor:
    """Neutral discrete demands and the shoot bit on every row."""
    a = torch.tensor([[15.0, 20.0, 20.0, 20.0, float(fire)]]).expand(env.n, 5)
    return a.contiguous()


def nose_on(env, state):
    """Every (ego k, enemy k) pair nose-on at 12,000 ft: inside the WEZ."""
    m, h = env.num_agents, env.num_agents // 2
    s = state.model.s.clone()
    for e in range(env.num_envs):
        for k in range(h):
            i, j = e * m + k, e * m + h + k
            s[i, :7] = torch.tensor([0.0, k * 5000.0, 19500.0, 0.0, 0.0, 0.0, 1000.0])
            s[j, :7] = torch.tensor([12000.0, k * 5000.0, 19500.0, 0.0, 0.0, 3.14159265, 1000.0])
    model = state.model
    model.s, model.recent_s = s, s.clone()
    return state


def count_step(env, action, stage=False) -> collections.Counter:
    st, _ = env.reset(0)
    if stage:
        st = nose_on(env, st)
    counter = OpCounter()
    count_xdot_as_one(env, counter)
    with torch.no_grad(), counter:
        env.step(st, action)
    return counter.ops


def count_collect(runner) -> collections.Counter:
    carry = runner.init_carry(0)
    counter = OpCounter()
    count_xdot_as_one(runner.env, counter)
    with torch.no_grad(), counter:
        runner._collect_step(carry)
    return counter.ops


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-envs", type=int, default=8)
    ap.add_argument("--json", action="store_true", help="one JSON line, ops by name too")
    args = ap.parse_args(argv)
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.envs import (MultipleCombatEnv, MultipleCombatShootEnv,
                                            SingleCombatEnv, SingleCombatShootEnv)
    from neuralplane_tpu_torch.runner import MAPPOSelfplayRunner, SelfplayRunner

    def env(cls, config):
        return cls(args.n_envs, config, aero_backend="distilled", device="cpu")
    results = {}
    e = env(SingleCombatEnv, "selfplay")
    results["SingleCombatEnv step"] = count_step(e, torch.zeros(e.n, 4))
    e = env(SingleCombatShootEnv, "selfplay_shoot")
    results["SingleCombatShootEnv step"] = count_step(e, shoot_actions(e), stage=True)
    e = env(MultipleCombatEnv, "multiple_selfplay")
    results["MultipleCombatEnv step"] = count_step(e, torch.zeros(e.n, 4))
    e = env(MultipleCombatShootEnv, "multiple_selfplay_shoot")
    results["MultipleCombatShootEnv step"] = count_step(e, shoot_actions(e), stage=True)
    with tempfile.TemporaryDirectory() as d:
        cfg = RLConfig(use_prior=True)
        for name, cls, runner_cls, config in (
                ("SelfplayRunner collect step (1v1 missiles)", SingleCombatShootEnv,
                 SelfplayRunner, "selfplay_shoot"),
                ("MAPPOSelfplayRunner collect step (2v2 missiles)", MultipleCombatShootEnv,
                 MAPPOSelfplayRunner, "multiple_selfplay_shoot")):
            runner = runner_cls(env(cls, config), cfg, run_dir=os.path.join(d, name[:5]))
            results[name] = count_collect(runner)
            runner.close()
    totals = {k: sum(v.values()) for k, v in results.items()}
    if args.json:
        print(json.dumps({"totals": totals, "ops": {k: dict(v.most_common())
                                                    for k, v in results.items()}}))
        return
    for k, v in totals.items():
        print(f"{k}: {v} ops ({results[k]['nlplant_distilled']} xdot)")


if __name__ == "__main__":
    main()
