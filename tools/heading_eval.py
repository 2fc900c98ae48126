"""Deterministic eval of a committed checkpoint, by the JAX package or by the port.

    python tools/heading_eval.py --package jax  [--backend stacked]            # JAX, CPU
    python tools/heading_eval.py --package jax  --backend pallas --interpret   # JAX, CPU
    python tools/heading_eval.py --package port [--backend pallas] [--device cpu]
    python tools/heading_eval.py --scenario tracking --model UAV \
        --checkpoint results/uav_tracking/policy_checkpoint.pkl --steps 200
    python tools/heading_eval.py --env-name Planning --scenario tracking \
        --checkpoint results/tracking/policy_checkpoint.pkl \
        --low-level-ckpt results/control/policy_checkpoint.pkl --steps 50 \
        --backend distilled --interpret
    python tools/heading_eval.py --env-name SingleCombat --scenario selfplay \
        --checkpoint results/selfplay/policy_checkpoint.pkl --steps 500 \
        --backend distilled --interpret --repeats 5
    python tools/heading_eval.py --env-name SingleCombatShoot --scenario selfplay_shoot \
        --checkpoint results/shoot_1v1/policy_checkpoint.pkl --steps 500 \
        --backend distilled --interpret --repeats 5
    python tools/heading_eval.py --env-name MultipleCombatShoot \
        --scenario multiple_selfplay_shoot --n 500 \
        --checkpoint results/mappo_2v2_shoot/policy_checkpoint.pkl --steps 500 \
        --backend distilled --interpret --repeats 5

Restores the checkpoint (default results/heading/policy_checkpoint.pkl) into
the package's F16SimRunner with the default RLConfig networks, on
ControlEnv(scenario, model, aero_backend=backend) -- or, with --env-name
Planning, on PlanningEnv(scenario, model) over the frozen low-level actor of
--low-level-ckpt (a JAX run's whole-state pickle or an actor-only one, as
`tools/train_legs.py --export-actor` writes), one step of which is
`low_level_steps` control steps --
at --n envs with the scenario's sensor noise, and prints one JSON line with
`eval_average_episode_rewards` of `F16SimRunner.eval(steps)` for each of
--repeats evals (each eval draws its env seed from the runner's key or
generator, so the repeats differ), and a Box actor's log std per action
(`log_std`). The JAX PlanningEnv reads its aero
backend from NEURALPLANE_AERO_BACKEND, which the tool sets to --backend.

With --env-name SingleCombat the checkpoint flies both sides of
SingleCombatEnv(scenario) deterministically (one policy on every agent, its
GRU memory zeroed when a group resets, masks from the group's done flags),
and each value is the ego team's mean reward per agent-step over --steps
(`ego_mean_reward_per_agent_step`), each repeat from its own env seed. The
JAX SingleCombatEnv also reads its backend from NEURALPLANE_AERO_BACKEND.
With --env-name SingleCombatShoot or MultipleCombatShoot the same loop flies
the missile envs (ShootTuple actions, the Beta launch prior on: the
committed missile policies were trained with --use-prior); the team game's
checkpoint is read by the MAPPO runner, a whole MAPPO TrainState or an
actor-only pickle, and its actor flies every agent; the line also carries each repeat's missile launches and hits per step
(`launches_per_step`, `hits_per_step`).

With --success (Control only) each eval also sums the targets reached
(`done`) and the episodes failed (`bad_done`) over its steps, and the line
carries `reached`, `failed` and `success_share` = reached / (reached +
failed) per repeat: the JAX side runs F16SimRunner.eval's rollout (its keys,
its scan, its reward per episode end) with the two sums added, the port's
runner evaluates through a counting wrapper of its env.

`--package jax` runs neuralplane_tpu on the CPU; "stacked" is its CPU
default, "pallas" the same 43 nets with the fused kernels' bf16 rounding
points and needs --interpret (the Pallas kernels in interpret mode; their
draws then come from jax.random outside the kernel, since the TPU's hardware
PRNG has no interpret mode). `--package port` runs neuralplane_tpu_torch on
--device, reading the JAX pickle without JAX. `chip_smoke.py` (phase 16)
holds the port's eval on the card against the JAX package's values.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the combat envs by --env-name, the same class names in both packages
COMBAT = {"SingleCombat": "SingleCombatEnv", "SingleCombatShoot": "SingleCombatShootEnv",
          "MultipleCombatShoot": "MultipleCombatShootEnv"}
# the team game trains with MAPPO: its runner reads a MAPPO checkpoint (the
# centralized critic beside the actor) or an actor-only one, and the actor flies
MAPPO_ENVS = ("MultipleCombatShoot",)
# the missile envs' per-step counts, summed over a repeat
SHOT_KEYS = ("shoot/launches", "shoot/hits")


def jax_evals(args):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from neuralplane_tpu.algorithms.rl_config import RLConfig
    from neuralplane_tpu.envs import ControlEnv
    from neuralplane_tpu.runner import F16SimRunner, MAPPOSelfplayRunner
    if args.interpret:
        from jax.experimental import pallas as pl
        orig = pl.pallas_call
        pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    if args.env_name in COMBAT:
        from neuralplane_tpu import envs as jax_envs
        os.environ["NEURALPLANE_AERO_BACKEND"] = args.backend
        env = getattr(jax_envs, COMBAT[args.env_name])(num_envs=args.n, config=args.scenario)
    elif args.env_name == "Planning":
        import pickle
        from neuralplane_tpu.envs import PlanningEnv
        os.environ["NEURALPLANE_AERO_BACKEND"] = args.backend
        with open(args.low_level_ckpt, "rb") as f:   # a whole TrainState or an actor
            low = pickle.load(f)
        low = low["train_state"].params["actor"] if "train_state" in low else low
        env = PlanningEnv(num_envs=args.n, config=args.scenario, model=args.model,
                          low_level_params=low)
    else:
        env = ControlEnv(num_envs=args.n, config=args.scenario, model=args.model,
                         aero_backend=args.backend)
    if args.interpret and args.env_name not in COMBAT:
        env.config = env.config.replace(kernel_obs_noise=False, kernel_reset_draws=False)
    return env, (MAPPOSelfplayRunner if args.env_name in MAPPO_ENVS else F16SimRunner), RLConfig


def jax_combat_values(args, env, runner):
    """The ego team's mean reward per agent-step, JAX package."""
    import jax
    import jax.numpy as jnp
    params = runner.train_state.params
    m = env.num_agents

    @jax.jit
    def step(state, obs, h, masks):
        a, h = runner.policy.act(params, obs, h, masks, deterministic=True)
        state, out = env.step(state, a)
        reset = (out.done | out.bad_done | out.exceed_time_limit).reshape(-1, m).any(1)
        done = out.done.reshape(-1, m).any(1)
        h = h * (1.0 - jnp.repeat(reset, m))[:, None, None]
        masks = (1.0 - jnp.repeat(done, m))[:, None]
        shots = jnp.stack([out.info.get(k, jnp.zeros((), jnp.int32)).astype(jnp.float32)
                           for k in SHOT_KEYS])
        return state, out.obs, h, masks, out.reward.reshape(-1, m)[:, :m // 2].sum(), shots

    values, shots = [], []
    for _ in range(args.repeats):
        state, obs = env.reset(runner.next_key())
        h, _ = runner.policy.init_rnn_states(env.n)
        masks, total, fired = jnp.ones((env.n, 1)), 0.0, 0.0
        for _ in range(args.steps):
            state, obs, h, masks, ego, n_shots = step(state, obs, h, masks)
            total += ego
            fired += n_shots
        values.append(float(total) / (env.n // 2 * args.steps))
        shots.append([float(x) / args.steps for x in fired])
    return values, shots


def port_combat_values(args, env, runner):
    """The ego team's mean reward per agent-step, the port."""
    import torch
    m = env.num_agents
    values, shots = [], []
    with torch.no_grad():
        for _ in range(args.repeats):
            state, obs = env.reset(runner.next_seed())
            h, _ = runner.policy.init_rnn_states(env.n)
            masks = torch.ones((env.n, 1), device=env.device)
            total = torch.zeros((), dtype=torch.float64, device=env.device)
            fired = torch.zeros(len(SHOT_KEYS), dtype=torch.float64, device=env.device)
            for _ in range(args.steps):
                a, h = runner.policy.act(obs, h, masks, deterministic=True)
                state, out = env.step(state, a)
                reset = (out.done | out.bad_done | out.exceed_time_limit).reshape(-1, m).any(1)
                done = out.done.reshape(-1, m).any(1)
                h = h * (~reset).float().repeat_interleave(m)[:, None, None]
                masks = (~done).float().repeat_interleave(m)[:, None]
                total += out.reward.reshape(-1, m)[:, :m // 2].sum()
                for i, k in enumerate(SHOT_KEYS):
                    if k in out.info:
                        fired[i] += out.info[k]
                obs = out.obs
            values.append(float(total) / (env.n // 2 * args.steps))
            shots.append([float(x) / args.steps for x in fired])
    return values, shots


def jax_control_values(args, env, runner):
    """F16SimRunner.eval's deterministic rollout, JAX package
    (runner/f16sim.py:eval), with the targets reached and the episodes
    failed summed beside the reward: (rewards, [(reached, failed)])."""
    import functools

    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("steps",))
    def rollout(params, init, steps):
        def step_fn(carry, _):
            state, obs, h_a, masks, total_rew, total_done, reached, failed = carry
            actions, h_a = runner.policy.act(params, obs, h_a, masks, deterministic=True)
            state, out = env.step(state, actions)
            reset = out.done | out.bad_done | out.exceed_time_limit
            masks = 1.0 - out.done.astype(jnp.float32)[:, None]
            h_a = h_a * (1.0 - reset.astype(jnp.float32))[:, None, None]
            return (state, out.obs, h_a, masks, total_rew + out.reward.sum(),
                    total_done + reset.sum(), reached + out.done.sum(),
                    failed + out.bad_done.sum()), None
        return jax.lax.scan(step_fn, init, None, length=steps)[0]

    values, counts = [], []
    for _ in range(args.repeats):
        key = runner.next_key()
        k_reset, key = jax.random.split(key)
        state, obs = env.reset(k_reset)
        h_a, _ = runner.policy.init_rnn_states(env.n)
        zero = jnp.zeros((), jnp.int32)
        out = rollout(runner.train_state.params,
                      (state, obs, h_a, jnp.ones((env.n, 1), jnp.float32), jnp.zeros(()),
                       zero, zero, zero), steps=args.steps)
        values.append(float(out[4] / jnp.maximum(out[5], 1)))
        counts.append((int(out[6]), int(out[7])))
    return values, counts


def port_control_values(args, env, runner):
    """The port's F16SimRunner.eval through chip_smoke's counting wrapper
    of the env: (rewards, [(reached, failed)])."""
    from chip_smoke import CountingEnv
    values, counts = [], []
    for _ in range(args.repeats):
        runner.eval_env = counting = CountingEnv(env)
        values.append(runner.eval(args.steps)["eval_average_episode_rewards"])
        counts.append((int(counting.reached), int(counting.failed)))
    return values, counts


def port_evals(args):
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.envs import ControlEnv
    from neuralplane_tpu_torch.runner import F16SimRunner, MAPPOSelfplayRunner
    if args.env_name in COMBAT:
        from neuralplane_tpu_torch import envs as port_envs
        env = getattr(port_envs, COMBAT[args.env_name])(
            num_envs=args.n, config=args.scenario, aero_backend=args.backend,
            device=args.device)
    elif args.env_name == "Planning":
        from neuralplane_tpu_torch.envs import PlanningEnv
        from neuralplane_tpu_torch.envs.planning import load_low_level_ckpt
        env = PlanningEnv(num_envs=args.n, config=args.scenario, model=args.model,
                          low_level_params=load_low_level_ckpt(args.low_level_ckpt),
                          aero_backend=args.backend, device=args.device)
    else:
        env = ControlEnv(num_envs=args.n, config=args.scenario, model=args.model,
                         aero_backend=args.backend, device=args.device)
    return env, (MAPPOSelfplayRunner if args.env_name in MAPPO_ENVS else F16SimRunner), RLConfig


def actor_log_std(args, runner):
    """The restored actor's log std per action (a Box actor's), else None."""
    if args.package == "jax":
        actor = runner.train_state.params["actor"]
        return [float(x) for x in actor["log_std"]] if "log_std" in actor else None
    log_std = getattr(runner.policy.actor, "log_std", None)
    return None if log_std is None else [float(x) for x in log_std.detach().cpu()]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=["jax", "port"], default="jax")
    ap.add_argument("--checkpoint",
                    default=os.path.join(REPO, "results", "heading", "policy_checkpoint.pkl"))
    ap.add_argument("--scenario", default="heading")
    ap.add_argument("--model", default="F16", choices=["F16", "UAV", "C172P"])
    ap.add_argument("--env-name", default="Control",
                    choices=["Control", "Planning", *COMBAT])
    ap.add_argument("--low-level-ckpt",
                    default=os.path.join(REPO, "results", "control", "policy_checkpoint.pkl"),
                    help="Planning: the frozen low-level control policy")
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--backend", default="stacked")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--interpret", action="store_true",
                    help="JAX: run the Pallas kernels in interpret mode")
    ap.add_argument("--device", default="cpu", help="port: torch device")
    ap.add_argument("--success", action="store_true",
                    help="Control: also count the targets reached and the episodes failed")
    args = ap.parse_args(argv)
    if args.success and args.env_name != "Control":
        ap.error("--success counts the Control env's targets")
    # the JAX envs read their backend from NEURALPLANE_AERO_BACKEND, which
    # jax_evals sets: an in-process caller gets its own value back
    prev = os.environ.get("NEURALPLANE_AERO_BACKEND")
    try:
        env, runner_cls, cfg_cls = (jax_evals if args.package == "jax" else port_evals)(args)
        t0 = time.perf_counter()
        # the missile policies were trained with the Beta launch prior on
        cfg = cfg_cls(use_prior=args.env_name.endswith("Shoot"))
        shots = counts = None
        with tempfile.TemporaryDirectory() as run_dir:
            runner = runner_cls(env, cfg, run_dir=run_dir, model_dir=args.checkpoint)
            try:
                if args.env_name in COMBAT:
                    values, shots = (jax_combat_values if args.package == "jax"
                                     else port_combat_values)(args, env, runner)
                elif args.success:
                    values, counts = (jax_control_values if args.package == "jax"
                                      else port_control_values)(args, env, runner)
                else:
                    values = [runner.eval(args.steps)["eval_average_episode_rewards"]
                              for _ in range(args.repeats)]
                log_std = actor_log_std(args, runner)
            finally:
                runner.close()
        extra = {} if log_std is None else {"log_std": log_std}
        if shots is not None and args.env_name.endswith("Shoot"):
            extra.update({"launches_per_step": [s[0] for s in shots],
                          "hits_per_step": [s[1] for s in shots]})
        if counts is not None:
            extra.update({"reached": [c[0] for c in counts], "failed": [c[1] for c in counts],
                          "success_share": [c[0] / max(1, c[0] + c[1]) for c in counts]})
        print(json.dumps({"package": args.package, "checkpoint": os.path.relpath(args.checkpoint, REPO),
                          "env_name": args.env_name, "model": args.model,
                          "scenario": args.scenario, "n": args.n, "steps": args.steps,
                          "backend": args.backend, "interpret": args.interpret,
                          "device": args.device if args.package == "port" else "cpu",
                          "noise_scale": env.config.noise_scale,
                          ("ego_mean_reward_per_agent_step" if args.env_name in COMBAT
                           else "eval_average_episode_rewards"): values,
                          "mean": sum(values) / len(values), **extra,
                          "seconds": time.perf_counter() - t0}))

    finally:
        if prev is None:
            os.environ.pop("NEURALPLANE_AERO_BACKEND", None)
        else:
            os.environ["NEURALPLANE_AERO_BACKEND"] = prev

if __name__ == "__main__":
    main()
