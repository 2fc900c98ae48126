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

Restores the checkpoint (default results/heading/policy_checkpoint.pkl) into
the package's F16SimRunner with the default RLConfig networks, on
ControlEnv(scenario, model, aero_backend=backend) -- or, with --env-name
Planning, on PlanningEnv(scenario, model) over the frozen low-level actor of
--low-level-ckpt, one step of which is `low_level_steps` control steps --
at --n envs with the scenario's sensor noise, and prints one JSON line with
`eval_average_episode_rewards` of `F16SimRunner.eval(steps)` for each of
--repeats evals (each eval draws its env seed from the runner's key or
generator, so the repeats differ). The JAX PlanningEnv reads its aero
backend from NEURALPLANE_AERO_BACKEND, which the tool sets to --backend.

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


def jax_evals(args):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from neuralplane_tpu.algorithms.rl_config import RLConfig
    from neuralplane_tpu.envs import ControlEnv
    from neuralplane_tpu.runner import F16SimRunner
    if args.interpret:
        from jax.experimental import pallas as pl
        orig = pl.pallas_call
        pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    if args.env_name == "Planning":
        import pickle
        from neuralplane_tpu.envs import PlanningEnv
        os.environ["NEURALPLANE_AERO_BACKEND"] = args.backend
        with open(args.low_level_ckpt, "rb") as f:
            low = pickle.load(f)["train_state"].params["actor"]
        env = PlanningEnv(num_envs=args.n, config=args.scenario, model=args.model,
                          low_level_params=low)
    else:
        env = ControlEnv(num_envs=args.n, config=args.scenario, model=args.model,
                         aero_backend=args.backend)
    if args.interpret:
        env.config = env.config.replace(kernel_obs_noise=False, kernel_reset_draws=False)
    return env, F16SimRunner, RLConfig


def port_evals(args):
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.envs import ControlEnv
    from neuralplane_tpu_torch.runner import F16SimRunner
    if args.env_name == "Planning":
        from neuralplane_tpu_torch.envs import PlanningEnv
        from neuralplane_tpu_torch.envs.planning import load_low_level_ckpt
        env = PlanningEnv(num_envs=args.n, config=args.scenario, model=args.model,
                          low_level_params=load_low_level_ckpt(args.low_level_ckpt),
                          aero_backend=args.backend, device=args.device)
    else:
        env = ControlEnv(num_envs=args.n, config=args.scenario, model=args.model,
                         aero_backend=args.backend, device=args.device)
    return env, F16SimRunner, RLConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=["jax", "port"], default="jax")
    ap.add_argument("--checkpoint",
                    default=os.path.join(REPO, "results", "heading", "policy_checkpoint.pkl"))
    ap.add_argument("--scenario", default="heading")
    ap.add_argument("--model", default="F16", choices=["F16", "UAV", "C172P"])
    ap.add_argument("--env-name", default="Control", choices=["Control", "Planning"])
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
    args = ap.parse_args(argv)
    env, runner_cls, cfg_cls = (jax_evals if args.package == "jax" else port_evals)(args)
    values = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as run_dir:
        runner = runner_cls(env, cfg_cls(), run_dir=run_dir, model_dir=args.checkpoint)
        try:
            for _ in range(args.repeats):
                values.append(runner.eval(args.steps)["eval_average_episode_rewards"])
        finally:
            runner.close()
    print(json.dumps({"package": args.package, "checkpoint": os.path.relpath(args.checkpoint, REPO),
                      "env_name": args.env_name, "model": args.model,
                      "scenario": args.scenario, "n": args.n, "steps": args.steps,
                      "backend": args.backend, "interpret": args.interpret,
                      "device": args.device if args.package == "port" else "cpu",
                      "noise_scale": env.config.noise_scale,
                      "eval_average_episode_rewards": values,
                      "mean": sum(values) / len(values),
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
