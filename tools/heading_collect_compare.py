"""One collect of the heading run, by the JAX package and by the port, from
the same actor and critic, on the CPU: the first episode's statistics.

  python tools/heading_collect_compare.py --n 3000 --steps 1000 --backend pallas
  git archive 3f70aa5 | tar -x -C build/jax_3f70aa5
  python tools/heading_collect_compare.py --package jax --jax-root build/jax_3f70aa5

Builds the JAX package's F16SimRunner (today's package, Pallas in interpret
mode for --backend pallas, its draws then from jax.random outside the
kernel) and the port's on ControlEnv("heading", backend) at --n envs with
the heading run's networks, carries the JAX init params (seed --seed) into
the port, and runs one collect of --steps steps in each package from its own
reset (stochastic actions from each package's own generator). Prints one
JSON line per package: the collect's `termination/*` counts,
`episodes_reached_target`, `episodes_failed`, `average_episode_rewards`
(as the runners log them), and the moments of the reset state and targets
(altitude, speed, target altitude, target heading, target speed) over the
envs. The policy is the untrained one, so the counts measure the env's
response to near-random actions; the two packages' RNG streams differ by
design, so compare the counts as samples (a count c has a spread of about
sqrt(c) between seeds).

`--set KEY=VALUE` (repeatable, VALUE as JSON) overrides the heading
scenario's config in both packages, e.g. `--set reuse_step_xdot=false`
(the overload check at the post-step state, as before the JAX package's
commit 77ade88).

`--jax-root DIR` imports the JAX package from DIR instead, a checkout of
another commit (e.g. the one the JAX heading run was made at), and
`--package jax` runs the JAX side alone: the same collect from the same
seed, so that two commits of the reference can be compared.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def moments(x) -> dict:
    import numpy as np
    x = np.asarray(x, dtype=np.float64)
    return {"mean": float(x.mean()), "std": float(x.std()), "min": float(x.min()),
            "max": float(x.max())}


def reset_stats(alt, vt, t_alt, t_hdg, t_vt) -> dict:
    return {"altitude_ft": moments(alt), "vt": moments(vt),
            "target_altitude": moments(t_alt), "target_heading": moments(t_hdg),
            "target_vt": moments(t_vt)}


def summary(counters: dict, rewards_sum: float, ends: float) -> dict:
    out = {k: float(v) for k, v in sorted(counters.items())}
    out["average_episode_rewards"] = rewards_sum / max(ends, 1.0)
    return out


def run_jax(args, cfg_kw):
    """The JAX side: (runner, collect summary, reset moments, seconds). On
    "pallas" the Pallas kernels run in interpret mode for this call."""
    import jax
    from jax.experimental import pallas as pl
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    orig = pl.pallas_call
    if args.backend == "pallas":
        pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        return _run_jax(args, cfg_kw)
    finally:
        pl.pallas_call = orig


def _run_jax(args, cfg_kw):
    import jax
    import numpy as np
    from neuralplane_tpu.algorithms.rl_config import RLConfig
    from neuralplane_tpu.envs import ControlEnv
    from neuralplane_tpu.runner import F16SimRunner
    from neuralplane_tpu.utils.config import load_config
    config = load_config("heading", **args.set) if args.set else "heading"
    env = ControlEnv(num_envs=args.n, config=config, aero_backend=args.backend,
                     **({"task": "heading"} if args.set else {}))
    if args.backend == "pallas" and hasattr(env.config, "kernel_reset_draws"):
        env.config = env.config.replace(kernel_obs_noise=False, kernel_reset_draws=False)
    run = F16SimRunner(env, RLConfig(**cfg_kw), run_dir=os.path.join(args.tmp, "jax"))
    carry = run.init_carry(jax.random.PRNGKey(args.seed))
    st = carry.env_state
    mst, tst = st.model, st.task
    stats = reset_stats(mst.s[:, 2], mst.s[:, 6], tst.target_altitude, tst.target_heading,
                        tst.target_vt)
    t0 = time.time()
    carry, batch, (_, counters) = run.collect(run.train_state.params, carry)
    masks, bad = np.asarray(batch.masks[1:]), np.asarray(batch.bad_masks[1:])
    ends = float((masks == 0).sum() + (bad == 0).sum())
    out = summary({k: np.asarray(v) for k, v in counters.items()},
                  float(np.asarray(batch.rewards).sum()), ends)
    return run, out, stats, time.time() - t0


def run_port(args, cfg_kw, jax_params):
    """The port's side on the CPU: (collect summary, reset moments, seconds)."""
    import torch
    from neuralplane_tpu_torch.algorithms.networks import params_from_jax
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.envs import ControlEnv
    from neuralplane_tpu_torch.runner import F16SimRunner
    from neuralplane_tpu_torch.utils.config import load_config
    env = ControlEnv(num_envs=args.n, config=load_config("heading", **args.set),
                     task="heading", aero_backend=args.backend, device="cpu")
    run = F16SimRunner(env, RLConfig(**cfg_kw), run_dir=os.path.join(args.tmp, "port"))
    run.policy.load_state_dict(params_from_jax(jax_params))
    carry = run.init_carry(args.seed)
    mst, tst = carry.env_state.model, carry.env_state.task
    stats = reset_stats(mst.s[:, 2].numpy(), mst.s[:, 6].numpy(),
                        tst.target_altitude.numpy(), tst.target_heading.numpy(),
                        tst.target_vt.numpy())
    t0 = time.time()
    carry, batch, (_, counters) = run.collect(carry)
    ends = float((batch.masks[1:] == 0).sum() + (batch.bad_masks[1:] == 0).sum())
    out = summary({k: v.numpy() for k, v in counters.items()},
                  float(batch.rewards.sum()), ends)
    run.close()
    return out, stats, time.time() - t0


def main(argv=None) -> int:
    import tempfile
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--backend", default="pallas", choices=["pallas", "stacked"])
    ap.add_argument("--package", default="both", choices=["both", "jax"])
    ap.add_argument("--jax-root", default=None,
                    help="import neuralplane_tpu from this checkout instead")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a key of the heading scenario's config")
    args = ap.parse_args(argv)
    args.set = {k: json.loads(v) for k, v in (kv.split("=", 1) for kv in args.set)}
    if args.jax_root:
        sys.path.insert(0, os.path.abspath(args.jax_root))
    cfg_kw = dict(n_rollout_threads=args.n, buffer_size=args.steps, data_chunk_length=8,
                  seed=args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        args.tmp = tmp
        jrun, jout, jstats, jsec = run_jax(args, cfg_kw)
        import jax
        import numpy as np
        import neuralplane_tpu
        rows = [("jax", jout, jstats, jsec)]
        if args.package == "both":
            params = jax.tree.map(np.asarray, jrun.train_state.params)
            rows.append(("port", *run_port(args, cfg_kw, params)))
        jrun.close()
    for name, out, stats, sec in rows:
        where = os.path.dirname(os.path.dirname(neuralplane_tpu.__file__)) \
            if name == "jax" else REPO
        print(json.dumps({"package": name, "root": os.path.relpath(where, REPO),
                          "n": args.n, "steps": args.steps, "backend": args.backend,
                          "seed": args.seed, "set": args.set, "collect": out,
                          "reset": stats,
                          "collect_s": round(sec, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
