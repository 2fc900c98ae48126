"""One collect of the heading run, or of the tracking run, by the JAX package
and by the port, from the same actor and critic, on the CPU: the first
episode's statistics.

  python tools/heading_collect_compare.py --n 3000 --steps 1000 --backend pallas
  git archive 3f70aa5 | tar -x -C build/jax_3f70aa5
  python tools/heading_collect_compare.py --package jax --jax-root build/jax_3f70aa5
  python tools/heading_collect_compare.py --scenario tracking --n 256 --steps 10

`--scenario tracking` is the hierarchical run (`scripts/train_tracking.sh`):
PlanningEnv("tracking") over `--low-level-ckpt` (default the committed
control policy), on "distilled" (the JAX xdot kernel in interpret mode,
chosen through NEURALPLANE_AERO_BACKEND as the JAX CLI does), chunks of 10;
its reset moments are the altitude, the speed and the first target's
altitude, north and east offsets.

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

`--set KEY=VALUE` (repeatable, VALUE as JSON) overrides the scenario's
config in both packages, e.g. `--set reuse_step_xdot=false`
(the overload check at the post-step state, as before the JAX package's
commit 77ade88).

On "pallas", and on "distilled" outside the tracking scenario, the JAX
side turns its step kernel's reset draws and sensor noise off (the TPU
hardware PRNG has no interpret mode) and draws the same distributions
from jax.random outside the kernel; the port keeps its own in-step draws
(on the CPU the step's plain version draws from the env's generator).
`--step-reset` adds, under `reset.step_reset`, the moments after one step
from the all-done state with zero actions, every row reset inside the
step (heading and control):

  python tools/heading_collect_compare.py --scenario control --backend distilled \
      --n 1000 --steps 1000 --step-reset

`--update` then runs one PPO update on the collected batch in each package
and adds its train infos (losses, grad norms, ratio) to the line.

`--checkpoint PKL` starts both packages' collect from a trained actor
instead: the JAX runner grafts it (an actor-only pickle, or a whole
TrainState's actor), and the port takes the JAX runner's params as before.
The collect then is the first episode after a restore, which starts every
env from a fresh reset in both packages.

`--reward-terms` splits each collect's reward sum into its two terms
(heading and control; one agent per env): the event term, each package's
own `rewards.event_driven_reward` on each step's done and bad flags (read
back from the batch: masks[t + 1] = 1 - done, bad_masks[t + 1] = 1 - bad),
and the shaped term, the rest (the posture or heading reward, minus a sum
of squares: no step's share may be positive). It checks the identity that
lets `tools/curve_table.py --terms` read the split from a `metrics.jsonl`
alone: the event sum is 200 x (reached - failed) of the logged counters,
the episode ends are reached + failed, so the shaped term per episode end
is `average_episode_rewards` - 200 x (2 s - 1), s = reached / (reached +
failed):

  python tools/heading_collect_compare.py --scenario control --backend distilled \
      --n 1000 --steps 1000 --reward-terms

`--jax-root DIR` imports the JAX package from DIR instead, a checkout of
another commit (e.g. the one the JAX heading run was made at), and
`--package jax` runs the JAX side alone: the same collect from the same
seed, so that two commits of the reference can be compared.

`--scenario selfplay_shoot_evadable` is the 1v1 evadable-missile self-play
run (`scripts/train_shoot_evadable.sh`: SelfplayRunner on
SingleCombatShootEnv, FSP, the Beta launch prior, chunks of 8): both
packages' runners from the JAX init actor and critic (seed --seed), the
opponent the same initial actor (the pool's entry 0), or `--checkpoint`
(the ego) and `--opponent` (a JAX actor pickle or a port `actor_<n>.pt`).
The line's `collect` holds the `shoot_*` counts (launches, hits, pk_sum),
the done and bad flags by termination cause over all agents
(`shoot_x_<cause>_bad`, `shoot_x_<cause>_done`) and the ego's reward sum
split by two rules for the +-200 event term: `done_bad` (200 (done - bad)
on any end, the JAX package since c612e50 and the port) and `win_lose`
(200 (win - lose) on the shutdown condition alone, the package the JAX
run trained at). Under `reward_terms`, each rule's event and shaped sums
and its count of ego steps whose shaped rest is 100 or more in size: the
package's own rule leaves none (no step's posture, launch cost and
damage shaping reach 100), and that rule is named under `rule`.

  python tools/heading_collect_compare.py --scenario selfplay_shoot_evadable \
      --backend distilled --n 200 --steps 1000 --update --out a.jsonl
  python tools/heading_collect_compare.py --compare a.jsonl b.jsonl

`--out FILE` appends the lines to FILE too; `--compare A B` prints, for
each count of the first line of A and of B, both values and whether they
agree as samples (|c - c'| <= 4 sqrt(c + c') + 1), and the update's train
infos side by side.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CONTROL_CKPT = os.path.join(REPO, "results", "control", "policy_checkpoint.pkl")


def moments(x) -> dict:
    import numpy as np
    x = np.asarray(x, dtype=np.float64)
    return {"mean": float(x.mean()), "std": float(x.std()), "min": float(x.min()),
            "max": float(x.max())}


TARGETS = {"heading": ("target_altitude", "target_heading", "target_vt"),
           "control": ("target_pitch", "target_heading", "target_vt"),
           "tracking": ("target_altitude", "target_npos", "target_epos")}


def reset_stats(scenario, s, task_state, to_np) -> dict:
    """Moments of the reset's altitude, speed and the scenario's targets."""
    out = {"altitude_ft": moments(to_np(s[:, 2])), "vt": moments(to_np(s[:, 6]))}
    for k in TARGETS[scenario]:
        out[k] = moments(to_np(getattr(task_state, k)))
    return out


def step_reset_stats(scenario, state, to_np) -> dict:
    """Moments of the altitude, speed and targets of a state after one step
    from the all-done state."""
    m = state.model
    s = m.sf.T if hasattr(m, "sf") else m.s   # feature-major or agent-major
    return reset_stats(scenario, s, state.task, to_np)


def jax_step_reset(scenario, env, seed: int) -> dict:
    """One step of the JAX env from its all-done state with zero actions:
    every row reset inside the step; the moments after it."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    st = env.init_state(jax.random.PRNGKey(seed))
    if env._task_kernel:
        from neuralplane_tpu.models.f16 import to_fm
        st = st.replace(model=to_fm(st.model))
    st = jax.tree.map(jnp.array, st)   # step donates: one buffer per leaf
    st, _ = env.step(st, jnp.zeros((env.n, env.num_actions), jnp.float32))
    return step_reset_stats(scenario, st, np.asarray)


def port_step_reset(scenario, env) -> dict:
    """The same for the port's env, after its reset(seed) (on the fused
    path the step's own reset draws)."""
    import torch
    from neuralplane_tpu_torch.models.f16 import to_fm
    st = env.init_state()
    if env.fused:
        st = st.replace(model=to_fm(st.model))
    st, _ = env.step(st, torch.zeros((env.n, env.num_actions), device=env.device))
    return step_reset_stats(scenario, st, lambda t: t.cpu().numpy())


def control_actor(path: str) -> dict:
    """The actor tree of a JAX checkpoint, by the JAX package's own reader."""
    import pickle
    with open(path, "rb") as f:
        blob = pickle.load(f)
    return blob["train_state"].params["actor"] if "train_state" in blob else blob


def summary(counters: dict, rewards_sum: float, ends: float) -> dict:
    out = {k: float(v) for k, v in sorted(counters.items())}
    out["average_episode_rewards"] = rewards_sum / max(ends, 1.0)
    return out


EVENT_REWARD = 200.0   # rewards.event_driven_reward's size, in both packages


def reward_terms(rewards, masks, bad_masks, counters: dict, event_reward) -> dict:
    """A collect's reward sum split into the event term (`event_reward` on
    each step's done and bad flags) and the shaped term (the rest), as
    float64 numpy sums; `identity` is true when the event sum and the
    episode ends are what the logged counters imply, and no step's shaped
    share is positive."""
    import numpy as np
    done, bad = masks[1:] == 0, bad_masks[1:] == 0
    event = np.asarray(event_reward(done, bad), np.float64)
    total = np.asarray(rewards, np.float64)
    reached = float(counters["episodes_reached_target"])
    failed = float(counters["episodes_failed"])
    ends = float(np.asarray(done).sum() + np.asarray(bad).sum())
    shaped = total - event
    out = {"reward_sum": float(total.sum()), "event_sum": float(event.sum()),
           "shaped_sum": float(shaped.sum()), "shaped_max": float(shaped.max()),
           "ends": ends,
           "event_from_counters": EVENT_REWARD * (reached - failed),
           "shaped_per_end": float(shaped.sum()) / max(ends, 1.0),
           "shaped_per_step": float(shaped.mean())}
    out["identity"] = bool(out["event_sum"] == out["event_from_counters"]
                           and ends == reached + failed and out["shaped_max"] <= 0.0)
    return out


SHOOT = "selfplay_shoot_evadable"
CAUSES = ("overload", "low_altitude", "high_speed", "low_speed", "extreme_state", "crash",
          "timeout", "shutdown")
# the run's flags (scripts/train_shoot_evadable.sh) that shape a collect and an update
SHOOT_FLAGS = dict(use_selfplay=True, use_prior=True, selfplay_algorithm="fsp",
                   n_choose_opponents=1, elo_tie_band=50.0, num_mini_batch=5, ppo_epoch=16,
                   lr=3e-4, gamma=0.99, entropy_coef=1e-3, max_grad_norm=2.0)
OVER = 100.0   # no ego step's shaped reward reaches this size


def cause_flags(env, X, opp, state, xdot) -> list:
    """The combat env's termination conditions, (bad, done, exceed) each, as
    its `_termination` lists them (the same list in both packages)."""
    cfg, model, m = env.config, env.model, state.model
    return [("overload", X.overload(cfg, model, m, xdot)),
            ("low_altitude", X.low_altitude(cfg, model, m)),
            ("high_speed", X.high_speed(cfg, model, m)),
            ("low_speed", X.low_speed(cfg, model, m)),
            ("extreme_state", X.extreme_state(cfg, model, m)),
            ("crash", X.crash(cfg, m.s[:, :3], m.s[opp, :3])),
            ("timeout", X.timeout(cfg, state.step_count)),
            ("shutdown", X.shutdown(cfg, state.blood, state.blood[opp]))]


def instrument_shoot(env, X, opp, f32) -> dict:
    """Add each cause's done and bad counts and the shutdown's per-agent
    win and lose flags to the env's step info (`x/...`), and keep the last
    step's output in the returned dict (under "out")."""
    term, step, box = env._termination, env.step, {}

    def termination(state, xdot):
        done, bad, exceed, info = term(state, xdot)
        for name, (b, d, _) in cause_flags(env, X, opp, state, xdot):
            info[f"x/{name}_bad"], info[f"x/{name}_done"] = b.sum(), d.sum()
            if name == "shutdown":
                info["x/win"], info["x/lose"] = f32(d), f32(b)
        return done, bad, exceed, info

    def stepped(state, action):
        state, out = step(state, action)
        box["out"] = out
        return state, out
    env._termination, env.step = termination, stepped
    return box


def shoot_step_counts(out, split, f32) -> dict:
    """One step's 0-d counts (summed over the collect as `shoot_*`): the
    cause counts, the ego's reward and each event rule's sum and the ego
    steps whose rest is OVER or more in size, pk_sum where the package's
    info lacks it."""
    info = out.info

    def ego(x):
        return split(x[:, None])[0]
    r, done, bad = ego(out.reward), ego(f32(out.done)), ego(f32(out.bad_done))
    win, lose = ego(info["x/win"]), ego(info["x/lose"])
    c = {"shoot_x_reward": r.sum(), "shoot_x_done": f32(out.done).sum(),
         "shoot_x_bad": f32(out.bad_done).sum(), "shoot_x_ego_done": done.sum(),
         "shoot_x_ego_bad": bad.sum(), "shoot_x_ego_win": win.sum(),
         "shoot_x_ego_lose": lose.sum()}
    for rule, ev in (("done_bad", 200.0 * (done - bad)), ("win_lose", 200.0 * (win - lose))):
        c[f"shoot_x_event_{rule}"] = ev.sum()
        c[f"shoot_x_over_{rule}"] = f32(abs(r - ev) >= OVER).sum()
    c.update({"shoot_x_" + k[2:]: v for k, v in info.items()
              if k.startswith("x/") and k[2:] not in ("win", "lose")})
    if "shoot/pk_sum" not in info:   # before c612e50: the per-agent vector only
        c["shoot_pk_sum"] = info["shoot/pk_dealt_vec"].sum()
    return c


def shoot_summary(counters: dict, ends: float) -> dict:
    """The collect's counts, its average episode reward as the runner logs
    it, and the reward split by each event rule (`reward_terms`)."""
    out = {k: float(v) for k, v in sorted(counters.items())}
    total = out["shoot_x_reward"]
    out["ends"] = ends
    out["average_episode_rewards"] = total / max(ends, 1.0)
    terms = {rule: {"event_sum": out[f"shoot_x_event_{rule}"],
                    "shaped_sum": total - out[f"shoot_x_event_{rule}"],
                    "over": out[f"shoot_x_over_{rule}"]}
             for rule in ("done_bad", "win_lose")}
    own = [rule for rule, t in terms.items() if t["over"] == 0]
    out["reward_terms"] = {"reward_sum": total, **terms,
                           "rule": own[0] if len(own) == 1 else None}
    return out


def agree(a: float, b: float) -> bool:
    """Two counts agree as samples: |a - b| <= 4 sqrt(a + b) + 1."""
    import math
    return abs(a - b) <= 4.0 * math.sqrt(abs(a) + abs(b)) + 1.0


def is_count(key: str) -> bool:
    """A collect's count (a sum of flags or pk weights), not a reward sum."""
    return not any(w in key for w in ("reward", "event"))


def compare_lines(a: dict, b: dict) -> list:
    """Rows (key, a, b, agree) for the counts of two lines' collects, and
    (key, a, b, None) for their reward sums and updates' train infos."""
    ca, cb = a["collect"], b["collect"]
    rows = [(k, ca[k], cb[k], agree(ca[k], cb[k]) if is_count(k) else None)
            for k in sorted(ca) if k in cb and isinstance(ca[k], float)]
    ra, rb = ca.get("reward_terms", {}), cb.get("reward_terms", {})
    for rule in ("done_bad", "win_lose"):
        if rule in ra and rule in rb:
            rows += [(f"{rule}.{k}", ra[rule][k], rb[rule][k], None)
                     for k in ("event_sum", "shaped_sum")]
    ua, ub = ca.get("update", {}), cb.get("update", {})
    rows += [(f"update.{k}", ua[k], ub[k], None) for k in sorted(ua) if k in ub]
    return rows


def load_actor(path: str):
    """A JAX actor pickle (or TrainState pickle's actor), or a port pool
    entry `actor_<n>.pt`, as the JAX param tree of numpy arrays."""
    if path.endswith(".pt"):
        from neuralplane_tpu_torch.algorithms.networks import params_to_jax
        from neuralplane_tpu_torch.algorithms.ppo import PPOPolicy
        from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
        from neuralplane_tpu_torch.envs import SingleCombatShootEnv
        from neuralplane_tpu_torch.utils.checkpoint import load_checkpoint
        env = SingleCombatShootEnv(num_envs=1, config=SHOOT, aero_backend="stacked",
                                   device="cpu")
        policy = PPOPolicy(RLConfig(use_prior=True), env.num_observation, env.num_actions,
                           act_space=env.action_space, prior_slots=env.shoot_prior_slots,
                           device="cpu")
        policy.actor.load_state_dict(load_checkpoint(path))
        return params_to_jax(policy.actor)
    return control_actor(path)


def run_jax_shoot(args, cfg_kw):
    """The JAX side of the shoot collect: (runner, summary, {}, seconds)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from neuralplane_tpu.algorithms.rl_config import RLConfig
    from neuralplane_tpu.envs import SingleCombatShootEnv
    from neuralplane_tpu.envs import combat
    from neuralplane_tpu.runner import SelfplayRunner

    class Runner(SelfplayRunner):
        def _collect_step(self, params, opp_params, carry):
            carry, data = super()._collect_step(params, opp_params, carry)
            data.update(shoot_step_counts(box["out"], self._split,
                                          lambda x: x.astype(jnp.float32)))
            return carry, data
    from neuralplane_tpu.utils.config import load_config
    env = SingleCombatShootEnv(num_envs=args.n, config=load_config(SHOOT, **args.set),
                               aero_backend=args.backend)
    box = instrument_shoot(env, combat.X, env._opponent_index(),
                           lambda x: x.astype(jnp.float32))
    run = Runner(env, RLConfig(**cfg_kw), run_dir=os.path.join(args.tmp, "jax"),
                 model_dir=getattr(args, "checkpoint", None))
    if getattr(args, "opponent", None):
        run.opponent_params = jax.tree.map(lambda x: jnp.asarray(x)[None],
                                           load_actor(args.opponent))
    carry = run.init_carry(jax.random.PRNGKey(args.seed))
    t0 = time.time()
    carry, batch, counters = run.collect(run.train_state.params, run.opponent_params, carry)
    ends = float((np.asarray(batch.masks[1:]) == 0).sum()
                 + (np.asarray(batch.bad_masks[1:]) == 0).sum())
    out = shoot_summary({k: np.asarray(v) for k, v in counters.items()}, ends)
    args.jax_params = jax.tree.map(np.asarray, run.train_state.params)
    args.jax_opponent = jax.tree.map(lambda x: np.asarray(x)[0], run.opponent_params)
    if args.update:
        out["update"] = {k: float(v) for k, v in run.train(batch).items()}
    return run, out, {}, time.time() - t0


def run_port_shoot(args, cfg_kw, jax_params):
    """The port's side of the shoot collect on the CPU: (summary, {}, seconds)."""
    from neuralplane_tpu_torch.algorithms.networks import params_from_jax
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.envs import SingleCombatShootEnv
    from neuralplane_tpu_torch.envs import combat
    from neuralplane_tpu_torch.runner import SelfplayRunner, team_split

    class Runner(SelfplayRunner):
        def _collect_step(self, carry):
            carry, data = super()._collect_step(carry)
            data.update(shoot_step_counts(box["out"], lambda x: team_split(self.env, x),
                                          lambda x: x.float()))
            return carry, data
    from neuralplane_tpu_torch.utils.config import load_config
    env = SingleCombatShootEnv(num_envs=args.n, config=load_config(SHOOT, **args.set),
                               aero_backend=args.backend, device="cpu")
    box = instrument_shoot(env, combat.X, env._opp, lambda x: x.float())
    run = Runner(env, RLConfig(**cfg_kw), run_dir=os.path.join(args.tmp, "port"))
    run.policy.load_state_dict(params_from_jax(jax_params))
    run.opponents[0].load_state_dict(params_from_jax(args.jax_opponent))
    carry = run.init_carry(args.seed)
    t0 = time.time()
    carry, batch, counters = run.collect(carry)
    ends = float((batch.masks[1:] == 0).sum() + (batch.bad_masks[1:] == 0).sum())
    out = shoot_summary({k: v.numpy() for k, v in counters.items()}, ends)
    if args.update:
        out["update"] = {k: float(v) for k, v in run.train(batch).items()}
    run.close()
    return out, {}, time.time() - t0


def collect_config(args) -> dict:
    """The RLConfig keywords of the collect: the run's chunk length."""
    return dict(n_rollout_threads=args.n, buffer_size=args.steps, seed=args.seed,
                data_chunk_length=10 if args.scenario == "tracking" else 8,
                **(SHOOT_FLAGS if args.scenario == SHOOT else {}))


def run_jax(args, cfg_kw):
    """The JAX side: (runner, collect summary, reset moments, seconds). On
    "pallas" the Pallas kernels run in interpret mode for this call."""
    import jax
    from jax.experimental import pallas as pl
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    orig = pl.pallas_call
    if args.backend in ("pallas", "distilled"):
        pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        if args.scenario == SHOOT:
            return run_jax_shoot(args, cfg_kw)
        return _run_jax(args, cfg_kw)
    finally:
        pl.pallas_call = orig


def _run_jax(args, cfg_kw):
    import jax
    import numpy as np
    from neuralplane_tpu.algorithms.rl_config import RLConfig
    from neuralplane_tpu.envs import ControlEnv, PlanningEnv
    from neuralplane_tpu.runner import F16SimRunner
    from neuralplane_tpu.utils.config import load_config
    config = load_config(args.scenario, **args.set) if args.set else args.scenario
    if args.scenario == "tracking":
        prev = os.environ.get("NEURALPLANE_AERO_BACKEND")
        os.environ["NEURALPLANE_AERO_BACKEND"] = args.backend
        try:
            env = PlanningEnv(num_envs=args.n, config=config,
                              low_level_params=control_actor(args.low_level_ckpt))
        finally:
            if prev is None:
                del os.environ["NEURALPLANE_AERO_BACKEND"]
            else:
                os.environ["NEURALPLANE_AERO_BACKEND"] = prev
    else:
        env = ControlEnv(num_envs=args.n, config=config, aero_backend=args.backend,
                         **({"task": args.scenario} if args.set else {}))
    if hasattr(env.config, "kernel_reset_draws") and (
            args.backend == "pallas"
            or (args.backend == "distilled" and args.scenario != "tracking")):
        # the TPU hardware PRNG has no interpret mode: the JAX side draws
        # the same distributions from jax.random outside the kernel
        env.config = env.config.replace(kernel_obs_noise=False, kernel_reset_draws=False)
    run = F16SimRunner(env, RLConfig(**cfg_kw), run_dir=os.path.join(args.tmp, "jax"),
                       model_dir=getattr(args, "checkpoint", None))
    carry = run.init_carry(jax.random.PRNGKey(args.seed))
    st = carry.env_state.env if args.scenario == "tracking" else carry.env_state
    stats = reset_stats(args.scenario, st.model.s, st.task, np.asarray)
    if getattr(args, "step_reset", False):
        stats["step_reset"] = jax_step_reset(args.scenario, env, args.seed + 1)
    t0 = time.time()
    carry, batch, (_, counters) = run.collect(run.train_state.params, carry)
    masks, bad = np.asarray(batch.masks[1:]), np.asarray(batch.bad_masks[1:])
    ends = float((masks == 0).sum() + (bad == 0).sum())
    out = summary({k: np.asarray(v) for k, v in counters.items()},
                  float(np.asarray(batch.rewards).sum()), ends)
    if getattr(args, "reward_terms", False):
        from neuralplane_tpu.envs import rewards
        out["reward_terms"] = reward_terms(
            np.asarray(batch.rewards), np.asarray(batch.masks), np.asarray(batch.bad_masks),
            out, rewards.event_driven_reward)
    # the collect's actor and critic, which the port's side starts from
    args.jax_params = jax.tree.map(np.asarray, run.train_state.params)
    if args.update:
        out["update"] = run.train(batch)
    return run, out, stats, time.time() - t0


def run_port(args, cfg_kw, jax_params):
    """The port's side on the CPU: (collect summary, reset moments, seconds)."""
    from neuralplane_tpu_torch.algorithms.networks import params_from_jax
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.envs import ControlEnv, PlanningEnv
    from neuralplane_tpu_torch.envs.planning import load_low_level_ckpt
    from neuralplane_tpu_torch.runner import F16SimRunner
    from neuralplane_tpu_torch.utils.config import load_config
    config = load_config(args.scenario, **args.set)
    if args.scenario == "tracking":
        env = PlanningEnv(num_envs=args.n, config=config, aero_backend=args.backend,
                          low_level_params=load_low_level_ckpt(args.low_level_ckpt),
                          device="cpu")
    else:
        env = ControlEnv(num_envs=args.n, config=config, task=args.scenario,
                         aero_backend=args.backend, device="cpu")
    run = F16SimRunner(env, RLConfig(**cfg_kw), run_dir=os.path.join(args.tmp, "port"))
    run.policy.load_state_dict(params_from_jax(jax_params))
    carry = run.init_carry(args.seed)
    st = carry.env_state.env if args.scenario == "tracking" else carry.env_state
    stats = reset_stats(args.scenario, st.model.s, st.task, lambda t: t.numpy())
    if getattr(args, "step_reset", False):
        stats["step_reset"] = port_step_reset(args.scenario, env)
    t0 = time.time()
    carry, batch, (_, counters) = run.collect(carry)
    ends = float((batch.masks[1:] == 0).sum() + (batch.bad_masks[1:] == 0).sum())
    out = summary({k: v.numpy() for k, v in counters.items()},
                  float(batch.rewards.sum()), ends)
    if getattr(args, "reward_terms", False):
        import torch
        from neuralplane_tpu_torch.envs import rewards
        out["reward_terms"] = reward_terms(
            batch.rewards.numpy(), batch.masks.numpy(), batch.bad_masks.numpy(), out,
            lambda d, b: rewards.event_driven_reward(torch.from_numpy(d),
                                                     torch.from_numpy(b)).numpy())
    if args.update:
        out["update"] = run.train(batch)
    run.close()
    return out, stats, time.time() - t0


def main(argv=None) -> int:
    import tempfile
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="heading", choices=sorted(TARGETS) + [SHOOT])
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--backend", default=None, choices=["pallas", "distilled", "stacked"],
                    help="default: pallas for heading, distilled for tracking")
    ap.add_argument("--low-level-ckpt", default=CONTROL_CKPT,
                    help="tracking: the frozen control actor (a JAX pickle)")
    ap.add_argument("--package", default="both", choices=["both", "jax"])
    ap.add_argument("--jax-root", default=None,
                    help="import neuralplane_tpu from this checkout instead")
    ap.add_argument("--update", action="store_true",
                    help="then one PPO update on the collected batch: its train infos "
                    "under `update` (the port's minibatches come from its own generator)")
    ap.add_argument("--checkpoint", default=None,
                    help="a JAX pickle whose actor both packages collect with")
    ap.add_argument("--step-reset", action="store_true",
                    help="also the moments after one step from the all-done state, "
                    "every row reset inside the step (under reset.step_reset)")
    ap.add_argument("--reward-terms", action="store_true",
                    help="split each collect's reward sum into the event and shaped terms "
                    "(under collect.reward_terms)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a key of the heading scenario's config")
    ap.add_argument("--opponent", default=None,
                    help="selfplay_shoot_evadable: the opponent's actor (a JAX pickle or "
                    "a port actor_<n>.pt) instead of the ego's initial actor")
    ap.add_argument("--out", default=None, help="append the lines to this file too")
    ap.add_argument("--compare", nargs=2, default=None, metavar=("A", "B"),
                    help="print the counts of two files' first lines side by side")
    args = ap.parse_args(argv)
    if args.compare:
        a, b = (json.loads(open(p, encoding="utf-8").readline()) for p in args.compare)
        for key, va, vb, ok in compare_lines(a, b):
            print(json.dumps({"key": key, "a": va, "b": vb, "agree": ok}))
        return 0
    args.set = {k: json.loads(v) for k, v in (kv.split("=", 1) for kv in args.set)}
    args.backend = args.backend or ("distilled" if args.scenario in ("tracking", SHOOT)
                                    else "pallas")
    if args.jax_root:
        sys.path.insert(0, os.path.abspath(args.jax_root))
    cfg_kw = collect_config(args)
    with tempfile.TemporaryDirectory() as tmp:
        args.tmp = tmp
        jrun, jout, jstats, jsec = run_jax(args, cfg_kw)
        import neuralplane_tpu
        rows = [("jax", jout, jstats, jsec)]
        if args.package == "both":
            port = run_port_shoot if args.scenario == SHOOT else run_port
            rows.append(("port", *port(args, cfg_kw, args.jax_params)))
        jrun.close()
    for name, out, stats, sec in rows:
        where = os.path.dirname(os.path.dirname(neuralplane_tpu.__file__)) \
            if name == "jax" else REPO
        line = json.dumps({"package": name, "root": os.path.relpath(where, REPO),
                          "scenario": args.scenario, "n": args.n, "steps": args.steps,
                          "backend": args.backend,
                          "seed": args.seed, "set": args.set,
                          "checkpoint": args.checkpoint, "collect": out,
                          "opponent": args.opponent, "reset": stats,
                          "collect_s": round(sec, 1)})
        print(line)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
