"""Render / evaluation CLI: deterministic rollouts -> ACMI + npy + metrics
(counterpart of neuralplane_tpu/scripts/render.py).

  --mode ppo      a trained policy on a control env (render_ppo.py)
  --mode pid      the PID/TECS/L1 controller instead (render_control.py)
  --mode combat   two policies, 1v1 or team, guns or missiles
  --mode planning the high-level tracking policy over a frozen low-level
                  control actor

    python -m neuralplane_tpu_torch.scripts.render --mode ppo \
        --checkpoint results/heading/policy_checkpoint.pkl --steps 2000 --out render_out

Outputs: <out>/result/*.npy channel buffers, <out>/recording.txt.acmi, and
the metrics printed as JSON (evaluate_result's metrics with the success rate
for the control modes; steps, blood, missile launches, hits and ammo for
combat). <out>/result.png where matplotlib is installed; without it the
figure is skipped with one line and everything else is written.

Checkpoints are the port's own (`state_*.pt`, `actor_*.pt`) or the JAX
package's pickles (read without JAX). The env runs on `--device` (default
the card): each frame's channels, pose and step statistics are gathered on
the device into one tensor and copied to the host once. A control frame
launches the env step once (`env_step` on a fused F-16 env) and the state
derivative once more for the G channel (which the PID mode also reads for
its next action); a planning frame runs 2 x low_level_steps derivatives in
the env and one for the channels; a 1v1 combat frame runs 11, a team frame 3.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..algorithms.pid import Controller, flight_data
from ..algorithms.ppo import PPOPolicy
from ..algorithms.rl_config import RLConfig
from ..envs import (ControlEnv, MultipleCombatEnv, MultipleCombatShootEnv, PlanningEnv,
                    SingleCombatEnv, SingleCombatShootEnv)
from ..envs.planning import load_low_level_ckpt
from ..render import ACMIWriter, TrajectoryRecorder, evaluate_metrics, model_channels, \
    plot_result

TARGETS = ("target_altitude", "target_heading", "target_vt", "target_pitch",
           "target_npos", "target_epos")


def _load_actor(actor: torch.nn.Module, path: str) -> None:
    """The actor of a checkpoint file (port `.pt` or JAX pickle) into `actor`."""
    actor.load_state_dict(load_low_level_ckpt(path))


def _plot(buffers, out_path: str, dt: float) -> None:
    try:
        plot_result(buffers, out_path, dt=dt)
    except ImportError:
        print(f"figure skipped: matplotlib is not installed ({out_path} not written)")


@torch.no_grad()
def render_control(args) -> dict:
    dev = torch.device(args.device)
    planning = args.mode == "planning"
    if planning:
        low = load_low_level_ckpt(args.low_level_ckpt) if args.low_level_ckpt else None
        env = PlanningEnv(num_envs=args.num_envs, config=args.scenario, low_level_params=low,
                          aero_backend=args.aero_backend, device=dev)
    else:
        env = ControlEnv(num_envs=args.num_envs, config=args.scenario, model=args.model_name,
                         aero_backend=args.aero_backend, device=dev)
    policy = PPOPolicy(RLConfig(), env.num_observation, env.num_actions, device=dev)
    if args.mode in ("ppo", "planning") and args.checkpoint:
        _load_actor(policy.actor, args.checkpoint)
    controller = Controller(dt=env.config.dt)
    # one ACMI frame per env step: dt for control, dt * inner for planning
    frame_dt = env.config.dt * (env.low_level_steps if planning else 1)
    n, model = env.n, env.model

    state, obs = env.reset(args.seed)
    h, _ = policy.init_rnn_states(n)
    cst = controller.init_state(n, device=dev)
    masks = torch.ones((n, 1), device=dev)
    rec = TrajectoryRecorder()
    acmi = ACMIWriter(os.path.join(args.out, "recording.txt.acmi"))
    reached, failed, episode_reward = 0, 0, 0.0
    es = state.env if planning else state
    xdot = model.extended_state(es.model) if args.mode == "pid" else None

    def pid_act(cst, es, xdot):
        """Hold the task's targets with the classical stack."""
        mstate, tstate = es.model, es.task
        data = flight_data(model, mstate, xdot)
        _, _, alt = model.get_position(mstate)
        hdg = getattr(tstate, "target_heading", data.yaw)
        tvt = getattr(tstate, "target_vt", torch.full((n,), 1100.0, device=dev))
        talt = getattr(tstate, "target_altitude", alt)
        cst = controller.update_heading_hold(cst, hdg, data)
        cst = controller.cal_pitch_throttle(cst, talt, tvt, alt, data)
        cst = controller.stabilize(cst, data)
        return cst, torch.clamp(controller.get_action(cst), -1.0, 1.0)

    for count in range(args.steps):
        if args.mode in ("ppo", "planning"):
            actions, h = policy.act(obs, h, masks, deterministic=True)
        else:
            cst, actions = pid_act(cst, es, xdot)
        state, out = env.step(state, actions)
        obs = out.obs
        reset = out.done | out.bad_done | out.exceed_time_limit
        masks = 1.0 - out.done.float()[:, None]
        h = h * (1.0 - reset.float())[:, None, None]

        es = state.env if planning else state
        xdot = model.extended_state(es.model)
        ch = model_channels(model, es.model, xdot)
        ch.update({k: getattr(es.task, k).float().mean() for k in TARGETS
                   if hasattr(es.task, k)})
        stats = [out.done.sum().float(), out.bad_done.sum().float(), out.reward.mean()]
        # everything the host needs from this frame in one copy
        frame = torch.cat([torch.stack(list(ch.values()) + stats),
                           es.model.s[:, :6].reshape(-1)]).cpu()
        k = len(ch)
        rec.record(**dict(zip(ch, frame[:k].tolist())))
        n_done, n_bad, rew = frame[k:k + 3].tolist()
        reached += int(n_done)
        failed += int(n_bad)
        episode_reward += rew
        acmi.write_frame(count * frame_dt, frame[k + 3:].reshape(n, 6).numpy())

    rec.save(os.path.join(args.out, "result"))
    buffers = rec.arrays()
    _plot(buffers, os.path.join(args.out, "result.png"), env.config.dt)
    metrics = evaluate_metrics(buffers)
    total = max(reached + failed, 1)
    metrics.update(episode_reward=episode_reward, reached_target=reached, failed=failed,
                   success_rate=reached / total)
    print(json.dumps(metrics, indent=2))
    return metrics


def _resolve_pool_ckpt(model_dir: str, index: str) -> str:
    """Map a pool index to a checkpoint file: actor_<index>, falling back to
    state_<index> (full train-state saves use that prefix), each as the
    port's `.pt` or the JAX package's `.pkl`."""
    for name in (f"actor_{index}.pt", f"actor_{index}.pkl",
                 f"state_{index}.pt", f"state_{index}.pkl"):
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no actor_{index} or state_{index} (.pt, .pkl) in {model_dir}")


@torch.no_grad()
def render_combat(args) -> dict:
    # team scenarios use the nvn env, "shoot" scenarios the missile env
    if "multiple" in args.scenario and "shoot" in args.scenario:
        env_cls = MultipleCombatShootEnv
    elif "multiple" in args.scenario:
        env_cls = MultipleCombatEnv
    elif "shoot" in args.scenario:
        env_cls = SingleCombatShootEnv
    else:
        env_cls = SingleCombatEnv
    dev = torch.device(args.device)
    env = env_cls(num_envs=1, config=args.scenario, aero_backend=args.aero_backend,
                  device=dev)
    n = env.n
    half = n // 2
    # every missile run of the repo trains with the Beta launch prior
    # (scripts/train_*shoot*.sh), so a ShootTuple policy flies with it; the
    # JAX render builds its policy without (RLConfig's default)
    policy = PPOPolicy(RLConfig(use_prior=True), env.num_observation,
                       env.num_actions, act_space=getattr(env, "action_space", None),
                       prior_slots=getattr(env, "shoot_prior_slots", (11, 13)), device=dev)
    ego = policy.actor
    if args.checkpoint:
        _load_actor(ego, args.checkpoint)
    enm = ego
    if args.opponent:
        enm = policy.init_actor_params(torch.Generator().manual_seed(0)).to(dev)
        _load_actor(enm, args.opponent)

    state, obs = env.reset(args.seed)
    h_e, _ = policy.init_rnn_states(half)
    h_o, _ = policy.init_rnn_states(half)
    ones = torch.ones((half, 1), device=dev)
    acmi = ACMIWriter(os.path.join(args.out, "recording.txt.acmi"))
    colors = ["Red"] * half + ["Blue"] * half
    prev_active = None
    launches = hits = 0
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    det = not args.stochastic

    def act(actor, obs, h):
        dist, h = actor.dist_step(obs, h, ones)
        return (dist.mode() if det else dist.sample(gen)), h

    for count in range(args.steps):
        a_e, h_e = act(ego, obs[:half], h_e)
        a_o, h_o = act(enm, obs[half:], h_o)
        state, out = env.step(state, torch.cat([a_e, a_o], dim=0))
        obs = out.obs
        mis = getattr(state, "missiles", None)
        parts = [state.model.s[:, :6].reshape(-1),
                 (out.done | out.bad_done).any().float()[None]]
        if mis is not None:
            parts += [out.info["shoot/launches"].float()[None],
                      out.info["shoot/hits"].float()[None], mis.active.float().reshape(-1),
                      mis.pos.reshape(-1), mis.vel.reshape(-1)]
        frame = torch.cat(parts).cpu().numpy()   # the frame's one copy to the host
        s, ended = frame[:n * 6].reshape(n, 6), bool(frame[n * 6])
        acmi.write_frame(count * env.config.dt * env.inner_steps, s, colors=colors)
        if mis is not None:
            k = mis.active.shape[1]
            launches += int(frame[n * 6 + 1])
            hits += int(frame[n * 6 + 2])
            o = n * 6 + 3
            active = frame[o:o + n * k].reshape(n, k) > 0.5
            pos = frame[o + n * k:o + 4 * n * k].reshape(n, k, 3)
            vel = frame[o + 4 * n * k:o + 7 * n * k].reshape(n, k, 3)
            for i, j in zip(*np.nonzero(active)):
                yaw = np.arctan2(vel[i, j, 1], vel[i, j, 0])
                pitch = np.arctan2(vel[i, j, 2], np.hypot(vel[i, j, 0], vel[i, j, 1]))
                acmi.write_object(1000 + i * k + int(j),
                                  np.concatenate([pos[i, j], [0.0, pitch, yaw]]),
                                  name="AAM", color=colors[i])
            if prev_active is not None:
                for i, j in zip(*np.nonzero(prev_active & ~active)):
                    acmi.remove_object(1000 + i * k + int(j))
            prev_active = active
        if ended:
            break
    rec = {"steps": count + 1, "blood": state.blood.cpu().tolist()}
    if prev_active is not None:
        rec.update(launches=launches, hits=hits, ammo=state.ammo.cpu().tolist())
    print(json.dumps(rec))
    return rec


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("neuralplane_tpu_torch.render")
    p.add_argument("--mode", default="ppo", choices=["ppo", "pid", "combat", "planning"])
    p.add_argument("--scenario", default=None,
                   help="defaults to 'heading' (ppo/pid), 'selfplay' (combat) "
                   "or 'tracking' (planning)")
    p.add_argument("--checkpoint", default=None,
                   help="state_*.pt / actor_*.pt of a port run, or a JAX package pickle")
    p.add_argument("--opponent", default=None, help="combat: enemy actor ckpt")
    p.add_argument("--model-dir", default=None,
                   help="checkpoint dir; combined with --render-index/"
                   "--render-opponent-index to pick pool entries")
    p.add_argument("--render-index", default="latest",
                   help="ego policy index in --model-dir's pool "
                   "(actor_<index>; 'latest' -> state_latest)")
    p.add_argument("--render-opponent-index", default="latest",
                   help="opponent policy index in --model-dir's pool")
    p.add_argument("--low-level-ckpt", default=None,
                   help="planning: trained control-task actor checkpoint")
    p.add_argument("--model-name", default="F16", choices=["F16", "UAV", "C172P"],
                   help="vehicle model for ppo/pid modes")
    p.add_argument("--num-envs", type=int, default=1)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stochastic", action="store_true",
                   help="combat mode: SAMPLE both policies instead of the "
                   "deterministic reference protocol (a deterministic missile "
                   "duel between posture-fighters may never fire)")
    p.add_argument("--out", default="render_out")
    # the port's own
    p.add_argument("--device", default="cuda")
    p.add_argument("--aero-backend", default="auto",
                   choices=["auto", "distilled", "pallas", "stacked"])
    return p


def main(argv=None) -> dict:
    args = get_parser().parse_args(argv)
    if args.model_dir:
        # explicit --checkpoint/--opponent paths take precedence
        args.checkpoint = args.checkpoint or _resolve_pool_ckpt(args.model_dir,
                                                                args.render_index)
        args.opponent = args.opponent or _resolve_pool_ckpt(args.model_dir,
                                                            args.render_opponent_index)
    os.makedirs(args.out, exist_ok=True)
    if args.mode == "combat":
        args.scenario = args.scenario or "selfplay"
        return render_combat(args)
    args.scenario = args.scenario or ("tracking" if args.mode == "planning" else "heading")
    return render_control(args)


if __name__ == "__main__":
    main()
