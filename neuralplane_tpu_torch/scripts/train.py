"""Training CLI, the Control, Planning and combat branches (counterpart of
neuralplane_tpu/scripts/train.py:1-258).

The same argparse flags and `args_to_config`, so the JAX package's launch
lines run here unchanged, plus `--device` (the reference's --cuda; default
"cuda") and `--aero-backend` (the F-16's aero surrogate, default "auto"):

  python -m neuralplane_tpu_torch.scripts.train --env-name Control \
      --scenario-name heading --n-rollout-threads 3000 --buffer-size 1000 \
      --num-mini-batch 5 --ppo-epoch 16 --lr 3e-4 --gamma 0.99 \
      --entropy-coef 1e-3 --max-grad-norm 2 --data-chunk-length 8 \
      --num-env-steps 1.35e9

`--env-name Planning --scenario-name tracking --low-level-ckpt
results/control/policy_checkpoint.pkl` trains the high level of the
hierarchical env over a frozen control policy (a JAX pickle or a port
`.pt`); `--model-name UAV|C172P` picks the other airframes of the Control
env. `--env-name SingleCombat --scenario-name selfplay --use-selfplay`
trains 1v1 self-play against a pool of frozen past selves (SelfplayRunner;
`scripts/train_selfplay.sh` has the repo's flags); `--env-name
SingleCombatShoot --scenario-name selfplay_shoot --use-prior` the same with
missiles (`scripts/train_shoot.sh`). `--env-name MultipleCombat` and
`MultipleCombatShoot` build the team games, whose self-play needs
`--algorithm-name mappo` (MAPPOSelfplayRunner, a centralized critic;
`scripts/train_multiplecombat_shoot.sh`), as in the JAX CLI. `--model-dir`
resumes from the port's checkpoints and from the JAX package's (a run
directory, `state_*.pkl`, `results/*/policy_checkpoint.pkl`).

`--use-mesh` trains data-parallel, one process per rank, under a launcher:

  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m neuralplane_tpu_torch.scripts.train --use-mesh ...

Each rank initializes torch.distributed from the launcher's environment
(parallel/distributed.py: NCCL when every rank has a card of its own, gloo
on the CPU or when ranks share a card) and runs on cuda:LOCAL_RANK (or the
`--device` given). `--n-rollout-threads` stays the global count: each rank
builds `n_rollout_threads // world` envs (and the eval env likewise), which
must divide. Every runner gets the mesh: F16SimRunner, SelfplayRunner and
MAPPOSelfplayRunner (the JAX CLI passes it to F16SimRunner only, :236-250).
Without a launcher the world size is 1 and the run is the one without the
flag.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import torch

from ..algorithms.rl_config import RLConfig
from .. import envs
from ..envs.planning import load_low_level_ckpt
from ..parallel import Mesh, broadcast, make_global_mesh, shard_count
from ..runner import F16SimRunner, MAPPOSelfplayRunner, SelfplayRunner

# the combat envs by --env-name
COMBAT = {"SingleCombat": envs.SingleCombatEnv, "SingleCombatShoot": envs.SingleCombatShootEnv,
          "MultipleCombat": envs.MultipleCombatEnv,
          "MultipleCombatShoot": envs.MultipleCombatShootEnv}


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("neuralplane_tpu_torch.train")
    # prepare
    p.add_argument("--algorithm-name", default="ppo",
                   choices=["ppo", "mappo"])
    p.add_argument("--experiment-name", default="check")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--n-rollout-threads", type=int, default=4)
    p.add_argument("--num-env-steps", type=float, default=1e7)
    p.add_argument("--model-dir", default=None)
    # env
    p.add_argument("--env-name", default="Control",
                   choices=["Control", "Planning", "SingleCombat",
                            "SingleCombatShoot", "MultipleCombat",
                            "MultipleCombatShoot"])
    p.add_argument("--scenario-name", default="heading")
    p.add_argument("--model-name", default="F16", choices=["F16", "UAV", "C172P"])
    # buffer
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--buffer-size", type=int, default=200)
    p.add_argument("--use-proper-time-limits", action="store_true")
    p.add_argument("--use-gae", action="store_false", default=True)
    p.add_argument("--gae-lambda", type=float, default=0.95)
    # network
    p.add_argument("--hidden-size", default="128 128")
    p.add_argument("--act-hidden-size", default="128 128")
    p.add_argument("--activation-id", type=int, default=1)
    p.add_argument("--use-feature-normalization", action="store_true",
                   default=True)
    p.add_argument("--use-prior", action="store_true",
                   help="Beta-prior missile-shoot head (config.py:123); only "
                   "affects Tuple(MultiDiscrete, Discrete) action spaces - "
                   "see algorithms/heads.py shoot_priors")
    p.add_argument("--gain", type=float, default=0.01)
    # recurrent
    p.add_argument("--use-recurrent-policy", action="store_false",
                   default=True)
    p.add_argument("--recurrent-hidden-size", type=int, default=128)
    p.add_argument("--recurrent-hidden-layers", type=int, default=1)
    p.add_argument("--data-chunk-length", type=int, default=10)
    # optimizer / ppo
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--ppo-epoch", type=int, default=10)
    p.add_argument("--clip-param", type=float, default=0.2)
    p.add_argument("--use-clipped-value-loss", action="store_true")
    p.add_argument("--num-mini-batch", type=int, default=1)
    p.add_argument("--value-loss-coef", type=float, default=1.0)
    p.add_argument("--entropy-coef", type=float, default=0.01)
    p.add_argument("--use-max-grad-norm", action="store_false", default=True)
    p.add_argument("--max-grad-norm", type=float, default=2.0)
    p.add_argument("--min-log-std", type=float, default=None,
                   help="beyond reference: exploration floor on the "
                   "Gaussian head's learnable log_std (e.g. -2.3 keeps "
                   "sigma >= ~0.1); default None = no floor, exact "
                   "reference behavior (long entropy-annealed runs can "
                   "collapse sigma, see results/mappo_2v2)")
    p.add_argument("--remat-save-dots", action="store_true",
                   help="the JAX package's BPTT remat policy; accepted and "
                   "kept in the config, selects nothing in the port (it "
                   "keeps all activations)")
    # selfplay
    p.add_argument("--use-selfplay", action="store_true")
    p.add_argument("--selfplay-algorithm", default="sp",
                   choices=["sp", "fsp", "pfsp"])
    p.add_argument("--n-choose-opponents", type=int, default=1)
    p.add_argument("--init-elo", type=float, default=1000.0)
    p.add_argument("--elo-tie-band", type=float, default=100.0,
                   help="per-episode avg reward diff below which an ELO "
                   "eval match is a tie (reference constant 100; combat "
                   "posture rewards need ~1.0)")
    # save / log / eval
    p.add_argument("--save-interval", type=int, default=1)
    p.add_argument("--log-interval", type=int, default=5)
    p.add_argument("--use-eval", action="store_true")
    p.add_argument("--n-eval-rollout-threads", type=int, default=None,
                   help="build a dedicated eval env with this many envs "
                   "(reference default 1); when omitted, ELO eval plays on "
                   "the training env (full episode statistics)")
    p.add_argument("--eval-interval", type=int, default=25)
    p.add_argument("--eval-episodes", type=int, default=32)
    p.add_argument("--eval-stochastic", action="store_true",
                   help="beyond reference: SAMPLE actions in ELO eval "
                   "matches (behavioral protocol) instead of deterministic "
                   "modes; on team combat the deterministic protocol "
                   "produces ~no kills and the ELO ladder never moves")
    p.add_argument("--eval-event-scoring", action="store_true",
                   help="beyond reference: score team-game ELO eval "
                   "episodes on decisive team-wipe events (win/loss from "
                   "StepOutput.active) instead of the banded mean-reward "
                   "W/T/L, which is near-silent on team combat")
    p.add_argument("--use-tensorboard", action="store_true")
    p.add_argument("--run-dir", default=None)
    p.add_argument("--low-level-ckpt", default=None,
                   help="Planning env: trained control-task actor checkpoint")
    p.add_argument("--use-mesh", action="store_true",
                   help="data parallelism, one process per rank under "
                   "torch.distributed.run: the env batch split over the ranks, "
                   "the policy replicated, gradients all-reduced")
    # the port's own
    p.add_argument("--device", default="cuda",
                   help="torch device of the env, the policy and the update "
                   "(the reference's --cuda); 'cpu' runs every kernel's plain "
                   "PyTorch version")
    p.add_argument("--aero-backend", default="auto",
                   choices=["auto", "distilled", "pallas", "stacked"],
                   help="aero surrogate of the F-16 (the env's aero_backend; "
                   "NEURALPLANE_AERO_BACKEND overrides it)")
    return p


def args_to_config(args: argparse.Namespace) -> RLConfig:
    return RLConfig(
        algorithm_name=args.algorithm_name,
        experiment_name=args.experiment_name,
        seed=args.seed,
        n_rollout_threads=args.n_rollout_threads,
        num_env_steps=args.num_env_steps,
        gamma=args.gamma, buffer_size=args.buffer_size,
        use_proper_time_limits=args.use_proper_time_limits,
        use_gae=args.use_gae, gae_lambda=args.gae_lambda,
        hidden_sizes=tuple(int(x) for x in args.hidden_size.split()),
        act_hidden_sizes=tuple(int(x) for x in args.act_hidden_size.split()),
        activation=["tanh", "relu", "leaky_relu", "elu"][args.activation_id],
        use_feature_normalization=args.use_feature_normalization,
        use_prior=args.use_prior,
        gain=args.gain,
        use_recurrent_policy=args.use_recurrent_policy,
        recurrent_hidden_size=args.recurrent_hidden_size,
        recurrent_hidden_layers=args.recurrent_hidden_layers,
        data_chunk_length=args.data_chunk_length,
        lr=args.lr, ppo_epoch=args.ppo_epoch, clip_param=args.clip_param,
        use_clipped_value_loss=args.use_clipped_value_loss,
        num_mini_batch=args.num_mini_batch,
        value_loss_coef=args.value_loss_coef,
        entropy_coef=args.entropy_coef,
        use_max_grad_norm=args.use_max_grad_norm,
        max_grad_norm=args.max_grad_norm,
        min_log_std=args.min_log_std,
        remat_save_dots=args.remat_save_dots,
        use_selfplay=args.use_selfplay,
        selfplay_algorithm=args.selfplay_algorithm,
        n_choose_opponents=args.n_choose_opponents,
        init_elo=args.init_elo,
        elo_tie_band=args.elo_tie_band,
        save_interval=args.save_interval, log_interval=args.log_interval,
        use_eval=args.use_eval, eval_stochastic=args.eval_stochastic,
        eval_event_scoring=args.eval_event_scoring,
        n_eval_rollout_threads=args.n_eval_rollout_threads or 1,
        eval_interval=args.eval_interval, eval_episodes=args.eval_episodes,
    )


def make_env(args: argparse.Namespace, num_envs: int = None, mesh: Mesh = None):
    """The env of `num_envs` (default --n-rollout-threads) envs in all; with
    a mesh, this rank's share of them."""
    n = num_envs if num_envs is not None else args.n_rollout_threads
    if mesh is not None:
        n = shard_count(n, mesh)
    if args.env_name == "Control":
        return envs.ControlEnv(num_envs=n, config=args.scenario_name,
                          model=args.model_name, aero_backend=args.aero_backend,
                          device=args.device)
    if args.env_name == "Planning":
        low = load_low_level_ckpt(args.low_level_ckpt) if args.low_level_ckpt else None
        return envs.PlanningEnv(num_envs=n, config=args.scenario_name, model=args.model_name,
                           low_level_params=low, aero_backend=args.aero_backend,
                           device=args.device)
    return COMBAT[args.env_name](num_envs=n, config=args.scenario_name,
                                 aero_backend=args.aero_backend, device=args.device)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    if (args.env_name in ("MultipleCombat", "MultipleCombatShoot")
            and args.use_selfplay and args.algorithm_name != "mappo"):
        raise SystemExit(
            "MultipleCombat self-play requires --algorithm-name mappo: the "
            "team env has mid-episode deaths, and only the MAPPO runner's "
            "active_masks stop dead agents' frozen-corpse transitions from "
            "training at full weight")
    mesh = None
    if args.use_mesh:
        mesh = make_global_mesh(args.device)
        args.device = str(mesh.device)
    cfg = args_to_config(args)
    env = make_env(args, mesh=mesh)
    eval_env = (make_env(args, num_envs=args.n_eval_rollout_threads, mesh=mesh)
                if args.use_eval and args.n_eval_rollout_threads else None)

    # rank 0's clock names a default run directory for every rank
    stamp = torch.tensor([time.time()], dtype=torch.float64,
                         device=mesh.device if mesh is not None else "cpu")
    broadcast([stamp], mesh)
    run_dir = args.run_dir or os.path.join(
        "runs", f"{time.strftime('%Y-%m-%d_%H-%M-%S', time.localtime(stamp.item()))}_"
        f"{args.env_name}_{args.scenario_name}_{args.model_name}_{args.algorithm_name}_"
        f"{args.experiment_name}")
    runner_cls = F16SimRunner
    if args.use_selfplay:
        runner_cls = MAPPOSelfplayRunner if args.algorithm_name == "mappo" else SelfplayRunner
    runner = runner_cls(env, cfg, run_dir=run_dir, eval_env=eval_env,
                        model_dir=args.model_dir, use_tensorboard=args.use_tensorboard,
                        mesh=mesh)
    try:
        runner.run()
    finally:
        runner.close()


if __name__ == "__main__":
    main()
