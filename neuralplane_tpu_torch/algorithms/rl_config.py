"""RL hyperparameter configuration (counterpart of
neuralplane_tpu/algorithms/rl_config.py:13-105).

The same frozen dataclass with the same fields and defaults, so launch
scripts and checkpoints translate 1:1 between the two packages.

`remat_save_dots` selects nothing in the port. The JAX package recomputes
the GRU's per-step activations in the PPO backward (`jax.checkpoint`) only to
save memory; values and gradients are the same either way
(neuralplane_tpu/algorithms/networks.py:62-69). The port's update keeps every
activation of a minibatch, as autograd does by default. At the heading
training configuration (3000 envs, buffer 1000, chunks of 8, 5 minibatches
of 75,000 chunks, default networks) a training episode peaks at 12,723 MiB
of device memory on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 15;
PERF.md section 5, "Training (Slice B)").
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RLConfig:
    # prepare (config.py:49-66)
    algorithm_name: str = "ppo"            # ppo | mappo
    experiment_name: str = "check"
    seed: int = 1
    n_rollout_threads: int = 4
    num_env_steps: float = 1e7

    # replay buffer (config.py:85-94)
    gamma: float = 0.99
    buffer_size: int = 200
    use_proper_time_limits: bool = False
    use_gae: bool = True
    gae_lambda: float = 0.95

    # network (config.py:113-123)
    hidden_sizes: Tuple[int, ...] = (128, 128)
    act_hidden_sizes: Tuple[int, ...] = (128, 128)
    activation: str = "relu"               # tanh | relu | leaky_relu | elu
    use_feature_normalization: bool = True
    gain: float = 0.01
    use_prior: bool = False

    # recurrent (config.py:141-148)
    use_recurrent_policy: bool = True
    recurrent_hidden_size: int = 128
    recurrent_hidden_layers: int = 1
    data_chunk_length: int = 10

    # optimizer (config.py:159-160)
    lr: float = 5e-4

    # ppo (config.py:185-200)
    ppo_epoch: int = 10
    clip_param: float = 0.2
    use_clipped_value_loss: bool = False
    num_mini_batch: int = 1
    value_loss_coef: float = 1.0
    entropy_coef: float = 0.01
    use_max_grad_norm: bool = True
    max_grad_norm: float = 2.0
    # beyond reference: floor on the Gaussian head's learnable log_std
    # (None = no floor = reference behavior). Long entropy-annealed selfplay
    # runs collapse sigma to ~1e-6 (results/mappo_2v2: entropy -49 by 1.5e9
    # steps), killing exploration; -2.3 keeps sigma >= ~0.1.
    min_log_std: "float | None" = None
    # The JAX package's BPTT remat policy. Kept so that configurations carry
    # across; the port holds all activations and reads it nowhere (module
    # docstring).
    remat_save_dots: bool = False

    # selfplay (config.py:217-224)
    use_selfplay: bool = False
    selfplay_algorithm: str = "sp"         # sp | fsp | pfsp
    n_choose_opponents: int = 1
    init_elo: float = 1000.0
    # Win/tie band on the PER-EPISODE average reward diff in ELO eval.
    # The reference hardcodes 100 (`selfplay_F16sim_runner.py:225-228`) -
    # but its combat reward is posture-only (<=0.01*2/step, so an episode
    # average can never reach 100): every reference eval is a forced tie
    # and its ladder can never leave init_elo. Keep the band configurable
    # and calibrate it to the reward scale (combat scripts use ~1.0).
    elo_tie_band: float = 100.0

    # save / log / eval / render (config.py:235-285)
    save_interval: int = 1
    log_interval: int = 5
    use_eval: bool = False
    n_eval_rollout_threads: int = 1
    eval_interval: int = 25
    eval_episodes: int = 32
    # beyond reference: SAMPLE actions in ELO eval matches instead of the
    # reference's deterministic modes (selfplay_F16sim_runner.py:168-178).
    # On team combat the deterministic protocol yields ~no kill events
    # (results/mappo_2v2), leaving the in-training ELO ladder frozen.
    eval_stochastic: bool = False
    # beyond reference: score team-game ELO eval episodes on DECISIVE
    # events (team wipes from StepOutput.active) instead of the banded
    # mean-reward W/T/L. The banded protocol is near-silent on team
    # combat below multi-1e9 budgets (latest_elo stayed at init through
    # the full 1e9 2v2-evadable run, results/mappo_2v2_evadable): team
    # posture diffs live inside any honest band while wipe counts move.
    # ELO gets the fractional score (wins + ties/2) / episodes, so any
    # wipe surplus moves the rating.
    eval_event_scoring: bool = False
    render_opponent_index: str = "latest"
    render_index: str = "latest"

    def replace(self, **kwargs) -> "RLConfig":
        return dataclasses.replace(self, **kwargs)
