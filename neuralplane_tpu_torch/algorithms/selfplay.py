"""Self-play opponent sampling: SP / FSP / PFSP + ELO bookkeeping (the
port's copy of neuralplane_tpu/algorithms/selfplay.py, host-side numpy in
both packages: pool selection happens between rollouts).

ELO K = 32, win/tie/loss from the episode-reward difference with a tie
band.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def choose_opponent(algo: str, pool_elo: Dict[str, float],
                    rng: np.random.Generator, lam: float = 1.0,
                    s: float = 100.0) -> str:
    """Pick one opponent id from the pool."""
    keys = list(pool_elo.keys())
    if not keys:
        raise ValueError("empty opponent pool")
    if algo == "sp":        # latest (selfplay.py:27-31)
        return keys[-1]
    if algo == "fsp":       # uniform (selfplay.py:38-42)
        return keys[rng.integers(len(keys))]
    if algo == "pfsp":      # ELO-median logistic -> softmax meta-solver
        elo = np.array(list(pool_elo.values()), dtype=np.float64)
        probs = 1.0 / (1.0 + 10.0 ** (-(elo - np.median(elo)) / 400.0)) * s
        k = float(len(probs) + 1)
        z = np.exp(lam / k * probs)
        return str(rng.choice(keys, p=z / z.sum()))
    raise NotImplementedError(f"Unknown selfplay algorithm {algo!r}")


def elo_update(ego_elo: float, opponent_elo: np.ndarray,
               ego_rewards: np.ndarray, opponent_rewards: np.ndarray,
               k_factor: float = 32.0, tie_band: float = 100.0
               ) -> Tuple[float, np.ndarray]:
    """ELO exchange vs a set of opponents (selfplay_F16sim_runner.py:218-234).

    Returns (new_ego_elo, new_opponent_elos). Reward diff > tie_band -> the
    opponent won; |diff| < tie_band -> tie.

    Fixed reference defect: the reference pairs ego's EXPECTED score with
    the OPPONENT's actual score (`elo_gain = 32*(actual_opp -
    expected_ego)`, ego -= gain, `selfplay_F16sim_runner.py:229-233`),
    which overpays expected wins by ~K and near-ignores upsets, inflating
    ratings instead of converging. Standard ELO: each side's update uses
    its OWN expected and actual scores; the exchange is zero-sum.
    """
    opponent_elo = np.asarray(opponent_elo, dtype=np.float64)
    expected_ego = 1.0 / (1.0 + 10.0 ** ((opponent_elo - ego_elo) / 400.0))
    diff = np.asarray(opponent_rewards) - np.asarray(ego_rewards)
    # ego's actual score: opponent-won -> 0, tie -> 0.5, ego-won -> 1
    s_ego = np.where(diff > tie_band, 0.0,
                     np.where(np.abs(diff) < tie_band, 0.5, 1.0))
    gain = k_factor * (s_ego - expected_ego)
    return float((ego_elo + gain).mean()), opponent_elo - gain


def elo_update_scored(ego_elo: float, opponent_elo: np.ndarray,
                      s_ego: np.ndarray, k_factor: float = 32.0
                      ) -> Tuple[float, np.ndarray]:
    """ELO exchange from a FRACTIONAL actual score per opponent slice.

    Beyond the reference protocol: team-game eval scores
    s = (wins + ties/2) / episodes from decisive team-wipe events (see
    RLConfig.eval_event_scoring) - standard ELO accepts fractional
    actual scores directly, so a surplus of wipes moves the rating even
    when most episodes are indecisive. Zero-sum, same K as elo_update.
    """
    opponent_elo = np.asarray(opponent_elo, dtype=np.float64)
    expected_ego = 1.0 / (1.0 + 10.0 ** ((opponent_elo - ego_elo) / 400.0))
    gain = k_factor * (np.asarray(s_ego, dtype=np.float64) - expected_ego)
    return float((ego_elo + gain).mean()), opponent_elo - gain
