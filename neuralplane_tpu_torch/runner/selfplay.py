"""Self-play combat runner: opponent pool, ELO, rollouts on the device
(counterpart of neuralplane_tpu/runner/selfplay.py).

Each env group holds M agents: the first M/2 are the trainee ("ego") team,
the last M/2 are flown by frozen opponent actors from a checkpoint pool.
The env batch splits into K pool slices of whole env groups, one frozen
actor each (the JAX package's vmap over K stacked parameter sets is a loop
over the K slices; the repo's runs use K = 1); the frozen actors are of the
policy's own kind (`PPOPolicy.init_actor_params`), so they fly any action
space. Nothing in the rollout loop reads a value back to the host; the RNN
states are recorded once per recurrent chunk, as in `runner/f16sim.py`. The
missile envs' `shoot/launches`, `shoot/hits` and `shoot/pk_sum` are summed
over the collect on the device as `shoot_*` counters, and logged with each
record.

The pool is `checkpoints/actor_<name>.pt` (the port's own format, a
torch.save of the actor's state_dict); a resumed run also imports a JAX
run's `actor_<name>.pkl` entries, read without JAX. The pool's ratings and
the ego's ELO ride in the runner's checkpoint (`_extra_state`), so PFSP's
weighting and the ladder survive a restart.

Over a mesh (JAX :82-90, :475-477) the env is this rank's share of the
global batch, and the K pool slices are cut from each rank's share: its
local num_envs must divide by K. `self.rng`, which draws the opponents, is
seeded with cfg.seed on every rank, so all ranks draw the same names.
Rank 0 writes the pool files, and a barrier follows before any rank reads
them, so all ranks must see the run directory's filesystem. The ELO eval all-reduces its per-slice sums (rewards, episode ends,
wins, losses) before the update, so every rank holds the same `latest_elo`
and pool ratings; `steps_per_episode` is global, and the logged reward
sums and `shoot_*` counters are summed over the ranks before dividing.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..algorithms.networks import params_from_jax
from ..algorithms.ppo.buffer import RolloutBatch
from ..algorithms.rl_config import RLConfig
from ..algorithms.selfplay import choose_opponent, elo_update, elo_update_scored
from ..parallel.mesh import Mesh, all_reduce_sum, barrier
from ..utils.checkpoint import load_checkpoint, load_jax_pickle, save_checkpoint
from .base import Runner


def team_split(env, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat [n, ...] -> (ego [n/2, ...], opp [n/2, ...]) team halves of any
    combat env (the first half of each group is the ego team)."""
    ne, m = env.num_envs, env.num_agents
    h = m // 2
    g = x.reshape(ne, m, *x.shape[1:])
    return (g[:, :h].reshape(ne * h, *x.shape[1:]),
            g[:, h:].reshape(ne * h, *x.shape[1:]))


def team_merge(env, ego: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`team_split`."""
    ne, m = env.num_envs, env.num_agents
    h = m // 2
    e = ego.reshape(ne, h, *ego.shape[1:])
    o = opp.reshape(ne, h, *opp.shape[1:])
    return torch.cat([e, o], dim=1).reshape(ne * m, *ego.shape[1:])


def pool_slices(x: torch.Tensor, k: int) -> torch.Tensor:
    """[n_ego, ...] -> [k, n_ego/k, ...] opponent-pool slices."""
    return x.reshape(k, x.shape[0] // k, *x.shape[1:])


@dataclasses.dataclass
class SelfplayCarry:
    env_state: object
    ego_obs: torch.Tensor       # [n_ego, obs]
    opp_obs: torch.Tensor       # [n_opp, obs]
    h_actor: torch.Tensor       # ego actor hidden [n_ego, L, H]
    h_critic: torch.Tensor
    h_opp: torch.Tensor         # opponent actor hidden [n_opp, L, H]
    ego_masks: torch.Tensor     # [n_ego, 1]
    opp_masks: torch.Tensor     # [n_opp, 1]
    bad_masks: torch.Tensor     # [n_ego, 1]
    # per-agent liveness at the upcoming obs (MAPPO's active masks); None
    # for the PPO self-play runner
    active_masks: Optional[torch.Tensor] = None


# the missile envs' per-step counts, folded into the collect's counters
SHOOT_KEYS = ("shoot/launches", "shoot/hits", "shoot/pk_sum")


def _env_any(env, x: torch.Tensor) -> torch.Tensor:
    """Per-env any over all agents [num_envs]."""
    return x.reshape(env.num_envs, env.num_agents).any(dim=1)


def _per_ego(env, per_env: torch.Tensor) -> torch.Tensor:
    """[num_envs] -> [num_envs * M/2, 1], one row per ego agent."""
    return per_env[:, None].expand(-1, env.num_agents // 2).reshape(-1, 1)


class SelfplayRunner(Runner):
    """PPO and a frozen-opponent pool on the combat envs."""

    def __init__(self, env, cfg: RLConfig, run_dir: str = "runs/selfplay",
                 eval_env=None, model_dir: Optional[str] = None,
                 use_tensorboard: bool = False, mesh: Optional[Mesh] = None):
        super().__init__(env, cfg, run_dir, eval_env, model_dir, use_tensorboard,
                         mesh=mesh)
        self.num_envs = env.num_envs
        self.num_agents = env.num_agents
        self.half = self.num_agents // 2
        self.n_ego = env.num_envs * self.half
        self.num_opponents = max(1, cfg.n_choose_opponents)
        if env.num_envs % self.num_opponents:
            raise ValueError(f"num_envs={env.num_envs} (this rank's share) must divide "
                             f"evenly into {self.num_opponents} opponent slices")
        # the same on every rank: the ranks draw the same opponents
        self.rng = np.random.default_rng(cfg.seed)
        # one frozen actor per pool slice, loaded from the pool
        self.opponents: List[torch.nn.Module] = [
            self.policy.init_actor_params(torch.Generator().manual_seed(0))
            .to(self.device).requires_grad_(False) for _ in range(self.num_opponents)]
        restored = self._restored_extras.get("selfplay", {})
        self.latest_elo = float(restored.get("latest_elo", cfg.init_elo))
        self._restored_ratings: Dict[str, float] = {
            k: float(v) for k, v in restored.get("policy_pool", {}).items()}
        self.policy_pool: Dict[str, float] = {}
        if model_dir is not None:
            self._import_pool(os.path.dirname(os.path.abspath(model_dir)))
        if not self.policy_pool:
            self._save_pool_entry("0")   # a fresh run: the initial policy
        newest = max(self.policy_pool, key=lambda n: int(n) if n.isdigit() else -1)
        self._stack_opponents([newest] * self.num_opponents)

    # ---- persistence (pool ratings and the ego's ELO ride in the checkpoint) ----
    def _extra_state(self) -> Dict:
        return {"selfplay": {"latest_elo": float(self.latest_elo),
                             "policy_pool": {k: float(v) for k, v in self.policy_pool.items()}}}

    # ---- pool ----
    def _pool_path(self, name: str) -> str:
        return os.path.join(self.save_dir, f"actor_{name}.pt")

    def _import_pool(self, src_dir: str) -> None:
        """A previous run's pool into this run's: the port's actor_*.pt
        copied, a JAX run's actor_*.pkl converted."""
        if not os.path.isdir(src_dir):
            return
        for fname in sorted(os.listdir(src_dir)):
            stem, ext = os.path.splitext(fname)
            if not (stem.startswith("actor_") and ext in (".pt", ".pkl")):
                continue
            name, src = stem[len("actor_"):], os.path.join(src_dir, fname)
            dst = self._pool_path(name)
            if self.rank == 0:   # one writer; the barrier below
                if ext == ".pkl":
                    save_checkpoint(dst, params_from_jax(load_jax_pickle(src)))
                elif os.path.abspath(src) != os.path.abspath(dst):
                    shutil.copy(src, dst)
            # the checkpoint's rating where it has one, else the current one
            self.policy_pool[name] = self._restored_ratings.get(name, self.latest_elo)
        barrier(self.mesh)
        if self.policy_pool:
            logging.info("Imported %d pool entries from %s", len(self.policy_pool), src_dir)

    def _next_pool_name(self) -> str:
        nums = [int(n) for n in self.policy_pool if n.isdigit()]
        return str(max(nums) + 1 if nums else 0)

    def _save_pool_entry(self, name: str) -> None:
        if self.rank == 0:
            save_checkpoint(self._pool_path(name), {k: v.detach().cpu() for k, v in
                                                    self.policy.actor.state_dict().items()})
        barrier(self.mesh)
        self.policy_pool[name] = self.latest_elo

    def _stack_opponents(self, names) -> List[torch.nn.Module]:
        """Load the named pool entries into the K frozen actors."""
        for actor, name in zip(self.opponents, names):
            actor.load_state_dict(load_checkpoint(self._pool_path(name)))
        return self.opponents

    def reset_opponent(self) -> list:
        """Re-sample the opponents per SP / FSP / PFSP."""
        names = [choose_opponent(self.cfg.selfplay_algorithm, self.policy_pool, self.rng)
                 for _ in range(self.num_opponents)]
        self._stack_opponents(names)
        logging.info("Choose opponents %s for training", names)
        return names

    def _opponents_act(self, obs, h, masks, deterministic: bool):
        """The K frozen actors, each on its pool slice of the opponent rows."""
        k = self.num_opponents
        acts, hs = [], []
        for actor, o, hh, m in zip(self.opponents, pool_slices(obs, k), pool_slices(h, k),
                                   pool_slices(masks, k)):
            dist, hh = actor.dist_step(o, hh, m)
            acts.append(dist.mode() if deterministic else dist.sample(self.generator))
            hs.append(hh)
        return torch.cat(acts), torch.cat(hs)

    # ---- rollout ----
    def init_carry(self, seed: int) -> SelfplayCarry:
        env_state, obs = self.env.reset(seed)
        ego_obs, opp_obs = team_split(self.env, obs)
        h_a, h_c = self.policy.init_rnn_states(self.n_ego)
        ones = torch.ones((self.n_ego, 1), dtype=torch.float32, device=self.device)
        return SelfplayCarry(env_state=env_state, ego_obs=ego_obs, opp_obs=opp_obs,
                             h_actor=h_a, h_critic=h_c, h_opp=torch.zeros_like(h_a),
                             ego_masks=ones, opp_masks=ones, bad_masks=ones)

    def _ego_actions(self, carry: SelfplayCarry):
        """The trainee's rollout forward: (values, actions, logp, h_actor,
        h_critic, extra step data); MAPPO adds the centralized obs."""
        return self.policy.get_actions(carry.ego_obs, carry.h_actor, carry.h_critic,
                                       carry.ego_masks, self.generator) + ({},)

    def _next_active(self, carry: SelfplayCarry, out, reset_env) -> Optional[torch.Tensor]:
        """The next carry's active masks (None: the PPO runner keeps none)."""
        return None

    def _collect_step(self, carry: SelfplayCarry):
        env = self.env
        values, actions, logp, h_a, h_c, extra = self._ego_actions(carry)
        opp_actions, h_opp = self._opponents_act(carry.opp_obs, carry.h_opp,
                                                 carry.opp_masks, deterministic=False)
        env_state, out = env.step(carry.env_state, team_merge(env, actions, opp_actions))

        # per-env flag reductions over all agents
        dones_env = _per_ego(env, _env_any(env, out.done))
        bad_env = _per_ego(env, _env_any(env, out.bad_done))
        reset_env = _per_ego(env, _env_any(env, out.done | out.bad_done
                                           | out.exceed_time_limit))
        next_masks = 1.0 - dones_env.float()
        keep = (1.0 - reset_env.float())[:, :, None]
        ego_obs, opp_obs = team_split(env, out.obs)
        step_data = dict(obs=carry.ego_obs, actions=actions,
                         rewards=team_split(env, out.reward[:, None])[0],
                         masks=carry.ego_masks, bad_masks=carry.bad_masks,
                         action_log_probs=logp, value_preds=values,
                         done_count=out.done.sum() + out.bad_done.sum(), **extra)
        # the missile envs' counts ride along as 0-d counters
        step_data.update({k.replace("/", "_"): out.info[k] for k in SHOOT_KEYS
                          if k in out.info})
        new_carry = SelfplayCarry(
            env_state=env_state, ego_obs=ego_obs, opp_obs=opp_obs, h_actor=h_a * keep,
            h_critic=h_c * keep, h_opp=h_opp * keep, ego_masks=next_masks,
            opp_masks=next_masks, bad_masks=1.0 - bad_env.float(),
            active_masks=self._next_active(carry, out, reset_env))
        return new_carry, step_data

    # the step data with a row after the last step ([T + 1] buffers)
    _LAST_ROW = ("obs", "masks", "bad_masks", "value_preds")

    @torch.no_grad()
    def collect(self, carry: SelfplayCarry
                ) -> Tuple[SelfplayCarry, RolloutBatch, Dict[str, torch.Tensor]]:
        """Roll buffer_size steps; returns (carry, batch, counters), the
        counters (done_count, and shoot_* on the missile envs) 0-d device
        tensors summed over the steps. Two nested loops over the T/L
        recurrent chunks and their L steps: the batch's rnn_states_* are
        the chunk-start states, [T/L, n_ego, layers, H]."""
        T, L = self.cfg.buffer_size, self.cfg.data_chunk_length
        if T % L != 0:
            raise ValueError(f"buffer_size {T} % data_chunk_length {L} != 0")
        dev = self.device
        h0_a = torch.empty((T // L, *carry.h_actor.shape), device=dev)
        h0_c = torch.empty((T // L, *carry.h_critic.shape), device=dev)
        steps: Dict[str, torch.Tensor] = {}
        counters: Dict[str, torch.Tensor] = {}
        for c in range(T // L):
            h0_a[c], h0_c[c] = carry.h_actor, carry.h_critic
            for t in range(c * L, (c + 1) * L):
                carry, d = self._collect_step(carry)
                for k, v in d.items():
                    if v.dim() == 0:
                        counters[k] = counters[k] + v if k in counters else v.clone()
                        continue
                    if k not in steps:   # one float32 buffer per row of step data
                        rows = T + 1 if k in self._LAST_ROW else T
                        steps[k] = torch.empty((rows, *v.shape), device=dev)
                    steps[k][t] = v
        for k, v in self._last_rows(carry).items():
            steps[k][T] = v
        return carry, self._batch(steps, h0_a, h0_c), counters

    def _last_rows(self, carry: SelfplayCarry) -> Dict[str, torch.Tensor]:
        """The rows after the last step: the carry's obs and masks, and the
        bootstrap value V(obs)."""
        return {"obs": carry.ego_obs, "masks": carry.ego_masks, "bad_masks": carry.bad_masks,
                "value_preds": self.policy.get_values(carry.ego_obs, carry.h_critic,
                                                      carry.ego_masks)}

    def _batch(self, steps: Dict[str, torch.Tensor], h0_a, h0_c) -> RolloutBatch:
        return RolloutBatch(**steps, rnn_states_actor=h0_a, rnn_states_critic=h0_c)

    # ---- evaluation against the pool, and ELO ----
    @torch.no_grad()
    def eval_elo(self, num_steps: Optional[int] = None) -> Dict[str, float]:
        """ELO matches on the eval env (else the training env) against K
        opponents drawn from the pool: deterministic play on both sides
        unless `eval_stochastic`; scored by the banded per-episode mean
        reward, or with `eval_event_scoring` by team-wipe events
        (StepOutput.active). Then the training opponents are re-drawn."""
        env = self.eval_env if self.eval_env is not None else self.env
        steps = num_steps or env.config.max_steps
        half = env.num_agents // 2
        n_ego = env.num_envs * half
        K = self.num_opponents
        # whole env groups map to one opponent each
        assert env.num_envs % K == 0, (
            f"eval num_envs={env.num_envs} must divide into {K} opponent slices")
        names = [choose_opponent(self.cfg.selfplay_algorithm, self.policy_pool, self.rng)
                 for _ in range(K)]
        self._stack_opponents(names)
        det = not self.cfg.eval_stochastic
        events = self.cfg.eval_event_scoring

        state, obs = env.reset(self.next_seed())
        ego_obs, opp_obs = team_split(env, obs)
        h_a, _ = self.policy.init_rnn_states(n_ego)
        h_opp = torch.zeros_like(h_a)
        masks = torch.ones((n_ego, 1), dtype=torch.float32, device=self.device)
        zero = torch.zeros((n_ego, 1), dtype=torch.float32, device=self.device)
        cum_ego, cum_opp, sum_ego, sum_opp, ends = (zero.clone() for _ in range(5))
        zero_env = torch.zeros(env.num_envs, dtype=torch.float32, device=self.device)
        eps_pe, wins_pe, losses_pe = (zero_env.clone() for _ in range(3))
        for _ in range(steps):
            a_ego, h_a = self.policy.act(ego_obs, h_a, masks, self.generator,
                                         deterministic=det)
            a_opp, h_opp = self._opponents_act(opp_obs, h_opp, masks, det)
            state, out = env.step(state, team_merge(env, a_ego, a_opp))
            reset_pe = _env_any(env, out.done | out.bad_done | out.exceed_time_limit)
            reset = _per_ego(env, reset_pe).float()
            masks = 1.0 - _per_ego(env, _env_any(env, out.done)).float()
            ego_obs, opp_obs = team_split(env, out.obs)
            ego_rew, opp_rew = team_split(env, out.reward[:, None])
            # per-episode cumulative rewards, emitted when the group resets
            cum_ego, cum_opp = cum_ego + ego_rew, cum_opp + opp_rew
            sum_ego += cum_ego * reset
            sum_opp += cum_opp * reset
            ends += reset
            if events:
                if out.active is None:
                    raise ValueError("eval_event_scoring needs a team env exposing "
                                     "StepOutput.active (wipe events)")
                act_g = out.active.reshape(env.num_envs, env.num_agents)
                own_alive = act_g[:, :half].sum(dim=1) > 0
                enm_alive = act_g[:, half:].sum(dim=1) > 0
                r_pe = reset_pe.float()
                eps_pe += r_pe
                wins_pe += r_pe * (own_alive & ~enm_alive)
                losses_pe += r_pe * (~own_alive & enm_alive)
            cum_ego, cum_opp = cum_ego * (1.0 - reset), cum_opp * (1.0 - reset)
            keep = (1.0 - reset)[:, :, None]
            h_a, h_opp = h_a * keep, h_opp * keep

        # average episode reward per pool slice over completed episodes; the
        # per-slice sums over every rank's slice k
        sums = torch.stack([pool_slices(sum_ego, K).sum(dim=(1, 2)),
                            pool_slices(sum_opp, K).sum(dim=(1, 2)),
                            pool_slices(ends, K).sum(dim=(1, 2)),
                            eps_pe.reshape(K, -1).sum(1), wins_pe.reshape(K, -1).sum(1),
                            losses_pe.reshape(K, -1).sum(1)])
        all_reduce_sum([sums], self.mesh)
        slice_ends = sums[2]
        denom = slice_ends.clamp_min(1.0)
        per_slice = torch.stack([sums[0] / denom, sums[1] / denom, *sums[3:]]
                                ).double().cpu().numpy()
        ego_rew, opp_rew, eps_s, wins_s, losses_s = per_slice
        ended = float(slice_ends.sum()) / half
        opp_elo = np.array([self.policy_pool[n] for n in names])
        info = {}
        if events:
            ties_s = eps_s - wins_s - losses_s
            s_ego = np.where(eps_s > 0, (wins_s + 0.5 * ties_s) / np.maximum(eps_s, 1), 0.5)
            self.latest_elo, new_opp = elo_update_scored(self.latest_elo, opp_elo, s_ego)
            info.update(eval_wins=float(wins_s.sum()), eval_losses=float(losses_s.sum()))
        else:
            self.latest_elo, new_opp = elo_update(self.latest_elo, opp_elo, ego_rew, opp_rew,
                                                  tie_band=self.cfg.elo_tie_band)
        for n, e in zip(names, new_opp):
            self.policy_pool[n] = float(e)
        self.reset_opponent()
        return {"latest_elo": self.latest_elo, "eval_episodes_ended": ended, **info}

    # ---- main loop ----
    def run(self) -> Dict[str, float]:
        cfg = self.cfg
        carry = self.init_carry(self.next_seed())
        steps_per_episode = cfg.buffer_size * self.n_ego * self.world
        episodes = max(1, int(cfg.num_env_steps) // steps_per_episode)
        start = time.time()
        train_infos: Dict[str, float] = {}
        for episode in range(episodes):
            carry, batch, counters = self.collect(carry)
            train_infos = self.train(batch)
            total = (episode + 1) * steps_per_episode
            if episode % cfg.log_interval == 0:
                # reward sums, episode ends and shoot_* counters over the ranks
                ends = (batch.masks[1:] == 0).sum() + (batch.bad_masks[1:] == 0).sum()
                shoot = [k for k in counters if k.startswith("shoot_")]
                sums = torch.stack([batch.rewards.sum(), ends.float()]
                                   + [counters[k].float() for k in shoot])
                all_reduce_sum([sums], self.mesh)
                train_infos["average_episode_rewards"] = float(
                    sums[0] / sums[1].clamp_min(1))
                train_infos["fps"] = int(total / (time.time() - start))
                train_infos["latest_elo"] = self.latest_elo
                for k, v in zip(shoot, sums[2:].tolist()):
                    train_infos[k] = round(v, 3)
                self.log_info(train_infos, total)
            if cfg.use_eval and episode % cfg.eval_interval == 0 and episode:
                self.log_info(self.eval_elo(), total)
            if episode % cfg.save_interval == 0 or episode == episodes - 1:
                self.save("latest")
                # monotone pool names: a resumed run numbers on after its pool
                self._save_pool_entry(self._next_pool_name())
                # the episode's own copy, after its pool entry: a tool that
                # waits for it (tools/train_legs.py) finds the pool complete
                self.save(f"ep{episode}")
                # re-draw the training opponents from the grown pool
                self.reset_opponent()
        return train_infos
