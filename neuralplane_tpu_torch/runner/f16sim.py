"""F16Sim runner: rollout collection on the device and the PPO update
(counterpart of neuralplane_tpu/runner/f16sim.py:42-238).

The JAX package collects in one `lax.scan`; here a host loop over the
buffer's steps runs the policy's act, one env step (on the fused path one
`env_step` kernel) and the step's bookkeeping, and writes into
preallocated device tensors. Nothing in the loop reads a value back to the
host: the done, bad and `termination/*` counts stay tensors until `run`
logs them, once per episode.

The act and the bookkeeping read and write `StepTensors`, whose storage
stays from step to step. On a CUDA device each is captured into a CUDA
graph after WARMUP_STEPS eager steps on a side stream, and replayed once a
step from then on: two launches for ~110 eager ones. The env step stays an
eager call, once a step, with its own generator; its outputs are copied
into the step tensors. The act's draws come from the runner's generator,
registered with its graph, so a replay draws what the eager act would and
leaves the generator where the eager act would. A change of shapes, device,
generator or any parameter's storage captures again; elsewhere than on a
CUDA device the same step runs eagerly.

Mask construction (F16sim_runner.insert:138-154, f16sim.py:80-114):
  dones_env      = any-over-agents done      -> masks[t+1] = 0 (whole env)
  bad_dones_env  = any-over-agents bad_done  -> bad_masks[t+1] = 0
  reset_env      = any-over-agents any flag  -> rnn states zeroed
(`exceed_time_limit` is all zero on the fused path, as in the JAX package.)

Over a mesh (JAX :53-68) the env is this rank's share, `n` rows of the
global `n * world` (scripts/train.py:make_env splits the global count and
checks that it divides, as the JAX assert at :59-60 does): episode counts
and `total_num_steps` are global, and the logged reward sums, episode ends
and `termination/*` counts are summed over the ranks in one all-reduce
before `log_info`, as are the eval's. Each rank captures its own graphs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..algorithms.ppo.buffer import RolloutBatch
from ..algorithms.rl_config import RLConfig
from ..parallel.mesh import Mesh, all_reduce_sum
from ..utils.profiling import span
from .base import Runner


@dataclasses.dataclass
class RolloutCarry:
    env_state: object
    obs: torch.Tensor        # [n, obs_dim]
    h_actor: torch.Tensor    # [n, layers, H]
    h_critic: torch.Tensor   # [n, layers, H]
    masks: torch.Tensor      # [n, 1]
    bad_masks: torch.Tensor  # [n, 1]


# eager collect steps on the capture's side stream before a CUDA capture
WARMUP_STEPS = 3


@dataclasses.dataclass
class StepTensors:
    """The tensors one collect step reads and writes, whose storage stays
    from step to step so that a CUDA graph can replay the step: the act's
    inputs (the carry's obs, recurrent states and masks, and its bad masks),
    the env's outputs copied in (`env_out`: done, bad and exceed flags, then
    the info counts named `info_keys`; obs goes into `obs`), the running
    counts (done, bad, then the info counts) and, once captured, the graphs
    (act, bookkeeping) with the act graph's outputs. `key` is what the
    graphs bake in; `warm` counts the eager steps, `captures` the captures."""
    key: tuple
    obs: torch.Tensor
    h_actor: torch.Tensor
    h_critic: torch.Tensor
    masks: torch.Tensor
    bad_masks: torch.Tensor
    stream: Optional["torch.cuda.Stream"] = None
    env_out: Optional[List[torch.Tensor]] = None
    info_keys: tuple = ()
    counts: List[torch.Tensor] = dataclasses.field(default_factory=list)
    graphs: Optional[tuple] = None
    act_out: Optional[tuple] = None
    warm: int = 0
    captures: int = 0

    @property
    def act_in(self) -> List[torch.Tensor]:
        return [self.obs, self.h_actor, self.h_critic, self.masks]

    def drop_graphs(self) -> None:
        self.graphs = self.act_out = None
        self.warm = 0

    @contextlib.contextmanager
    def on_side_stream(self):
        """Run the block on the side stream (ordered after the current
        stream's work, and before its next), where there is one."""
        if self.stream is None:
            yield
            return
        main = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            yield
        main.wait_stream(self.stream)


class F16SimRunner(Runner):
    """PPO on the single-agent control envs (heading / control / tracking)
    and the planning env. The env's device is the runner's; `mesh` makes
    the runner one rank of a data-parallel run."""

    def __init__(self, env, cfg: RLConfig, run_dir: str = "runs/debug",
                 eval_env=None, model_dir: Optional[str] = None,
                 use_tensorboard: bool = False, mesh: Optional[Mesh] = None):
        super().__init__(env, cfg, run_dir, eval_env, model_dir, use_tensorboard,
                         mesh=mesh)
        self.num_envs = env.num_envs
        self.num_agents = env.num_agents
        self.n = env.n
        self._step: Optional[StepTensors] = None

    # ---- rollout ----
    def init_carry(self, seed: int) -> RolloutCarry:
        env_state, obs = self.env.reset(seed)
        h_a, h_c = self.policy.init_rnn_states(self.n)
        ones = torch.ones((self.n, 1), dtype=torch.float32, device=self.device)
        return RolloutCarry(env_state=env_state, obs=obs, h_actor=h_a, h_critic=h_c,
                            masks=ones, bad_masks=ones.clone())

    def _env_flags(self, done, bad, exceed) -> Tuple[torch.Tensor, torch.Tensor,
                                                     torch.Tensor]:
        """Per-env any-over-agents reductions, broadcast back to [n, 1]."""
        def env_any(x):
            per_env = x.reshape(self.num_envs, self.num_agents).any(dim=1)
            return per_env[:, None].expand(-1, self.num_agents).reshape(-1, 1)
        return env_any(done), env_any(bad), env_any(done | bad | exceed)

    # ---- one collect step's device work, around the eager env step ----
    def _step_tensors(self, carry: RolloutCarry) -> StepTensors:
        """The step tensors for a collect from `carry`: kept while the
        shapes, the device, the generator and every parameter's storage
        stay (in-place updates keep the storage; `policy.to` does not),
        else made anew, which drops the graphs; the carry is copied in and
        the counts zeroed."""
        params = itertools.chain(self.policy.parameters(), self.policy.buffers())
        key = (carry.obs.shape, carry.h_actor.shape, carry.h_critic.shape, carry.obs.device,
               id(self.generator), tuple(p.data_ptr() for p in params))
        ins = [carry.obs, carry.h_actor, carry.h_critic, carry.masks, carry.bad_masks]
        st = self._step
        if st is None or st.key != key:
            cuda = carry.obs.device.type == "cuda"
            st = self._step = StepTensors(
                key, *(x.clone(memory_format=torch.contiguous_format) for x in ins),
                stream=torch.cuda.Stream(carry.obs.device) if cuda else None)
        else:
            torch._foreach_copy_(st.act_in + [st.bad_masks], ins)
            if st.counts:
                torch._foreach_zero_(st.counts)
        return st

    def _act(self, st: StepTensors):
        """(values, actions, log-probs, h_actor, h_critic): the act graph's
        replay, else `PPOPolicy.get_actions` run eagerly (on the capture's
        side stream while a CUDA step warms up)."""
        if st.graphs is not None:
            with span("policy.act"), span("policy.act.replay"):
                st.graphs[0].replay()
            return st.act_out
        with st.on_side_stream():
            return self.policy.get_actions(*st.act_in, self.generator)

    def _load_env_out(self, st: StepTensors, out, first: bool) -> None:
        """Copy the env's outputs (new tensors every step) into the step
        tensors: obs, the done, bad and exceed flags, then the info counts.
        At a collect's first step a change of their names, shapes or dtypes
        makes the slots and counts anew and drops the graphs."""
        info = out.info or {}
        srcs = [out.obs, out.done, out.bad_done, out.exceed_time_limit, *info.values()]
        if first and (st.info_keys != tuple(info) or st.env_out is None or any(
                a.shape != b.shape or a.dtype != b.dtype for a, b in zip(st.env_out, srcs[1:]))):
            st.env_out = [torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in srcs[1:]]
            st.info_keys = tuple(info)
            total = torch.zeros((), dtype=torch.int64, device=out.done.device)
            st.counts = [total, total.clone(), *(torch.zeros_like(v) for v in info.values())]
            st.drop_graphs()
        torch._foreach_copy_([st.obs] + st.env_out, srcs)

    def _bookkeep(self, st: StepTensors, h_actor, h_critic) -> None:
        """The step's bookkeeping after the env step: the per-env flags, the
        recurrent states zeroed after any flag, the next masks (written in
        place as the next act's inputs) and the done, bad and info counts
        added up."""
        done, bad, exceed, *info = st.env_out
        dones_env, bad_env, reset_env = self._env_flags(done, bad, exceed)
        keep = (1.0 - reset_env.float())[:, :, None]
        torch.mul(h_actor, keep, out=st.h_actor)
        torch.mul(h_critic, keep, out=st.h_critic)
        st.masks.copy_(1.0 - dones_env.float())
        st.bad_masks.copy_(1.0 - bad_env.float())
        torch._foreach_add_(st.counts, [done.sum(), bad.sum(), *info])

    def _after_env(self, st: StepTensors, act) -> None:
        """The bookkeeping graph's replay, else `_bookkeep` run eagerly; a
        CUDA step captures both graphs after WARMUP_STEPS eager steps."""
        if st.graphs is not None:
            st.graphs[1].replay()
            return
        with st.on_side_stream():
            self._bookkeep(st, act[3], act[4])
        if st.stream is not None:
            st.warm += 1
            if st.warm >= WARMUP_STEPS:
                self._capture(st)

    def _capture(self, st: StepTensors) -> None:
        """Capture the act and the bookkeeping into two CUDA graphs sharing
        one memory pool, on the side stream the eager steps warmed up. The
        act's draws come from the runner's generator, registered with its
        graph, so that each replay draws what the eager act would and moves
        the generator on as far."""
        act, book = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        act.register_generator_state(self.generator)
        with torch.cuda.graph(act, stream=st.stream, capture_error_mode="thread_local"):
            out = self.policy.sample_actions(*st.act_in, self.generator)
        with torch.cuda.graph(book, pool=act.pool(), stream=st.stream,
                              capture_error_mode="thread_local"):
            self._bookkeep(st, out[3], out[4])
        st.act_out, st.graphs = out, (act, book)
        st.captures += 1

    def collect(self, carry: RolloutCarry
                ) -> Tuple[RolloutCarry, RolloutBatch, Tuple[torch.Tensor, Dict]]:
        """Roll buffer_size steps; returns (carry, batch, (episodes_finished,
        counters)), counts as device tensors, every tensor new.

        Two nested loops, over the T/L recurrent chunks and the L steps of a
        chunk: the rnn states are recorded once per chunk (the input state
        of the chunk's first step, all the update reads), so the batch's
        rnn_states_* are [T/L, n, layers, H]."""
        with span("runner.collect"), torch.no_grad():
            T, L = self.cfg.buffer_size, self.cfg.data_chunk_length
            if T % L != 0:
                raise ValueError(f"buffer_size {T} % data_chunk_length {L} != 0")
            n, dev = self.n, self.device

            def buf(rows, *shape):
                return torch.empty((rows, n, *shape), dtype=torch.float32, device=dev)
            obs = buf(T + 1, carry.obs.shape[1])
            actions = buf(T, self.policy.spec.act_dim)
            rewards, logp = buf(T, 1), buf(T, 1)
            masks, bad_masks, values = buf(T + 1, 1), buf(T + 1, 1), buf(T + 1, 1)
            h0_a = buf(T // L, *carry.h_actor.shape[1:])
            h0_c = buf(T // L, *carry.h_critic.shape[1:])

            st = self._step_tensors(carry)
            env_state = carry.env_state
            torch._foreach_copy_([obs[0], masks[0], bad_masks[0]],
                                 [st.obs, st.masks, st.bad_masks])
            for c in range(T // L):
                torch._foreach_copy_([h0_a[c], h0_c[c]], [st.h_actor, st.h_critic])
                for t in range(c * L, (c + 1) * L):
                    act = self._act(st)
                    torch._foreach_copy_([values[t], actions[t], logp[t]], list(act[:3]))
                    # the env gets the batch's row: the act graph's output
                    # is written again by the next replay
                    env_state, out = self.env.step(env_state, actions[t])
                    self._load_env_out(st, out, first=t == 0)
                    self._after_env(st, act)
                    torch._foreach_copy_(
                        [obs[t + 1], masks[t + 1], bad_masks[t + 1], rewards[t]],
                        [st.obs, st.masks, st.bad_masks, out.reward[:, None]])
            values[T] = self.policy.get_values(st.obs, st.h_critic, st.masks)
            batch = RolloutBatch(obs=obs, actions=actions, rewards=rewards, masks=masks,
                                 bad_masks=bad_masks, action_log_probs=logp,
                                 value_preds=values, rnn_states_actor=h0_a,
                                 rnn_states_critic=h0_c)
            done_total, bad_total, *info = (x.clone() for x in st.counts)
            counters: Dict[str, torch.Tensor] = dict(zip(st.info_keys, info))
            counters["episodes_reached_target"] = done_total
            counters["episodes_failed"] = bad_total
            carry = RolloutCarry(env_state, *(x.clone() for x in st.act_in + [st.bad_masks]))
            return carry, batch, (done_total + bad_total, counters)

    # ---- main loop ----
    def run(self) -> Dict[str, float]:
        cfg = self.cfg
        carry = self.init_carry(self.next_seed())
        total_steps_per_episode = cfg.buffer_size * self.n * self.world
        episodes = max(1, int(cfg.num_env_steps) // total_steps_per_episode)
        start = time.time()
        train_infos: Dict[str, float] = {}

        for episode in range(episodes):
            carry, batch, (_, counters) = self.collect(carry)
            train_infos = self.train(batch)
            total_num_steps = (episode + 1) * total_steps_per_episode

            if episode % cfg.log_interval == 0:
                # avg episode reward = sum(rewards) / #episode-ends
                # (F16sim_runner.py:98-99), both summed over the ranks
                ends = ((batch.masks[1:] == 0).sum()
                        + (batch.bad_masks[1:] == 0).sum())
                sums = torch.stack([batch.rewards.sum(), ends.float()]
                                   + [v.float() for v in counters.values()])
                all_reduce_sum([sums], self.mesh)
                avg_rew = sums[0] / sums[1].clamp_min(1)
                names = ["average_episode_rewards", *counters]
                train_infos.update(zip(names, torch.cat([avg_rew[None], sums[2:]]).tolist()))
                fps = int(total_num_steps / (time.time() - start))
                logging.info(
                    "episode %d/%d steps %d FPS %d avg_episode_reward %.3f",
                    episode, episodes, total_num_steps, fps,
                    train_infos["average_episode_rewards"])
                train_infos["fps"] = fps
                self.log_info(train_infos, total_num_steps)

            if cfg.use_eval and episode % cfg.eval_interval == 0 and episode:
                self.log_info(self.eval(), total_num_steps)

            if episode % cfg.save_interval == 0 or episode == episodes - 1:
                self.save("latest")
                self.save(f"ep{episode}")
        return train_infos

    # ---- evaluation (deterministic rollout; F16sim_runner.py:156-193) ----
    @torch.no_grad()
    def eval(self, num_steps: Optional[int] = None) -> Dict[str, float]:
        env = self.eval_env if self.eval_env is not None else self.env
        steps = num_steps or self.env.config.max_steps
        state, obs = env.reset(self.next_seed())
        h_a, _ = self.policy.init_rnn_states(env.n)
        masks = torch.ones((env.n, 1), dtype=torch.float32, device=self.device)
        total_rew = torch.zeros((), dtype=torch.float32, device=self.device)
        total_done = torch.zeros((), dtype=torch.int64, device=self.device)
        for _ in range(steps):
            actions, h_a = self.policy.act(obs, h_a, masks, deterministic=True)
            state, out = env.step(state, actions)
            reset = out.done | out.bad_done | out.exceed_time_limit
            masks = 1.0 - out.done.float()[:, None]
            h_a = h_a * (1.0 - reset.float())[:, None, None]
            total_rew += out.reward.sum()
            total_done += reset.sum()
            obs = out.obs
        all_reduce_sum([total_rew, total_done], self.mesh)
        return {"eval_average_episode_rewards":
                float(total_rew / total_done.clamp_min(1))}
