"""Base runner: policy, trainer and generator ownership, checkpoints and
logging (counterpart of neuralplane_tpu/runner/base.py:24-133).

Checkpoints carry the optimizer and the generator state as well as the
weights. Metrics go to `metrics.jsonl` in the run directory (one JSON
record per logged episode, the JAX package's scalars) and, when the
tensorboard package is importable and asked for, to a SummaryWriter.

`restore` reads the port's own checkpoints and the JAX package's pickles
(utils/checkpoint.load_jax_pickle); given a run directory, the port's
`checkpoints/state_latest.pt` where there is one, else the JAX runner's
`checkpoints/state_latest.pkl`. A pickle holds a whole TrainState (`state_*.pkl`,
`results/*/policy_checkpoint.pkl`) through `train_state_from_jax`, or an
actor-only pickle grafted onto the fresh critic with a fresh Adam (:90-109).
The graft checks every leaf's shape as well as the tree's names and names
the first leaf that differs (the JAX runner checks the structure only).

Subclasses keep host-side state in the checkpoint through the JAX runner's
two hooks: `_extra_state()` is merged into the saved blob,
and `restore` leaves the blob's other keys in `_restored_extras`, from a
port `.pt` and from a JAX `state_*.pkl` alike (empty for an actor-only
pickle). `restore` runs inside `Runner.__init__`, before a subclass sets its
own attributes, so the subclass reads `_restored_extras` after that.

With a mesh (parallel/mesh.py) the runner is one rank of a data-parallel
run: the env is the rank's share of the global batch, and the policy and
the optimizer are broadcast from rank 0 once built and restored. Rank r's
generator is seeded with `rank_seed(cfg.seed, r)`, cfg.seed itself on rank
0, so world size 1 is the run without a mesh bit for bit; ranks draw
decorrelated streams. Only rank 0 writes `metrics.jsonl`, TensorBoard and
checkpoints, and every save ends in a barrier. `close()` destroys the
process group if the mesh owns it.
"""
from __future__ import annotations

import json
import os
import time
import zipfile
from typing import Dict, Optional

import torch

from ..algorithms.networks import first_mismatch, params_from_jax
from ..algorithms.ppo import PPOPolicy, PPOTrainer, train_state_from_jax
from ..algorithms.rl_config import RLConfig
from ..parallel.mesh import Mesh, barrier, replicate
from ..utils.checkpoint import load_checkpoint, load_jax_pickle, save_checkpoint


def rank_seed(seed: int, rank: int) -> int:
    """Rank r's generator seed: `seed` on rank 0, else `seed` plus r times
    the 64-bit golden-ratio constant, modulo 2^63."""
    return seed if rank == 0 else (seed + rank * 0x9E3779B97F4A7C15) % 2 ** 63


class Runner:
    def __init__(self, env, cfg: RLConfig, run_dir: str = "runs/debug",
                 eval_env=None, model_dir: Optional[str] = None,
                 use_tensorboard: bool = False, device=None, mesh: Optional[Mesh] = None):
        self.env = env
        self.eval_env = eval_env
        self.cfg = cfg
        # the env's device unless given (a host-stepped env has none)
        self.device = torch.device(device) if device is not None else env.device
        self.mesh = mesh
        self.rank, self.world = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
        self.run_dir = run_dir
        self.save_dir = os.path.join(run_dir, "checkpoints")
        if self.rank == 0:
            os.makedirs(self.save_dir, exist_ok=True)

        self.policy, self.trainer = self._build_policy(env, cfg)
        # every draw of the rollouts and updates: actions, epoch
        # permutations, env seeds
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(cfg.seed, self.rank))
        self._restored_extras: Dict = {}
        if model_dir is not None:
            self.restore(model_dir)
        replicate(self.policy, mesh)
        replicate(self.trainer.optimizer, mesh)

        self._log_file = (open(os.path.join(run_dir, "metrics.jsonl"), "a")
                          if self.rank == 0 else None)
        self._tb = None
        if use_tensorboard and self.rank == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(run_dir)
            except ImportError:
                pass
        self._t0 = time.time()

    def _build_policy(self, env, cfg: RLConfig):
        # a non-Box env (the missile envs' ShootTuple) exposes `action_space`
        # and the obs slots of the Beta launch prior
        policy = PPOPolicy(cfg, env.num_observation, env.num_actions,
                           act_space=getattr(env, "action_space", None),
                           prior_slots=getattr(env, "shoot_prior_slots", (11, 13)),
                           device=self.device)
        return policy, PPOTrainer(cfg, policy, self.mesh)

    def next_seed(self) -> int:
        """A seed for an env reset, drawn from the runner's generator."""
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.generator,
                                 device=self.device))

    def train(self, batch) -> Dict[str, float]:
        metrics = self.trainer.train(batch, self.generator)
        values = torch.stack(list(metrics.values())).tolist()   # one transfer
        return dict(zip(metrics, values))

    # ---- persistence ----
    _CORE_KEYS = ("policy", "optimizer", "step", "generator", "generator_device")

    def _extra_state(self) -> Dict:
        """Subclass hook: host-side state that rides along in the checkpoint
        (the self-play runner's pool ratings)."""
        return {}

    def save(self, tag: str = "latest") -> str:
        """Rank 0 writes the checkpoint (its generator's state); every rank
        waits at a barrier."""
        path = os.path.join(self.save_dir, f"state_{tag}.pt")
        if self.rank == 0:
            save_checkpoint(path, {
                "policy": self.policy.state_dict(),
                "optimizer": self.trainer.optimizer.state_dict(),
                "step": self.trainer.step,
                "generator": self.generator.get_state(),
                "generator_device": self.device.type,
                **self._extra_state()})
        barrier(self.mesh)
        return path

    def restore(self, path: str) -> None:
        if os.path.isdir(path):
            # the port's own run directory, else the JAX runner's
            path = os.path.join(path, "checkpoints", "state_latest.pt")
            if not os.path.exists(path):
                path = path[:-len(".pt")] + ".pkl"
        if zipfile.is_zipfile(path):   # the port's own (torch.save) format
            blob = load_checkpoint(path)
            self.policy.load_state_dict(blob["policy"])
            self.trainer.optimizer.load_state_dict(blob["optimizer"])
            self.trainer.step = blob["step"]
            # a generator's state fits generators of its own device type
            # only; it is rank 0's, so rank r > 0 reseeds from a draw of it
            if blob["generator_device"] == self.device.type:
                self.generator.set_state(blob["generator"])
                if self.rank:
                    self.generator.manual_seed(rank_seed(self.next_seed(), self.rank))
            self._restored_extras = {k: v for k, v in blob.items()
                                     if k not in self._CORE_KEYS}
            return
        blob = load_jax_pickle(path)
        if isinstance(blob, dict) and "train_state" in blob:
            # the JAX threefry key has no torch counterpart: the generator
            # stays as seeded
            train_state_from_jax(blob["train_state"], self.trainer)
            self._restored_extras = {k: v for k, v in blob.items()
                                     if k not in ("train_state", "key")}
            return
        # actor-only pickle: graft the actor onto the fresh critic; critic
        # and Adam restart, the update count at 0
        actor = params_from_jax(blob)
        bad = first_mismatch(actor, self.policy.actor.state_dict())
        if bad is not None:
            raise ValueError(f"actor-only checkpoint {path} does not match this "
                             f"policy's actor: first difference at {bad}")
        self.policy.actor.load_state_dict(actor)
        self.trainer.init_state()
        self._restored_extras = {}

    # ---- logging ----
    def log_info(self, infos: Dict[str, float], total_num_steps: int) -> None:
        """One metrics record, on rank 0 only."""
        if self._log_file is None:
            return
        rec = {"step": int(total_num_steps),
               "wall_s": round(time.time() - self._t0, 2), **infos}
        self._log_file.write(json.dumps(rec) + "\n")
        self._log_file.flush()
        if self._tb is not None:
            for k, v in infos.items():
                self._tb.add_scalar(k, v, total_num_steps)

    def close(self) -> None:
        if self._log_file is not None:
            self._log_file.close()
        if self._tb is not None:
            self._tb.close()
        if self.mesh is not None:
            self.mesh.close()
