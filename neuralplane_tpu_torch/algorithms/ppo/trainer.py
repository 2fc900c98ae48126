"""PPO trainer: the update from a rollout batch, GAE -> chunks -> epochs x
minibatches (counterpart of neuralplane_tpu/algorithms/ppo/trainer.py).

Loss as the JAX package's `_loss` (:49-76): clipped surrogate, optional
clipped value loss (0.5 * max(mse, clipped mse)), entropy bonus. Each
minibatch clips the actor's and the critic's gradients separately to a
global norm with the JAX formula min(1, max_grad_norm / (norm + 1e-12))
(:83-89; not clip_grad_norm_, whose eps is 1e-6), then takes one Adam step
over both (optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8, the same update as
torch.optim.Adam's). Each epoch draws a permutation of the chunks from the
generator given to `train` and sorts it within each minibatch (:127-136).
Metrics stay on the device until `train` returns.

The JAX TrainState (params, Adam state, update count) is here the policy's
modules, `optimizer` and `step`; `train_state_from_jax` carries one across.

With a mesh (parallel/mesh.py) each rank holds its share of the rollout
batch and draws its epoch permutations over its own chunks from its own
generator: the global minibatch is the union of the ranks' minibatches,
all of one size. The losses are means over it, so the mean of the ranks'
gradients is the global gradient: one all-reduce of every gradient per
minibatch, after `backward` and before the norms that clip it. The
advantages are normalized by the global mean and deviation, and `train`'s
metrics are averaged over the ranks.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from ...parallel.mesh import Mesh, all_reduce_mean
from ...utils.profiling import span
from ..networks import params_from_jax
from ..rl_config import RLConfig
from .buffer import RolloutBatch, compute_advantages, compute_returns, make_chunks
from .policy import PPOPolicy


def _global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all leaves (optax.global_norm)."""
    return torch.stack([g.pow(2).sum() for g in grads]).sum().sqrt()


class PPOTrainer:
    def __init__(self, cfg: RLConfig, policy: PPOPolicy, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.policy = policy
        self.mesh = mesh
        self.init_state()

    def init_state(self) -> None:
        """A fresh Adam over actor and critic and the update count at 0."""
        self.optimizer = torch.optim.Adam(self.policy.parameters(), lr=self.cfg.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.step = 0

    def _chunk_arrays(self, batch: RolloutBatch, returns, advantages) -> Tuple:
        """The batch's recurrent chunks, [C, L, ...] with the two initial
        rnn states [C, layers, H] last (MAPPOTrainer adds its own arrays)."""
        return make_chunks(batch, returns, advantages, self.cfg.data_chunk_length)

    # ---- loss over one recurrent-chunk minibatch ([L, N, ...] layout) ----
    def _evaluate(self, sample: Tuple):
        """(values, action_log_probs, entropy) of a minibatch's chunks."""
        obs, actions, masks, *_, h0_actor, h0_critic = sample
        return self.policy.evaluate_actions(obs, h0_actor, h0_critic, actions, masks)

    def _entropy_loss(self, entropy: torch.Tensor, sample: Tuple) -> torch.Tensor:
        return -entropy.mean()

    def _loss(self, sample: Tuple) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        old_logp, advs, rets, vpreds = sample[3:7]
        values, logp, entropy = self._evaluate(sample)

        ratio = torch.exp(logp - old_logp)
        surr1 = ratio * advs
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param) * advs
        policy_loss = -torch.minimum(surr1, surr2).mean()

        if cfg.use_clipped_value_loss:
            v_clip = vpreds + torch.clamp(values - vpreds, -cfg.clip_param,
                                          cfg.clip_param)
            value_loss = 0.5 * torch.maximum((values - rets) ** 2,
                                             (v_clip - rets) ** 2).mean()
        else:
            value_loss = 0.5 * ((rets - values) ** 2).mean()

        entropy_loss = self._entropy_loss(entropy, sample)
        loss = (policy_loss + value_loss * cfg.value_loss_coef
                + entropy_loss * cfg.entropy_coef)
        metrics = {"policy_loss": policy_loss, "value_loss": value_loss,
                   "policy_entropy_loss": entropy_loss, "ratio": ratio.mean()}
        return loss, {k: v.detach() for k, v in metrics.items()}

    def _backward(self, sample: Tuple) -> Dict[str, torch.Tensor]:
        """The loss's gradients in the parameters' `.grad`, averaged over the
        mesh in one all-reduce; returns the loss's metrics."""
        cuda = sample[0].is_cuda
        self.optimizer.zero_grad(set_to_none=True)
        with span("trainer.forward", device=cuda):
            loss, metrics = self._loss(sample)
        with span("trainer.backward", device=cuda):
            loss.backward()
            all_reduce_mean([p.grad for p in self.policy.parameters()], self.mesh)
        return metrics

    def _update_minibatch(self, sample: Tuple) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        metrics = self._backward(sample)
        norms = {}
        with span("trainer.optimizer", device=sample[0].is_cuda), torch.no_grad():
            for name, net in (("actor", self.policy.actor), ("critic", self.policy.critic)):
                grads = [p.grad for p in net.parameters()]
                norm = _global_norm(grads)
                if cfg.use_max_grad_norm:
                    # clip actor and critic separately (ppo_trainer.py:67-69)
                    scale = torch.clamp(cfg.max_grad_norm / (norm + 1e-12), max=1.0)
                    for g in grads:
                        g.mul_(scale)
                norms[f"{name}_grad_norm"] = norm
            self.optimizer.step()
        self.step += 1
        return {**metrics, **norms}

    def _permutation(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """One epoch's order of the n chunks (a test substitutes JAX's)."""
        return torch.randperm(n, generator=generator, device=generator.device)

    # ---- full update ----
    def chunks(self, batch: RolloutBatch) -> Tuple:
        """The batch's recurrent chunks with returns and advantages, the
        advantages normalized over the whole (global) batch."""
        cfg = self.cfg
        with torch.no_grad():
            returns = compute_returns(batch, cfg.gamma, cfg.gae_lambda,
                                      cfg.use_gae, cfg.use_proper_time_limits)
            advantages = compute_advantages(returns, batch.value_preds, self.mesh)
            return self._chunk_arrays(batch, returns, advantages)

    @staticmethod
    def gather_minibatch(chunks: Tuple, idx: torch.Tensor) -> Tuple:
        """Chunk rows [mb, L, ...] -> time-major [L, mb, ...]; the two
        initial rnn states (last entries) stay [mb, layers, H]."""
        out = [arr.index_select(0, idx) for arr in chunks]
        return tuple(a.transpose(0, 1) for a in out[:-2]) + tuple(out[-2:])

    def train(self, batch: RolloutBatch, generator: torch.Generator
              ) -> Dict[str, torch.Tensor]:
        """One PPO update from a rollout batch; returns the metrics averaged
        over minibatches, then over epochs (then over the mesh's ranks), as
        0-d tensors on the device."""
        with span("trainer.update"):
            cfg = self.cfg
            chunks = self.chunks(batch)
            num_chunks = chunks[0].shape[0]
            mb_size = num_chunks // cfg.num_mini_batch
            used = mb_size * cfg.num_mini_batch

            epochs = []
            for _ in range(cfg.ppo_epoch):
                perm = self._permutation(num_chunks, generator)[:used]
                # sorted within each minibatch: the loss is a mean, so the order
                # of rows is irrelevant; the random partition is unchanged
                mb_idx = perm.reshape(cfg.num_mini_batch, mb_size).sort(dim=1).values
                mbs = [self._update_minibatch(self.gather_minibatch(chunks, idx))
                       for idx in mb_idx]
                epochs.append({k: torch.stack([m[k] for m in mbs]).mean() for k in mbs[0]})
            names = list(epochs[0])
            values = torch.stack([torch.stack([e[k] for e in epochs]).mean() for k in names])
            all_reduce_mean([values], self.mesh)
            return dict(zip(names, values.unbind()))


def train_state_from_jax(ts, trainer: PPOTrainer) -> None:
    """Carry a JAX TrainState (leaves as numpy: a checkpoint read by
    utils/checkpoint.load_jax_pickle, or `jax.device_get(state)`) into the
    trainer: params into the policy, Adam's mu / nu / count
    (ScaleByAdamState) into torch.optim.Adam's exp_avg / exp_avg_sq / step,
    and the update count. The next update then continues JAX's Adam."""
    adam = next(s for s in ts.opt_state if hasattr(s, "mu"))
    trainer.policy.load_state_dict(params_from_jax(ts.params))
    mu, nu = params_from_jax(adam.mu), params_from_jax(adam.nu)
    names = [n for n, _ in trainer.policy.named_parameters()]
    sd = trainer.optimizer.state_dict()
    count = float(adam.count)
    sd["state"] = {i: {"step": torch.tensor(count), "exp_avg": mu[n],
                       "exp_avg_sq": nu[n]} for i, n in enumerate(names)}
    trainer.optimizer.load_state_dict(sd)
    trainer.step = int(ts.step)
