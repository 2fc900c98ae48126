"""Action distributions as explicit formulas on tensors (counterpart of
neuralplane_tpu/algorithms/utils/distributions.py).

Each distribution is a NamedTuple of parameter tensors with
sample(generator) / mode / log_prob / entropy; `log_prob` and `entropy` sum
over the action dimension with keepdim ([N, A] -> [N, 1]). The formulas are
the JAX package's, written out (no torch.distributions), so that both
packages compute the same expressions in the same order.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)


class DiagGaussian(NamedTuple):
    mean: torch.Tensor     # [N, A]
    log_std: torch.Tensor  # [A] or [N, A]

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        eps = torch.randn(self.mean.shape, generator=generator,
                          device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + torch.exp(self.log_std) * eps

    def mode(self) -> torch.Tensor:
        return self.mean

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        log_std = self.log_std.expand_as(self.mean)
        z = (actions - self.mean) * torch.exp(-log_std)
        lp = -0.5 * (z * z + LOG_2PI) - log_std
        return lp.sum(-1, keepdim=True)

    def entropy(self) -> torch.Tensor:
        log_std = self.log_std.expand_as(self.mean)
        return (0.5 * (1.0 + LOG_2PI) + log_std).sum(-1, keepdim=True)


class Categorical(NamedTuple):
    logits: torch.Tensor  # [N, K]

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """Gumbel-max, as jax.random.categorical: argmax(logits + G) with
        G = -log(-log(u)). (torch.multinomial checks its input with a read
        back to the host, which a rollout step must not make.)"""
        u = torch.rand(self.logits.shape, generator=generator,
                       device=self.logits.device, dtype=self.logits.dtype)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return (self.logits + gumbel).argmax(-1, keepdim=True)

    def mode(self) -> torch.Tensor:
        return self.logits.argmax(-1, keepdim=True)

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        logp = F.log_softmax(self.logits, dim=-1)
        idx = actions.long().squeeze(-1)
        # one-hot contraction, as the JAX package (distributions.py:53-60)
        onehot = idx[..., None] == torch.arange(logp.shape[-1], device=logp.device)
        return torch.where(onehot, logp, 0.0).sum(-1, keepdim=True)

    def entropy(self) -> torch.Tensor:
        logp = F.log_softmax(self.logits, dim=-1)
        return -(torch.exp(logp) * logp).sum(-1, keepdim=True)


class Bernoulli(NamedTuple):
    """Parameterized by probabilities (the shoot head passes p directly)."""
    probs: torch.Tensor  # [N, K]

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        u = torch.rand(self.probs.shape, generator=generator,
                       device=self.probs.device, dtype=self.probs.dtype)
        return (u < self.probs).float()

    def mode(self) -> torch.Tensor:
        return (self.probs > 0.5).float()

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        p = self.probs.clamp(1e-6, 1.0 - 1e-6)
        lp = actions * torch.log(p) + (1.0 - actions) * torch.log1p(-p)
        return lp.sum(-1, keepdim=True)

    def entropy(self) -> torch.Tensor:
        p = self.probs.clamp(1e-6, 1.0 - 1e-6)
        h = -(p * torch.log(p) + (1.0 - p) * torch.log1p(-p))
        return h.sum(-1, keepdim=True)


def beta_shoot_probability(raw: torch.Tensor, alpha0: torch.Tensor,
                           beta0: torch.Tensor) -> torch.Tensor:
    """Beta-prior shoot probability (distributions.py:93-103): two
    softplus-constrained pseudo-counts in [0, 100] plus the prior's;
    p = (a + a0) / (a + a0 + b + b0)."""
    x = F.softplus(raw)
    x = 100.0 - F.softplus(100.0 - x)
    alpha = 1.0 + x[..., 0:1]
    beta = 1.0 + x[..., 1:2]
    return (alpha + alpha0) / (alpha + alpha0 + beta + beta0)
