"""Action heads for every action-space type, as nn.Modules (counterpart of
neuralplane_tpu/algorithms/heads.py).

Box -> DiagGaussian (tanh-squashed mean and a learnable log_std),
Discrete -> Categorical, MultiBinary -> Bernoulli, MultiDiscrete -> one
Categorical per dimension, ShootTuple (MultiDiscrete flight controls and a
shoot bit) -> the combat head whose Bernoulli probability is built from
softplus-bounded pseudo-counts plus the Beta prior (alpha0, beta0) of the
attack angle and distance (`shoot_priors`).

Each head is built with its input width, draws its parameters from the
torch.Generator given to `init_`, and `dist(feat, **priors)` returns a
distribution with sample(generator) / mode / log_prob / entropy. Submodule
names follow the JAX param tree, so `networks.params_from_jax` maps it with
no special case: {"logits": {w, b}} -> `logits.{weight,bias}`, a
MultiDiscrete head's list -> `<i>.logits.*`, the shoot head's
{"control": [...], "shoot": {w, b}} -> `control.<i>.logits.*`, `shoot.*`.

`HeadActor` is the actor of every non-Box space: trunk -> optional
`act_mlp` -> head, the layout of the JAX package's non-Box actor
{"trunk", "act_mlp", "head"} (ppo/policy.py:35-49). With `use_prior` (a
ShootTuple space only) it keys the Beta launch prior on the obs slots
`prior_slots`.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from . import networks as nets
from .utils.distributions import (Bernoulli, Categorical, DiagGaussian,
                                  beta_shoot_probability)
from .utils.spaces import Box, Discrete, MultiBinary, MultiDiscrete, ShootTuple


class _MultiDist(NamedTuple):
    """A product of independent per-dimension Categoricals (MultiDiscrete)."""
    dists: Tuple[Categorical, ...]

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        return torch.cat([d.sample(generator) for d in self.dists], dim=-1)

    def mode(self) -> torch.Tensor:
        return torch.cat([d.mode() for d in self.dists], dim=-1)

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        return sum(d.log_prob(actions[..., i:i + 1]) for i, d in enumerate(self.dists))

    def entropy(self) -> torch.Tensor:
        return sum(d.entropy() for d in self.dists)


class _ShootDist(NamedTuple):
    """(MultiDiscrete flight controls, Bernoulli shoot) product; actions are
    float32 [..., controls + 1], the indices then the shoot bit."""
    control: _MultiDist
    shoot: Bernoulli

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        control = self.control.sample(generator).to(self.shoot.probs.dtype)
        return torch.cat([control, self.shoot.sample(generator)], dim=-1)

    def mode(self) -> torch.Tensor:
        control = self.control.mode().to(self.shoot.probs.dtype)
        return torch.cat([control, self.shoot.mode()], dim=-1)

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        # the JAX package's full product likelihood, at rollout and in
        # training alike (its heads.py:62-68 documents the difference from
        # the reference, which drops the shoot term at rollout)
        nc = len(self.control.dists)
        return self.control.log_prob(actions[..., :nc]) + self.shoot.log_prob(actions[..., nc:])

    def entropy(self) -> torch.Tensor:
        return self.control.entropy() + self.shoot.entropy()


class BoxHead(nn.Module):
    def __init__(self, space: Box, in_dim: int, gain: float = 0.01):
        super().__init__()
        self.gain = gain
        self.mu = nets._dense(in_dim, space.dim)
        self.log_std = nn.Parameter(torch.zeros(space.dim))

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        nets._dense_init_(self.mu, self.gain, g)
        self.log_std.zero_()

    def dist(self, feat: torch.Tensor, **_) -> DiagGaussian:
        return DiagGaussian(torch.tanh(self.mu(feat)), self.log_std)


class DiscreteHead(nn.Module):
    def __init__(self, space: Discrete, in_dim: int, gain: float = 0.01):
        super().__init__()
        self.gain = gain
        self.logits = nets._dense(in_dim, space.n)

    def init_(self, g: torch.Generator) -> None:
        nets._dense_init_(self.logits, self.gain, g)

    def dist(self, feat: torch.Tensor, **_) -> Categorical:
        return Categorical(self.logits(feat))


class MultiBinaryHead(DiscreteHead):
    def __init__(self, space: MultiBinary, in_dim: int, gain: float = 0.01):
        super().__init__(Discrete(space.n), in_dim, gain)

    def dist(self, feat: torch.Tensor, **_) -> Bernoulli:
        return Bernoulli(torch.sigmoid(self.logits(feat)))


class MultiDiscreteHead(nn.ModuleList):
    """One DiscreteHead per dimension, state_dict keys `<i>.logits.*`."""

    def __init__(self, space: MultiDiscrete, in_dim: int, gain: float = 0.01):
        super().__init__(DiscreteHead(Discrete(n), in_dim, gain) for n in space.nvec)

    def init_(self, g: torch.Generator) -> None:
        for head in self:
            head.init_(g)

    def dist(self, feat: torch.Tensor, **_) -> _MultiDist:
        return _MultiDist(tuple(head.dist(feat) for head in self))


class ShootHead(nn.Module):
    """MultiDiscrete controls and the Beta-prior shoot Bernoulli."""

    def __init__(self, space: ShootTuple, in_dim: int, gain: float = 0.01):
        super().__init__()
        self.gain = gain
        self.control = MultiDiscreteHead(MultiDiscrete(space.nvec), in_dim, gain)
        self.shoot = nets._dense(in_dim, 2)

    def init_(self, g: torch.Generator) -> None:
        self.control.init_(g)
        nets._dense_init_(self.shoot, self.gain, g)

    def dist(self, feat: torch.Tensor, alpha0=3.0, beta0=10.0, **_) -> _ShootDist:
        prob = beta_shoot_probability(self.shoot(feat), alpha0, beta0)
        return _ShootDist(self.control.dist(feat), Bernoulli(prob))


def build_head(space, in_dim: int, gain: float = 0.01) -> nn.Module:
    """The head of `space` on features of width `in_dim`; its parameters are
    allocated and not drawn (`init_` draws them)."""
    for cls, head in ((Box, BoxHead), (Discrete, DiscreteHead), (MultiBinary, MultiBinaryHead),
                      (MultiDiscrete, MultiDiscreteHead), (ShootTuple, ShootHead)):
        if isinstance(space, cls):
            return head(space, in_dim, gain)
    raise NotImplementedError(f"Unsupported action space: {space!r}")


def shoot_priors(obs: torch.Tensor, ao_slot: int = 11, r_slot: int = 13):
    """Beta-prior pseudo-counts from the attack-angle (rad) and distance
    (10 km units) observation slots: alpha0 10 / 6 / 3 within 8 / 12 km /
    beyond, beta0 3 / 6 / 10 within 22.5 / 45 deg / beyond. The envs expose
    `shoot_prior_slots` (1v1: 11 / 13; team: the nearest enemy's block), so
    the prior is keyed on the lock target's geometry."""
    attack_deg = torch.rad2deg(obs[..., ao_slot:ao_slot + 1])
    distance_m = obs[..., r_slot:r_slot + 1] * 10000.0
    alpha0 = torch.where(distance_m <= 8000.0, 10.0,
                         torch.where(distance_m <= 12000.0, 6.0, 3.0))
    beta0 = torch.where(attack_deg <= 22.5, 3.0, torch.where(attack_deg <= 45.0, 6.0, 10.0))
    return alpha0, beta0


class HeadActor(nets._Net):
    """Trunk, optional act_mlp and a generic head (the non-Box actor).
    `dist_step` / `dist_seq` return the action distribution, as
    `networks.Actor`'s do for the Box space."""

    def __init__(self, spec: nets.NetSpec, act_space, generator: torch.Generator,
                 use_prior: bool = False, prior_slots=(11, 13)):
        super().__init__(spec)
        self.head = build_head(act_space, self.head_in, spec.gain)
        self.use_prior = use_prior and isinstance(act_space, ShootTuple)
        self.prior_slots = tuple(prior_slots)
        self.init_(generator)

    def init_(self, g: torch.Generator) -> None:
        super().init_(g)
        self.head.init_(g)

    def _dist(self, feat: torch.Tensor, obs: torch.Tensor):
        priors = {}
        if self.use_prior:
            priors = dict(zip(("alpha0", "beta0"), shoot_priors(obs, *self.prior_slots)))
        return self.head.dist(self.head_features(feat), **priors)

    def dist_step(self, obs, h, mask):
        """Rollout-time forward. Returns (distribution, new_h)."""
        feat, h = self.trunk.step(obs, h, mask)
        return self._dist(feat, obs), h

    def dist_seq(self, obs, h0, masks):
        """Training-time chunk forward, obs [T, N, D]. Returns the distribution."""
        feat, _ = self.trunk.seq(obs, h0, masks)
        return self._dist(feat, obs)
