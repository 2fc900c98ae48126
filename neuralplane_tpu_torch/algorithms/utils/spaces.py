"""Minimal action/observation space descriptors (counterpart of
neuralplane_tpu/algorithms/utils/spaces.py, the same frozen dataclasses).

The reference uses gym 0.21 only for its spaces API; these carry the same
information without the dependency.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Box:
    shape: Tuple[int, ...]

    @property
    def dim(self) -> int:
        return self.shape[0]


@dataclasses.dataclass(frozen=True)
class Discrete:
    n: int

    @property
    def dim(self) -> int:
        return 1


@dataclasses.dataclass(frozen=True)
class MultiDiscrete:
    nvec: Tuple[int, ...]

    @property
    def dim(self) -> int:
        return len(self.nvec)


@dataclasses.dataclass(frozen=True)
class MultiBinary:
    n: int

    @property
    def dim(self) -> int:
        return self.n


@dataclasses.dataclass(frozen=True)
class ShootTuple:
    """(MultiDiscrete flight controls, Bernoulli shoot) - the combat
    'shoot missile' head (reference act.py:39-53)."""
    nvec: Tuple[int, ...]

    @property
    def dim(self) -> int:
        return len(self.nvec) + 1
