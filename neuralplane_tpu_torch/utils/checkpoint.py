"""Checkpoints: the port's own format, and the JAX package's pickles read
without JAX (counterpart of neuralplane_tpu/utils/checkpoint.py).

The port's format is a `torch.save` of a dict (module and optimizer
state_dicts, the generator state, the update count), written atomically:
tmp file + os.replace, as `save_pytree` (:17-28), so that a kill during a
save never leaves a half-written `state_latest.pt`.

`save_actor_pickle` writes the other way: an actor's param tree
(`networks.params_to_jax`) as the JAX package's actor-only pickle, which
its runner grafts onto fresh params.

`load_jax_pickle` reads `neuralplane_tpu`'s checkpoints (`state_*.pkl`,
`results/*/policy_checkpoint*.pkl`, actor-only pickles). A plain
`pickle.load` of those would import the JAX package, flax and optax for
three classes; the unpickler here maps them to stand-ins instead (TrainState
to an attribute holder, optax's ScaleByAdamState and EmptyState to named
tuples), takes numpy's array reconstruction from whichever numpy is
installed, and refuses every other global.
"""
from __future__ import annotations

import collections
import os
import pickle
from typing import Any

import numpy as np
import torch


def save_checkpoint(path: str, blob: dict) -> None:
    """Atomic torch.save (tmp + rename)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def save_actor_pickle(path: str, actor_tree: Any) -> None:
    """An actor-only checkpoint in the JAX package's format: a pickle of the
    actor's param tree of numpy arrays (`networks.params_to_jax`), which the
    JAX runner grafts onto fresh params (neuralplane_tpu/runner/base.py:
    86-108); atomic (tmp + rename), as `save_pytree`."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(actor_tree, f)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    """A checkpoint written by save_checkpoint, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


class TrainState:
    """Stand-in for neuralplane_tpu.algorithms.ppo.trainer.TrainState: the
    pickle's fields (params, opt_state, step) as attributes."""


ScaleByAdamState = collections.namedtuple("ScaleByAdamState", ["count", "mu", "nu"])
EmptyState = collections.namedtuple("EmptyState", [])

_NUMPY_CORE = "numpy._core" if int(np.__version__.split(".")[0]) >= 2 else "numpy.core"
_STAND_INS = {
    ("neuralplane_tpu.algorithms.ppo.trainer", "TrainState"): TrainState,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.base", "EmptyState"): EmptyState,
}
_NUMPY = {("numpy", "ndarray"), ("numpy", "dtype"), ("numpy.core.multiarray", "_reconstruct"),
          ("numpy._core.multiarray", "_reconstruct"), ("numpy.core.multiarray", "scalar"),
          ("numpy._core.multiarray", "scalar")}


class _JaxCheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _STAND_INS:
            return _STAND_INS[module, name]
        if (module, name) in _NUMPY:
            if module.startswith(("numpy.core", "numpy._core")):
                module = _NUMPY_CORE + module.split("core", 1)[1]
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"{module}.{name}: not a class of a neuralplane_tpu checkpoint")


def load_jax_pickle(path: str) -> Any:
    """A neuralplane_tpu checkpoint pickle, its arrays as numpy, without
    importing jax, flax, optax or neuralplane_tpu."""
    with open(path, "rb") as f:
        return _JaxCheckpointUnpickler(f).load()
