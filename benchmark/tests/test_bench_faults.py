"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven at a
tiny size on the CPU, with each fault a cell can have planted in the
program. (One card: no exchange between chips to leave out.)"""
from __future__ import annotations

import pytest
import torch

from benchmark import run

from .conftest import CELLS, SEED, kind_of, tiny_cell


def _step_unchanged(monkeypatch):
    """The env step returns the state it was given."""
    import neuralplane_tpu_torch.envs.base as base
    real = base.env_step

    def step(variant, cfg, w, sf, uf, *a, **k):
        out = real(variant, cfg, w, sf, uf, *a, **k)
        return (sf.clone(), uf.clone()) + tuple(out[2:])
    monkeypatch.setattr(base, "env_step", step)


def _reward_altered(monkeypatch):
    """Every eighth aircraft's reward altered where the step produces it."""
    import neuralplane_tpu_torch.envs.base as base
    real = base.env_step

    def step(*a, **k):
        out = list(real(*a, **k))
        out[5] = out[5].clone()
        out[5][::8] += 1.0
        return tuple(out)
    monkeypatch.setattr(base, "env_step", step)


def _optimizer_unchanged(monkeypatch):
    """The optimizer step leaves the parameters as they were."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    """Each minibatch's loss is the mean over half of its rows."""
    from neuralplane_tpu_torch.algorithms.ppo.trainer import PPOTrainer
    real = PPOTrainer.gather_minibatch
    monkeypatch.setattr(PPOTrainer, "gather_minibatch",
                        staticmethod(lambda chunks, idx: real(chunks, idx[:idx.numel() // 2])))


def _from_the_second_update(monkeypatch, fault):
    """Run `fault(trainer)` at the start of every update but the first (the
    warm-up's): a fault of the window's updates only."""
    from neuralplane_tpu_torch.algorithms.ppo.trainer import PPOTrainer
    real = PPOTrainer.train
    calls = []

    def train(self, batch, generator):
        calls.append(1)
        if len(calls) > 1:
            fault(self)
        return real(self, batch, generator)
    monkeypatch.setattr(PPOTrainer, "train", train)


def _half_batch_in_the_window(monkeypatch):
    """From the second update on, each minibatch's loss over half its rows."""
    def fault(trainer):
        real = trainer.gather_minibatch
        trainer.gather_minibatch = lambda chunks, idx: real(chunks, idx[:idx.numel() // 2])
    _from_the_second_update(monkeypatch, fault)


def _adam_reset_in_the_window(monkeypatch):
    """From the second update on, Adam starts each update afresh."""
    _from_the_second_update(monkeypatch, lambda trainer: trainer.optimizer.state.clear())


# the faults of the kinds this file knows; a new kind plants its own in a
# test file of its own
FAULTS = {"sim": [_step_unchanged, _reward_altered],
          "train": [_step_unchanged, _reward_altered, _optimizer_unchanged, _half_batch,
                    _half_batch_in_the_window, _adam_reset_in_the_window]}
CASES = [(cell, f) for cell in CELLS for f in FAULTS.get(kind_of(cell), [])]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{c}-{f.__name__[1:]}" for c, f in CASES])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    result, checks = run.execute(tiny_cell(name), SEED, 0.0, False, device="cpu")
    assert not result["correct"], checks
    assert result["failed"] >= 1
