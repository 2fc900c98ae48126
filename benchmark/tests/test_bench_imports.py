"""The check that a run loaded no JAX: whole top-level names."""
from __future__ import annotations

import sys
import types

from benchmark import harness


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "neuralplane_tpu_torch_probe", types.ModuleType("x"))
    for name in ("jax", "jaxlib", "flax", "neuralplane_tpu", "neuralplane_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_modules()
    assert {"jax", "jaxlib", "flax", "neuralplane_tpu"} <= set(found)
    assert "neuralplane_tpu_torch" not in found and "neuralplane_tpu_torch_probe" not in found


def test_the_port_alone_loads_none(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    import benchmark.sim  # noqa: F401
    import benchmark.training  # noqa: F401
    import neuralplane_tpu_torch.runner  # noqa: F401
    assert harness.forbidden_modules() == []
