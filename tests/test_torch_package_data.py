"""The port's own copies of the JAX package's data (CPU, no JAX).

- `neuralplane_tpu_torch/configs/*.yaml` (the scenario files) and
  `neuralplane_tpu_torch/data/*.npz` (the shipped surrogate weights) are
  byte for byte the JAX package's files, the same set of names, so the two
  cannot drift apart.
- No module of the port and no line of `chip_smoke.py` builds a path into
  the JAX package's folder: no `os.path.join(..., "neuralplane_tpu", ...)`
  and no string literal outside docstrings holding a `neuralplane_tpu/`
  path other than a `.py` file's (the kernel table cites a TPU kernel's
  file and line; docstrings cite a module's JAX counterpart). A snippet
  that does either is caught.
- The port's loaders read their own copies: `load_config` from its
  `configs/`, `load_distilled` and `load_aero_weights` from its `data/`.
"""
from __future__ import annotations

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "neuralplane_tpu")
PORT_PKG = os.path.join(REPO, "neuralplane_tpu_torch")
PATH = re.compile(r"(?<![\w.])neuralplane_tpu/[\w./*]*")
COPIED = [("configs", f) for f in sorted(os.listdir(os.path.join(JAX_PKG, "configs")))
          if f.endswith(".yaml")] + [("data", "f16_aero.npz"),
                                     ("data", "f16_aero_distilled.npz")]


@pytest.mark.parametrize("folder,name", COPIED, ids=[n for _, n in COPIED])
def test_copy_is_byte_identical(folder, name):
    with open(os.path.join(JAX_PKG, folder, name), "rb") as f:
        want = f.read()
    with open(os.path.join(PORT_PKG, folder, name), "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("folder,suffix", [("configs", ".yaml"), ("data", ".npz")])
def test_same_files(folder, suffix):
    def names(pkg):
        return sorted(f for f in os.listdir(os.path.join(pkg, folder)) if f.endswith(suffix))
    assert names(PORT_PKG) == names(JAX_PKG)
    assert len(names(PORT_PKG)) == (12 if folder == "configs" else 2)


def jax_folder_paths(source: str) -> list:
    """(line, text) of each path into the JAX package's folder in `source`:
    an `os.path.join` argument "neuralplane_tpu", or a string literal
    holding a "neuralplane_tpu/" path that is not a `.py` file and is not
    a docstring."""
    tree = ast.parse(source)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value,
                                                                     ast.Constant):
                docs.add(id(body[0].value))
    hits = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"):
            for arg in node.args:
                if isinstance(arg, ast.Constant) and arg.value == "neuralplane_tpu":
                    hits.append((node.lineno, "os.path.join(..., 'neuralplane_tpu', ...)"))
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs
                and any(not m.endswith(".py") for m in PATH.findall(node.value))):
            hits.append((node.lineno, node.value))
    return hits


def port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT_PKG):
        paths += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
    return paths


def test_no_port_module_reads_the_jax_folder():
    found = {}
    for path in port_sources():
        with open(path, encoding="utf-8") as f:
            hits = jax_folder_paths(f.read())
        if hits:
            found[os.path.relpath(path, REPO)] = hits
    assert not found, found
    bad = ('"""Cites neuralplane_tpu/configs/."""\nimport os\n'
           'A = os.path.join(ROOT, "neuralplane_tpu", "data")\nB = "neuralplane_tpu/configs"\n'
           'C = "neuralplane_tpu_torch/data/x.npz neuralplane_tpu/ops/step_pallas.py:329"\n'
           'D = f"{ROOT}/neuralplane_tpu/data/f16_aero.npz"\n')
    assert [line for line, _ in jax_folder_paths(bad)] == [3, 4, 6]


def test_loaders_read_the_port_copies():
    from neuralplane_tpu_torch.ops import aero
    from neuralplane_tpu_torch.utils import config
    assert os.path.samefile(config._CONFIG_DIR, os.path.join(PORT_PKG, "configs"))
    assert os.path.samefile(aero._DATA, os.path.join(PORT_PKG, "data"))
    assert config.load_config("tracking").low_level_steps == 50
    assert aero.load_distilled(device="cpu").W1.ndim == 2
    assert aero.load_aero_weights(device="cpu") is not None
