"""The port imports neither JAX nor the JAX package, and its entry points
run on the card unless the caller asks for the CPU."""
import inspect
import os
import subprocess
import sys

import pytest
import torch

import neuralplane_tpu_torch
from neuralplane_tpu_torch.algorithms.mappo import MAPPOPolicy
from neuralplane_tpu_torch.algorithms.ppo import PPOPolicy
from neuralplane_tpu_torch.algorithms.pid import Controller
from neuralplane_tpu_torch.envs import (ControlEnv, Env, MultipleCombatEnv,
                                        MultipleCombatShootEnv, PlanningEnv, SingleCombatEnv,
                                        SingleCombatShootEnv, make_control_vec_env)
from neuralplane_tpu_torch.measure import (measure_combat_step, measure_combat_sweep,
                                           measure_env_step, measure_sweep)
from neuralplane_tpu_torch.parallel import (card_id, init_distributed, local_device,
                                            make_global_mesh, make_mesh)
from neuralplane_tpu_torch.ops.aero import (load_aero_weights, load_distilled,
                                            select_aero_weights)
from neuralplane_tpu_torch.ops.task_cuda import task_step
from neuralplane_tpu_torch.runner import GymRunner
from neuralplane_tpu_torch.scripts import bench as bench_cli
from neuralplane_tpu_torch.scripts import distill_aero as distill_cli
from neuralplane_tpu_torch.scripts import export as export_cli
from neuralplane_tpu_torch.scripts import render as render_cli
from neuralplane_tpu_torch.scripts import train as train_cli
from neuralplane_tpu_torch.scripts import train_surrogates as surrogates_cli
from neuralplane_tpu_torch.surrogates import train_surrogate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = r"""
import importlib, pkgutil, sys
import neuralplane_tpu_torch as p
names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "neuralplane_tpu"))
print(len(names), bad)
assert not bad, bad
print(" ".join(names))
"""

# modules added with the other airframes, the planning env, the gym
# adapters, the classical controllers, the combat envs, self-play, the
# action heads, the missiles, MAPPO, the tooling, data parallelism, the
# throughput harness and the combat evaluation probes: each must be among
# those imported above
NEW_MODULES = ("ops.linear_aero", "models.uav", "models.c172p", "envs.planning",
               "envs.wrappers", "runner.gym_adapter", "algorithms.pid",
               "algorithms.pid.config", "algorithms.pid.pid", "algorithms.pid.attitude",
               "algorithms.pid.speed", "algorithms.pid.tecs", "algorithms.pid.l1",
               "algorithms.pid.controller", "envs.combat", "algorithms.selfplay",
               "runner.selfplay", "algorithms.heads", "ops.missile", "envs.combat_shoot",
               "algorithms.mappo", "algorithms.mappo.policy", "algorithms.mappo.trainer",
               "runner.mappo", "ops.interp", "ops.lofi", "surrogates.tables",
               "surrogates.train", "surrogates.distill", "utils.geodesy", "render",
               "render.acmi", "render.trajectory", "utils.export", "utils.profiling",
               "scripts.distill_aero", "scripts.train_surrogates", "scripts.render",
               "scripts.export", "scripts.supervise", "parallel", "parallel.distributed",
               "parallel.mesh", "measure", "scripts.bench", "scripts.ladder_probe",
               "scripts.pk_probe")


def test_port_imports_no_jax():
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-c", CHECK], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 20, r.stdout
    imported = set(r.stdout.splitlines()[-1].split())
    assert {f"neuralplane_tpu_torch.{m}" for m in NEW_MODULES} <= imported, r.stdout


@pytest.mark.parametrize("entry", [ControlEnv, Env, load_distilled, measure_env_step,
                                   load_aero_weights, select_aero_weights, task_step,
                                   PPOPolicy, PlanningEnv, make_control_vec_env, GymRunner,
                                   SingleCombatEnv, MultipleCombatEnv,
                                   Controller().init_state, SingleCombatShootEnv,
                                   MultipleCombatShootEnv, MAPPOPolicy, train_surrogate,
                                   card_id, init_distributed, local_device,
                                   make_global_mesh, make_mesh, measure_sweep,
                                   measure_combat_step, measure_combat_sweep])
def test_entry_points_default_to_cuda(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_control_env_without_device_targets_cuda():
    """No silent CPU fallback: with no card the default construction fails;
    with one it lands on the card."""
    if torch.cuda.is_available():
        assert ControlEnv(num_envs=4).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            ControlEnv(num_envs=4)


def test_planning_env_without_device_targets_cuda():
    if torch.cuda.is_available():
        assert PlanningEnv(num_envs=2).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            PlanningEnv(num_envs=2)


@pytest.mark.parametrize("cls", [SingleCombatEnv, MultipleCombatEnv, SingleCombatShootEnv,
                                 MultipleCombatShootEnv])
def test_combat_envs_without_device_target_cuda(cls):
    if torch.cuda.is_available():
        assert cls(num_envs=2).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            cls(num_envs=2)


def test_aero_backends_outside_the_port_raise():
    """Only a name outside the four backends raises; each of the four
    constructs, resets and steps on the CPU."""
    with pytest.raises(ValueError, match="aero_backend must be one of"):
        ControlEnv(num_envs=4, aero_backend="mosaic", device="cpu")
    for backend in ("pallas", "stacked", "distilled", "auto"):
        env = ControlEnv(num_envs=4, aero_backend=backend, device="cpu")
        assert env.fused == (backend != "stacked")
        state, _ = env.reset(0)
        _, out = env.step(state, torch.zeros(4, env.num_actions))
        assert torch.isfinite(out.obs).all()
    assert neuralplane_tpu_torch.ControlEnv is ControlEnv


def test_training_entry_points_target_cuda():
    """The CLI's --device defaults to cuda, and the env it builds for
    F16SimRunner (whose device is its env's) lands on the card, or fails
    without one: no silent CPU fallback."""
    args = train_cli.get_parser().parse_args(["--n-rollout-threads", "2"])
    assert args.device == "cuda" and args.aero_backend == "auto"
    if torch.cuda.is_available():
        assert train_cli.make_env(args).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            train_cli.make_env(args)


@pytest.mark.parametrize("cli,argv", [
    (distill_cli, []), (surrogates_cli, ["--data-dir", "d"]), (render_cli, []),
    (export_cli, ["--checkpoint", "c", "--out", "o", "--obs-dim", "22"]), (bench_cli, [])])
def test_tooling_clis_default_to_cuda(cli, argv):
    assert cli.get_parser().parse_args(argv).device == "cuda"


def test_tooling_entry_points_target_cuda(tmp_path):
    """Without --device the render, distillation and export CLIs and
    train_surrogate fail without a card: no silent CPU fallback (on a card
    they run in chip_smoke.py phases 27-30)."""
    from neuralplane_tpu_torch.ops import lofi
    from neuralplane_tpu_torch.surrogates import AeroTable
    table = AeroTable("Cx", (lofi.ALPHA_AXIS, lofi.DELE_AXIS), lofi._CX.T.copy(),
                      ("alpha", "el"))
    runs = [lambda: render_cli.main(["--mode", "pid", "--steps", "1",
                                     "--out", str(tmp_path / "r")]),
            lambda: train_surrogate(table, epochs=1),
            lambda: distill_cli.main(["--steps", "1", "--out", str(tmp_path / "d.npz")]),
            lambda: export_cli.main(["--checkpoint", os.path.join(
                REPO, "results", "heading", "policy_checkpoint.pkl"), "--obs-dim", "22",
                "--out", str(tmp_path / "a.pt2")])]
    if torch.cuda.is_available():
        return
    for run in runs:
        with pytest.raises((RuntimeError, AssertionError)):
            run()


def test_bench_cli_targets_cuda(capsys):
    """Without --device the bench CLI (and each of its measurements) fails
    without a card and prints no result: no silent CPU fallback (on a card
    it runs in chip_smoke.py phase 34)."""
    if torch.cuda.is_available():
        return
    runs = [lambda: bench_cli.main(["--n", "2", "--steps", "1"]),
            lambda: bench_cli.main(["--n", "2", "--steps", "1", "--sweep"]),
            lambda: next(measure_combat_sweep(max_exp=1, steps=1)),
            lambda: measure_combat_step(10, steps=1)]
    for run in runs:
        with pytest.raises((RuntimeError, AssertionError)):
            run()
    assert capsys.readouterr().out == ""


LOADER_CHECK = r"""
import sys
from neuralplane_tpu_torch.utils.checkpoint import load_jax_pickle
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.envs import ControlEnv
from neuralplane_tpu_torch.runner import F16SimRunner
blob = load_jax_pickle("results/heading/policy_checkpoint.pkl")
assert int(blob["train_state"].step) > 0
import tempfile
env = ControlEnv(num_envs=2, device="cpu")
with tempfile.TemporaryDirectory() as d:
    F16SimRunner(env, RLConfig(), run_dir=d,
                 model_dir="results/heading/policy_checkpoint.pkl").close()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "neuralplane_tpu"))
print(bad)
assert not bad, bad
"""


def test_jax_checkpoint_loader_imports_no_jax():
    """Reading results/heading/policy_checkpoint.pkl (a pickle of the JAX
    package's TrainState with optax states inside) and restoring it into a
    runner leaves jax, flax, optax and neuralplane_tpu out of sys.modules."""
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-c", LOADER_CHECK], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
