"""Two-rank data parallelism of the port over gloo on the CPU, mirroring
tests/test_distributed.py (neuralplane_tpu_torch/parallel, the runners'
and trainers' `mesh=`, the train CLI's `--use-mesh`).

Two processes started by torch.multiprocessing (spawn) on a free port, each
one rank with its own share of the batch. The worker imports no JAX (it is
this module's top level: JAX is imported only inside the fixture and the
tests that compare against it), and reports what it imported.

- F16SimRunner on heading (4 envs per rank, noise off, "stacked"): one
  collect and one update with the permutations of a JAX key whose
  minibatches split evenly between the ranks. Both ranks end with
  bitwise-equal parameters, Adam state and metrics.
- The all-reduced gradient of the whole local batch equals a
  single-process port gradient on the concatenated batch within 1e-4 of
  each leaf's largest, and the JAX gradient on it likewise.
- The concatenated batch through the JAX F16SimRunner(mesh=make_mesh())
  .train from the same parameters and key: metrics and parameters at the
  tolerances of tests/test_torch_ppo.py:test_train_matches_jax_with_its_
  permutations.
- MAPPO with a Discrete head (entropy that depends on the obs) on a batch
  whose two halves hold 90% and 30% live agents: the all-reduced gradient
  matches the single-process port gradient and the JAX one within 1e-4 of
  each leaf's largest; per-rank denominators of the entropy term miss them.
- SelfplayRunner.eval_elo on a stub env whose ego wins on rank 0 and
  loses on rank 1: the global per-slice sums make it a win on both ranks
  (equal latest_elo and pool), and rank 0 alone wrote the pool file.
- The CLI under `torch.distributed.run --standalone --nproc-per-node 2
  ... --use-mesh --device cpu` for Control, Planning, 1v1 self-play and
  MAPPO: exit 0, one metrics.jsonl with global step counts; and
  `--use-mesh` without a launcher writes the metrics of the run without it.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from neuralplane_tpu_torch.algorithms.mappo import (MAPPOPolicy, MAPPOTrainer,
                                                    SharedRolloutBatch)
from neuralplane_tpu_torch.algorithms.ppo import PPOPolicy, PPOTrainer
from neuralplane_tpu_torch.algorithms.ppo.buffer import RolloutBatch
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.algorithms.utils import spaces
from neuralplane_tpu_torch.envs import ControlEnv
from neuralplane_tpu_torch.envs.types import StepOutput
from neuralplane_tpu_torch.parallel import init_distributed, make_global_mesh, shard_batch
from neuralplane_tpu_torch.runner import F16SimRunner, SelfplayRunner
from neuralplane_tpu_torch.runner import selfplay as selfplay_module
from neuralplane_tpu_torch.scripts import train as train_cli
from neuralplane_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTROL = os.path.join(REPO, "results", "control", "policy_checkpoint.pkl")
WORLD = 2
PPO_NET = dict(buffer_size=8, data_chunk_length=4, ppo_epoch=2, num_mini_batch=2,
               hidden_sizes=(16,), act_hidden_sizes=(8,), recurrent_hidden_size=8)
N_LOCAL = 4                 # heading envs per rank
CHUNKS = N_LOCAL * 8 // 4   # recurrent chunks per rank
MAPPO_NET = dict(hidden_sizes=(16,), act_hidden_sizes=(8,), recurrent_hidden_size=8,
                 lr=1e-3, entropy_coef=0.5, max_grad_norm=0.5, data_chunk_length=4)
OBS, HALF, N_ACT = 6, 2, 5
ELO_NET = dict(buffer_size=4, data_chunk_length=2, hidden_sizes=(8,), act_hidden_sizes=(8,),
               recurrent_hidden_size=8, n_choose_opponents=1, elo_tie_band=1.0)
IMPORTED_JAX = ("jax", "jaxlib", "flax", "optax", "neuralplane_tpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _grads(module):
    return {n: p.grad.clone() for n, p in module.named_parameters()}


def _full_batch_grads(trainer, batch):
    """The (all-reduced) loss gradient of every chunk of `batch` as one
    minibatch."""
    chunks = trainer.chunks(batch)
    trainer._backward(trainer.gather_minibatch(chunks, torch.arange(chunks[0].shape[0])))
    return _grads(trainer.policy)


# ---- the worker: one rank, no JAX ----
def _ppo_task(mesh, p, out_dir):
    env = ControlEnv(num_envs=N_LOCAL, config=load_config("heading", noise_scale=0.0),
                     task="heading", aero_backend="stacked", device="cpu")
    runner = F16SimRunner(env, RLConfig(**PPO_NET), run_dir=os.path.join(out_dir, "ppo"),
                          mesh=mesh)
    runner.policy.load_state_dict(p["policy"])
    _, batch, _ = runner.collect(runner.init_carry(runner.next_seed()))
    grads = _full_batch_grads(runner.trainer, batch)
    perms = [torch.from_numpy(x) for x in p["perms"][mesh.rank]]
    runner.trainer._permutation = lambda n, g: perms.pop(0)
    metrics = runner.train(batch)
    runner.close()
    opt = runner.trainer.optimizer.state_dict()["state"]
    return {"batch": dataclasses.asdict(batch), "grads": grads, "metrics": metrics,
            "params": runner.policy.state_dict(), "perms_left": len(perms),
            "exp_avg_sq": [opt[i]["exp_avg_sq"] for i in sorted(opt)]}


def _local_entropy_loss(entropy, sample):
    """MAPPO's entropy term with this rank's own denominator (wrong)."""
    active = sample[8]
    return -(entropy * active).sum() / active.sum().clamp_min(1.0)


def _mappo_task(mesh, p):
    pol = MAPPOPolicy(RLConfig(**MAPPO_NET), OBS, OBS * HALF,
                      act_space=spaces.Discrete(N_ACT), device="cpu")
    pol.load_state_dict(p["policy"])
    tr = MAPPOTrainer(pol.cfg, pol, mesh)
    batch = SharedRolloutBatch(**{k: shard_batch(torch.from_numpy(v), mesh, axis=1)
                                  for k, v in p["batch"].items()})
    out = {"global": _full_batch_grads(tr, batch)}
    tr._entropy_loss = _local_entropy_loss
    out["per_rank"] = _full_batch_grads(tr, batch)
    return out


class _StubCombatEnv:
    """1v1 layout for eval_elo: ego rows earn `ego_r` per step, enemy rows
    0; every 3rd step ends every group's episode."""
    num_agents, num_observation, num_actions = 2, 6, 4

    def __init__(self, ego_r: float, num_envs: int = 4):
        self.ego_r, self.num_envs = ego_r, num_envs
        self.n = num_envs * self.num_agents
        self.config = load_config("selfplay")
        self.device = torch.device("cpu")

    def reset(self, seed):
        return torch.zeros((), dtype=torch.int32), torch.zeros((self.n, self.num_observation))

    def step(self, state, action):
        count = state + 1
        is_ego = (torch.arange(self.n) % self.num_agents) == 0
        done = is_ego & bool(count % 3 == 0)
        z = torch.zeros(self.n, dtype=torch.bool)
        return count, StepOutput(obs=torch.zeros((self.n, self.num_observation)),
                                 reward=torch.where(is_ego, self.ego_r, 0.0), done=done,
                                 bad_done=z, exceed_time_limit=z, info={})


def _elo_task(mesh, out_dir):
    writes, save = [], selfplay_module.save_checkpoint

    def counted(path, obj):
        writes.append(os.path.basename(path))
        save(path, obj)
    selfplay_module.save_checkpoint = counted
    try:
        env = _StubCombatEnv(ego_r=2.0 if mesh.rank == 0 else -1.0)
        runner = SelfplayRunner(env, RLConfig(**ELO_NET), run_dir=os.path.join(out_dir, "elo"),
                                mesh=mesh)
        result = runner.eval_elo(num_steps=9)
        runner.close()
    finally:
        selfplay_module.save_checkpoint = save
    return {"eval": result, "latest_elo": runner.latest_elo, "pool": dict(runner.policy_pool),
            "writes": writes, "files": sorted(os.listdir(runner.save_dir))}


def _worker(rank, port, out_dir, payload):
    torch.set_num_threads(1)
    init_distributed(f"localhost:{port}", WORLD, rank, device="cpu")
    mesh = make_global_mesh("cpu")
    try:
        result = {"rank": mesh.rank, "size": mesh.size, "backend": dist.get_backend(),
                  "owns_group": mesh.owns_group,
                  "ppo": _ppo_task(mesh, payload["ppo"], out_dir),
                  "mappo": _mappo_task(mesh, payload["mappo"]),
                  "elo": _elo_task(mesh, out_dir), "stats": dict(mesh.stats),
                  "jax_modules": sorted(m for m in sys.modules
                                        if m.split(".")[0] in IMPORTED_JAX)}
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---- the parent: JAX references and the launches ----
def _to_np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _ppo_reference(tmp):
    """The JAX mesh runner on 8 heading envs, its parameters, and a key
    whose two epochs' minibatches each hold 4 chunks of either rank: the
    permutations of each rank follow from it."""
    import jax
    from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
    from neuralplane_tpu.envs import ControlEnv as JControlEnv
    from neuralplane_tpu.parallel import make_mesh as jax_mesh
    from neuralplane_tpu.runner import F16SimRunner as JF16SimRunner
    from neuralplane_tpu.utils.config import load_config as jax_load_config
    from neuralplane_tpu_torch.algorithms.networks import params_from_jax

    jenv = JControlEnv(num_envs=WORLD * N_LOCAL, task="heading", aero_backend="stacked",
                       config=jax_load_config("heading", noise_scale=0.0))
    jrun = JF16SimRunner(jenv, JRLConfig(**PPO_NET), run_dir=str(tmp / "jax"),
                         mesh=jax_mesh())
    total = WORLD * CHUNKS
    for seed in range(1000):
        key = jax.random.PRNGKey(seed)
        epoch_keys = jax.random.split(jax.random.split(key)[1], PPO_NET["ppo_epoch"])
        mbs = [np.sort(np.asarray(jax.random.permutation(k, total)).reshape(2, -1), axis=1)
               for k in epoch_keys]
        if all(((mb < CHUNKS).sum(axis=1) == CHUNKS // 2).all() for mb in mbs):
            break
    jrun.key = key   # F16SimRunner.train splits it: the epochs' keys above
    perms = [[np.concatenate([row[(row >= CHUNKS) == bool(r)] - r * CHUNKS for row in mb])
              for mb in mbs] for r in range(WORLD)]
    init = _to_np(jrun.train_state.params)
    return jrun, init, {"policy": params_from_jax(init), "perms": perms}


def _mappo_reference():
    """JAX MAPPO policy parameters (perturbed from the init) and a batch of
    12 agents whose first half is 90% alive and second half 30%."""
    import jax
    from neuralplane_tpu.algorithms.mappo import MAPPOPolicy as JMAPPOPolicy
    from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
    from neuralplane_tpu.algorithms.utils import spaces as jspaces
    from neuralplane_tpu_torch.algorithms.networks import params_from_jax

    jpol = JMAPPOPolicy(JRLConfig(**MAPPO_NET), OBS, OBS * HALF,
                        act_space=jspaces.Discrete(N_ACT))
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda x: np.asarray(x) + rng.normal(0.0, 0.3, np.shape(x))
                          .astype(np.float32), jpol.init_params(jax.random.PRNGKey(3)))
    T, N, L, f = 8, 12, MAPPO_NET["data_chunk_length"], np.float32
    obs = rng.normal(size=(T + 1, N, OBS)).astype(f)
    alive = np.where(np.arange(N) < N // 2, 0.1, 0.7)[None, :, None]
    batch = dict(obs=obs, share_obs=np.repeat(obs.reshape(T + 1, N // HALF, 1, HALF * OBS),
                                              HALF, axis=2).reshape(T + 1, N, HALF * OBS),
                 actions=rng.integers(0, N_ACT, (T, N, 1)).astype(f),
                 rewards=rng.normal(size=(T, N, 1)).astype(f),
                 masks=(rng.uniform(size=(T + 1, N, 1)) > 0.2).astype(f),
                 bad_masks=(rng.uniform(size=(T + 1, N, 1)) > 0.1).astype(f),
                 active_masks=(rng.uniform(size=(T + 1, N, 1)) > alive).astype(f),
                 action_log_probs=(rng.normal(size=(T, N, 1)) * 0.1 - 1.6).astype(f),
                 value_preds=rng.normal(size=(T + 1, N, 1)).astype(f),
                 rnn_states_actor=rng.normal(0, 0.5, (T // L, N, 1, 8)).astype(f),
                 rnn_states_critic=rng.normal(0, 0.5, (T // L, N, 1, 8)).astype(f))
    return jpol, params, {"policy": params_from_jax(params), "batch": batch}


def _planning_scenario(tmp):
    path = tmp / "tracking.yaml"
    with open(os.path.join(REPO, "neuralplane_tpu", "configs", "tracking.yaml"),
              encoding="utf-8") as f:
        path.write_text(f.read() + "\nlow_level_steps: 2\n")
    return str(path)


NET_FLAGS = ["--hidden-size", "16", "--act-hidden-size", "8", "--recurrent-hidden-size", "8",
             "--ppo-epoch", "1", "--log-interval", "1", "--device", "cpu",
             "--aero-backend", "stacked"]
# global counts: 4 / 4 / 2 / 2 envs in all, 2 / 2 / 1 / 1 per rank
CLI = {
    "Control": (["--env-name", "Control", "--scenario-name", "heading",
                 "--n-rollout-threads", "4", "--buffer-size", "8", "--data-chunk-length", "4",
                 "--num-env-steps", "64"], [32, 64]),
    "Planning": (["--env-name", "Planning", "--scenario-name", "{planning}",
                  "--low-level-ckpt", CONTROL, "--n-rollout-threads", "4", "--buffer-size",
                  "4", "--data-chunk-length", "2", "--num-env-steps", "16"], [16]),
    "SingleCombat": (["--env-name", "SingleCombat", "--scenario-name", "selfplay",
                      "--use-selfplay", "--selfplay-algorithm", "fsp",
                      "--n-rollout-threads", "2", "--buffer-size", "4",
                      "--data-chunk-length", "2", "--num-env-steps", "16"], [8, 16]),
    "MultipleCombat": (["--env-name", "MultipleCombat", "--scenario-name",
                        "multiple_selfplay", "--algorithm-name", "mappo", "--use-selfplay",
                        "--n-rollout-threads", "2", "--buffer-size", "4",
                        "--data-chunk-length", "2", "--num-env-steps", "32"], [16, 32]),
}


def _launch_cli(tmp):
    """Every CLI branch under torch.distributed.run, two ranks, started
    together."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    scenario = _planning_scenario(tmp)
    procs = {}
    for branch, (flags, _) in CLI.items():
        run_dir = tmp / f"cli_{branch}"
        argv = [a.format(planning=scenario) for a in flags] + NET_FLAGS + [
            "--use-mesh", "--run-dir", str(run_dir)]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(WORLD), "-m", "neuralplane_tpu_torch.scripts.train",
               *argv]
        procs[branch] = (subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT), run_dir)
    return procs


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The CLI launches and the two spawned ranks, run side by side; the
    JAX references the ranks are compared with."""
    tmp = tmp_path_factory.mktemp("dist")
    procs = _launch_cli(tmp)
    try:
        jrun, jinit, ppo = _ppo_reference(tmp)
        jpol, jparams, mappo = _mappo_reference()
        out_dir = tmp / "ranks"
        out_dir.mkdir()
        ctx = mp.start_processes(_worker, args=(_free_port(), str(out_dir),
                                                {"ppo": ppo, "mappo": mappo}),
                                 nprocs=WORLD, join=False, start_method="spawn")
        deadline = time.time() + 300
        while not ctx.join(timeout=2):
            if time.time() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail("the two ranks did not finish within 300 s")
        ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
                 for r in range(WORLD)]
        cli = {}
        for branch, (proc, run_dir) in procs.items():
            out, _ = proc.communicate(timeout=300)
            cli[branch] = (proc.returncode, out.decode(errors="replace"), run_dir)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"ranks": ranks, "cli": cli, "ppo": (jrun, jinit, ppo),
            "mappo": (jpol, jparams, mappo)}


def _assert_close_to_leaf_max(got, want, what):
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()), err_msg=f"{what}: {name}")


def _concat(batches, cls=RolloutBatch):
    return cls(**{k: torch.cat([b[k] for b in batches], dim=1) for k in batches[0]})


def test_two_ranks_over_gloo_import_no_jax(launched):
    r0, r1 = launched["ranks"]
    assert (r0["rank"], r1["rank"], r0["size"]) == (0, 1, WORLD)
    assert r0["backend"] == r1["backend"] == "gloo"
    assert not r0["owns_group"] and r0["jax_modules"] == r1["jax_modules"] == []
    # one gradient all-reduce per minibatch, not one per leaf
    minibatches = PPO_NET["ppo_epoch"] * PPO_NET["num_mini_batch"]
    assert r0["stats"]["all_reduce_calls"] < 3 * minibatches + 20


def test_ppo_ranks_end_bitwise_equal(launched):
    r0, r1 = (r["ppo"] for r in launched["ranks"])
    assert r0["perms_left"] == r1["perms_left"] == 0
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k
    assert all(torch.equal(a, b) for a, b in zip(r0["exp_avg_sq"], r1["exp_avg_sq"]))
    assert {k: float(v) for k, v in r0["metrics"].items()} == \
        {k: float(v) for k, v in r1["metrics"].items()}
    # the ranks collected different data from their own generators
    assert not torch.equal(r0["batch"]["actions"], r1["batch"]["actions"])


def test_allreduced_gradients_match_one_process_on_the_concatenated_batch(launched):
    r0, r1 = (r["ppo"] for r in launched["ranks"])
    for k, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][k]), k
    _, _, ppo = launched["ppo"]
    pol = PPOPolicy(RLConfig(**PPO_NET), 22, 4, device="cpu")
    pol.load_state_dict(ppo["policy"])
    single = _full_batch_grads(PPOTrainer(pol.cfg, pol), _concat([r0["batch"], r1["batch"]]))
    _assert_close_to_leaf_max(r0["grads"], single, "two ranks vs one process")


def _jax_ppo_sample(jrun, batches):
    import jax.numpy as jnp
    from neuralplane_tpu.algorithms.ppo import buffer as jbuf
    cfg = jrun.cfg
    jb = jbuf.RolloutBatch(**{k: jnp.asarray(np.concatenate([b[k].numpy() for b in batches],
                                                            axis=1)) for k in batches[0]})
    ret = jbuf.compute_returns(jb, cfg.gamma, cfg.gae_lambda)
    chunks = jbuf.make_chunks(jb, ret, jbuf.compute_advantages(ret, jb.value_preds),
                              cfg.data_chunk_length)
    sample = tuple(a if i >= len(chunks) - 2 else jnp.swapaxes(a, 0, 1)
                   for i, a in enumerate(chunks))
    return jb, sample


def test_two_rank_update_matches_the_jax_mesh_update(launched):
    import jax
    from test_torch_ppo import assert_params_close
    from neuralplane_tpu_torch.algorithms.networks import params_from_jax
    r0, r1 = (r["ppo"] for r in launched["ranks"])
    jrun, jinit, _ = launched["ppo"]
    jb, sample = _jax_ppo_sample(jrun, [r0["batch"], r1["batch"]])
    jgrads = _to_np(jax.grad(jrun.trainer._loss, has_aux=True)(jinit, sample)[0])
    _assert_close_to_leaf_max(r0["grads"], params_from_jax(jgrads), "two ranks vs JAX")
    jm = jrun.train(jb)   # F16SimRunner(mesh=make_mesh()).train on the 8-device CPU mesh
    for k in jm:
        np.testing.assert_allclose(float(r0["metrics"][k]), jm[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert_params_close(r0["params"], _to_np(jrun.train_state.params), jgrads,
                        jrun.cfg.lr, updates=4)


def test_mappo_uneven_active_masks_need_the_global_denominator(launched):
    import jax
    import jax.numpy as jnp
    from neuralplane_tpu.algorithms.mappo import MAPPOTrainer as JMAPPOTrainer
    from neuralplane_tpu.algorithms.mappo import SharedRolloutBatch as JBatch
    from neuralplane_tpu.algorithms.ppo import buffer as jbuf
    from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
    from neuralplane_tpu_torch.algorithms.networks import params_from_jax
    r0, r1 = (r["mappo"] for r in launched["ranks"])
    jpol, jparams, mappo = launched["mappo"]
    active = mappo["batch"]["active_masks"]
    assert active[:, :6].mean() > 0.8 and active[:, 6:].mean() < 0.4
    for k, g in r0["global"].items():
        assert torch.equal(g, r1["global"][k]), k

    pol = MAPPOPolicy(RLConfig(**MAPPO_NET), OBS, OBS * HALF,
                      act_space=spaces.Discrete(N_ACT), device="cpu")
    pol.load_state_dict(mappo["policy"])
    batch = SharedRolloutBatch(**{k: torch.from_numpy(v) for k, v in mappo["batch"].items()})
    single = _full_batch_grads(MAPPOTrainer(pol.cfg, pol), batch)
    _assert_close_to_leaf_max(r0["global"], single, "two ranks vs one process")

    jtr = JMAPPOTrainer(JRLConfig(**MAPPO_NET), jpol)
    jb = JBatch(**{k: jnp.asarray(v) for k, v in mappo["batch"].items()})
    ret = jbuf.compute_returns(jb, jtr.cfg.gamma, jtr.cfg.gae_lambda)
    chunks = jtr._chunk_arrays(jb, ret, jbuf.compute_advantages(ret, jb.value_preds))
    sample = tuple(a if i >= len(chunks) - 2 else jnp.swapaxes(a, 0, 1)
                   for i, a in enumerate(chunks))
    jgrads = params_from_jax(_to_np(jax.grad(jtr._loss, has_aux=True)(jparams, sample)[0]))
    _assert_close_to_leaf_max(r0["global"], jgrads, "two ranks vs JAX")
    # each rank dividing by its own live agents is not the global ratio
    with pytest.raises(AssertionError):
        _assert_close_to_leaf_max(r0["per_rank"], single, "per-rank denominators")


def test_eval_elo_is_the_same_on_both_ranks(launched):
    """Rank 0's ego wins each episode by 6, rank 1's loses by 3: 12 episodes
    each, a global mean of +1.5 against a tie band of 1.0 -> a win on both
    ranks (alone, rank 1 would have lost). Rank 0 wrote the one pool file."""
    r0, r1 = (r["elo"] for r in launched["ranks"])
    assert r0["latest_elo"] == r1["latest_elo"] == pytest.approx(1016.0)
    assert r0["pool"] == r1["pool"] == {"0": pytest.approx(984.0)}
    assert r0["eval"] == r1["eval"] and r0["eval"]["eval_episodes_ended"] == 24.0
    assert (r0["writes"], r1["writes"]) == (["actor_0.pt"], [])
    assert r0["files"] == r1["files"] == ["actor_0.pt"]


@pytest.mark.parametrize("branch", list(CLI))
def test_cli_under_torchrun(launched, branch):
    rc, out, run_dir = launched["cli"][branch]
    assert rc == 0, out[-3000:]
    with open(run_dir / "metrics.jsonl", encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    # rank 0 alone logs: one record per episode, steps counted over both ranks
    assert [r["step"] for r in records] == CLI[branch][1], out[-3000:]
    assert all(np.isfinite(r["policy_loss"]) for r in records)
    assert (run_dir / "checkpoints" / "state_latest.pt").exists()
    assert "backend gloo" in out


def test_use_mesh_without_a_launcher_is_the_run_without_it(tmp_path):
    flags, _ = CLI["Control"]
    records = []
    for name, extra in (("plain", []), ("mesh", ["--use-mesh"])):
        train_cli.main(flags + NET_FLAGS + extra + ["--run-dir", str(tmp_path / name)])
        with open(tmp_path / name / "metrics.jsonl", encoding="utf-8") as f:
            records.append([{k: v for k, v in json.loads(line).items()
                             if k not in ("wall_s", "fps")} for line in f])
    assert records[0] == records[1] and [r["step"] for r in records[0]] == [32, 64]
    assert not dist.is_initialized()
