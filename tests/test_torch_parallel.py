"""The port's mesh and sharding helpers (neuralplane_tpu_torch/parallel) at
world size 1 and with shards cut by `shard_batch`, mirroring
tests/test_sharding.py on the CPU.

- `shard_batch_tree`'s axis rule: agent-major and feature-major leaves,
  a tie between two batch-sized axes (the last wins), leaves left whole.
- `shard_env_state` on a ControlEnv state and on a self-play carry ([n]
  env-state leaves and [n/2] ego leaves).
- A heading step on each half of a sharded global state equals the
  matching slice of the global step (the plain path, noise off), and six
  firing steps of SingleCombatShootEnv("selfplay_shoot_evadable") on each
  half match the global steps slice by slice at the tolerances of
  test_sharding.py:test_shoot_env_sharded_parity.
- The backend rule reads the cards the ranks hold: NCCL for a card per
  rank (also one visible card each, LOCAL_WORLD_SIZE above the count),
  gloo for the CPU or a shared card (also an explicit cuda:0 on every rank
  of a host with four), through the rendezvous store's card exchange.
- Collectives without a process group are the identity; in a one-process
  gloo group the Control, 1v1 self-play and MAPPO runners with a mesh are
  the runs without one, bit for bit, and closing the runner destroys the
  group its mesh owns.
"""
import dataclasses
import json
import socket
import threading
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.envs import (ControlEnv, MultipleCombatEnv, SingleCombatEnv,
                                        SingleCombatShootEnv)
from neuralplane_tpu_torch.parallel import (Mesh, all_reduce_mean, all_reduce_sum,
                                            broadcast, card_id, choose_backend,
                                            exchange_card_ids, local_device, make_mesh,
                                            replicate, shard_batch, shard_batch_tree,
                                            shard_count, shard_env_state)
from neuralplane_tpu_torch.parallel.mesh import tree_map
from neuralplane_tpu_torch.runner import F16SimRunner, MAPPOSelfplayRunner, SelfplayRunner
from neuralplane_tpu_torch.utils.config import load_config

CPU = torch.device("cpu")


def halves():
    """The two ranks of a 2-rank mesh, without a process group."""
    return [Mesh(device=CPU, rank=r, size=2) for r in range(2)]


def test_shard_batch_tree_axis_rule():
    n = 16
    tree = {"agent": torch.arange(n * 3.0).reshape(n, 3),
            "fm": torch.arange(12.0 * n).reshape(12, n),      # F16StateFM's layout
            "tie": torch.arange(n * n * 1.0).reshape(n, n),   # two batch-sized axes
            "ego": torch.arange(n // 2 * 5.0).reshape(n // 2, 5),
            "other": torch.arange(3.0), "scalar": torch.tensor(2.0), "name": "kept"}
    for mesh in halves():
        r, k = mesh.rank, n // 2
        out = shard_batch_tree(tree, (n, n // 2), mesh)
        assert torch.equal(out["agent"], tree["agent"][r * k:(r + 1) * k])
        assert torch.equal(out["fm"], tree["fm"][:, r * k:(r + 1) * k])
        assert out["fm"].is_contiguous()
        assert torch.equal(out["tie"], tree["tie"][:, r * k:(r + 1) * k])
        assert torch.equal(out["ego"], tree["ego"][r * 4:(r + 1) * 4])
        assert out["other"] is tree["other"] and out["scalar"] is tree["scalar"]
        assert out["name"] == "kept"
    whole = shard_batch_tree(tree, n, make_mesh("cpu"))
    assert all(torch.equal(whole[k], tree[k]) for k in ("agent", "fm", "tie"))
    assert make_mesh("cpu").size == 1 and make_mesh("cpu").group is None
    with pytest.raises(ValueError, match="do not divide"):
        shard_count(15, halves()[0])
    with pytest.raises(ValueError, match="do not divide"):
        shard_batch(torch.zeros(3, 5), halves()[1])


def test_shard_env_state_on_a_control_env_state():
    env = ControlEnv(num_envs=16, config="heading", device="cpu")
    state, _ = env.reset(0)
    assert state.model.sf.shape == (12, 16)
    for mesh in halves():
        sh = shard_env_state(state, mesh)
        cols = slice(mesh.rank * 8, (mesh.rank + 1) * 8)
        assert torch.equal(sh.model.sf, state.model.sf[:, cols])
        assert torch.equal(sh.step_count, state.step_count[cols])
        for f in dataclasses.fields(state.task):
            got, want = getattr(sh.task, f.name), getattr(state.task, f.name)
            assert torch.equal(got, want[cols]), f.name
    with pytest.raises(ValueError, match="use shard_batch_tree"):
        shard_env_state({"x": torch.zeros(4)}, halves()[0])


def test_shard_env_state_on_a_selfplay_carry(tmp_path):
    """[n] env-state leaves and [n/2] ego leaves shard on the same axis
    (the GRU width, 16, is neither n nor n/2: the rule would take it)."""
    env = SingleCombatEnv(num_envs=4, device="cpu")   # n = 8, n_ego = 4
    runner = SelfplayRunner(env, RLConfig(buffer_size=4, data_chunk_length=2,
                                          hidden_sizes=(8,), act_hidden_sizes=(8,),
                                          recurrent_hidden_size=16),
                            run_dir=str(tmp_path))
    carry = runner.init_carry(0)
    runner.close()
    for mesh in halves():
        sh = shard_env_state(carry, mesh)
        assert sh.env_state.step_count.shape == (4,)
        assert torch.equal(sh.env_state.model.s, carry.env_state.model.s
                           [mesh.rank * 4:(mesh.rank + 1) * 4])
        assert torch.equal(sh.ego_obs, carry.ego_obs[mesh.rank * 2:(mesh.rank + 1) * 2])
        assert sh.h_actor.shape == (2, *carry.h_actor.shape[1:])


def _copy(state):
    return tree_map(torch.clone, state)


def _step_n(env, state, action, steps):
    out = None
    for _ in range(steps):
        state, out = env.step(state, action)
    return state, out


def test_heading_step_on_each_half_matches_the_global_step():
    cfg = load_config("heading", noise_scale=0.0)
    full = ControlEnv(num_envs=16, config=cfg, task="heading", device="cpu")
    half = ControlEnv(num_envs=8, config=cfg, task="heading", device="cpu")
    state, _ = full.reset(0)
    half.reset(1)   # seeds the half env's generator
    action = torch.linspace(-0.5, 0.5, 16 * 4).reshape(16, 4)
    ref, ref_out = _step_n(full, _copy(state), action, 3)
    assert not (ref_out.done | ref_out.bad_done).any(), "a row reset: pick another seed"
    for mesh in halves():
        cols = slice(mesh.rank * 8, (mesh.rank + 1) * 8)
        sh, out = _step_n(half, shard_env_state(state, mesh), shard_batch(action, mesh), 3)
        np.testing.assert_allclose(sh.model.sf.numpy(), ref.model.sf[:, cols].numpy(),
                                   rtol=2e-6, atol=1e-6)
        np.testing.assert_allclose(out.obs.numpy(), ref_out.obs[cols].numpy(),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(out.reward.numpy(), ref_out.reward[cols].numpy(),
                                   rtol=1e-5, atol=1e-5)
        for flag in ("done", "bad_done", "exceed_time_limit"):
            assert torch.equal(getattr(out, flag), getattr(ref_out, flag)[cols])


def test_shoot_env_sharded_parity():
    """Weapon-layer sharding: the [n, K] missile slots, ammo and cooldown
    of the evadable variant step on each half as in the global batch."""
    full = SingleCombatShootEnv(num_envs=8, config="selfplay_shoot_evadable", device="cpu")
    half = SingleCombatShootEnv(num_envs=4, config="selfplay_shoot_evadable", device="cpu")
    state, _ = full.reset(0)
    half.reset(1)
    fire = torch.cat([torch.full((full.n, 4), 20.0), torch.ones((full.n, 1))], dim=1)
    ref, ref_out = _step_n(full, _copy(state), fire, 6)
    assert int(ref.missiles.active.sum()) > 0, "no missile in the air"
    for mesh in halves():
        rows = slice(mesh.rank * 8, (mesh.rank + 1) * 8)
        sh0 = shard_env_state(state, mesh)
        assert sh0.missiles.pos.shape[0] == 8 and sh0.ammo.shape[0] == 8
        sh, out = _step_n(half, sh0, shard_batch(fire, mesh), 6)
        assert torch.equal(sh.missiles.active, ref.missiles.active[rows])
        np.testing.assert_allclose(sh.missiles.pos.numpy(), ref.missiles.pos[rows].numpy(),
                                   rtol=2e-4, atol=2e-3)
        assert torch.equal(sh.ammo, ref.ammo[rows])
        np.testing.assert_allclose(sh.cooldown.numpy(), ref.cooldown[rows].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(out.obs.numpy(), ref_out.obs[rows].numpy(), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(out.reward.numpy(), ref_out.reward[rows].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_collectives_without_a_group_are_the_identity():
    mesh = halves()[1]
    x, y = torch.arange(4.0), torch.tensor(3, dtype=torch.int64)
    assert all_reduce_sum([x, y], mesh)[0] is x and torch.equal(x, torch.arange(4.0))
    assert torch.equal(all_reduce_mean([x], None)[0], torch.arange(4.0))
    assert torch.equal(broadcast([y], mesh)[0], torch.tensor(3))
    module = torch.nn.Linear(3, 2)
    before = module.weight.detach().clone()
    assert replicate(module, mesh) is module and torch.equal(module.weight, before)
    assert mesh.stats["all_reduce_calls"] == 0


@pytest.mark.parametrize("cards,backend", [
    ([None, None], "gloo"),
    (["GPU-a"], "nccl"),
    (["GPU-a", "GPU-b", "GPU-c", "GPU-d"], "nccl"),
    (["GPU-a", "GPU-a", "GPU-a", "GPU-a"], "gloo"),
    (["GPU-a", None], "gloo"),
], ids=["cpu", "one-card", "card-per-rank", "shared-card", "one-rank-off-the-card"])
def test_backend_rule(cards, backend):
    assert choose_backend(cards) == backend


@pytest.mark.parametrize("setup,backend", [
    # a launcher that shows each rank only its own card (CUDA_VISIBLE_DEVICES)
    (dict(device="cuda", count=1, uuid=lambda rank, index: f"GPU-{rank}"), "nccl"),
    # every rank told cuda:0 on a host with four cards
    (dict(device="cuda:0", count=4, uuid=lambda rank, index: f"GPU-{index}"), "gloo"),
], ids=["visible-card-per-rank", "explicit-index"])
def test_ranks_pick_the_backend_from_the_cards_they_hold(monkeypatch, setup, backend):
    """Four ranks (threads here) with LOCAL_WORLD_SIZE 4 resolve their
    device, publish its card's UUID to one store and apply the rule to
    every rank's: the count of visible cards does not decide."""
    world, rank_of = 4, threading.local()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(world))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: setup["count"])
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: types.SimpleNamespace(
        uuid=setup["uuid"](rank_of.rank, torch.device(dev).index)))
    store, chosen = dist.HashStore(), {}

    def rank_main(rank):
        rank_of.rank = rank
        dev = local_device(setup["device"])
        chosen[rank] = (dev, choose_backend(exchange_card_ids(store, rank, world,
                                                              card_id(dev))))
    threads = [threading.Thread(target=rank_main, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert sorted(chosen) == list(range(world))
    assert all(dev == torch.device("cuda", 0) and b == backend
               for dev, b in chosen.values())
    assert card_id("cpu") is None


def test_rank_one_writes_nothing_and_resumes_its_own_stream(tmp_path):
    """A rank other than 0 creates no directory and writes no metrics or
    checkpoint; restored from rank 0's checkpoint it draws from a stream of
    its own (rank 0 continues the saved one), the same on every restore."""
    cfg = RLConfig(**{**NET, "num_env_steps": 16})

    def runner(rank, run_dir, model_dir=None):
        env = ControlEnv(num_envs=4, config="heading", device="cpu")
        return F16SimRunner(env, cfg, run_dir=str(run_dir), model_dir=model_dir,
                            mesh=Mesh(device=CPU, rank=rank, size=2))
    first = runner(0, tmp_path / "r0")
    first.run()
    first.close()
    quiet = runner(1, tmp_path / "r1")
    quiet.run()
    quiet.close()
    assert not (tmp_path / "r1").exists()
    draws = []
    for rank, name in ((0, "a"), (1, "b"), (1, "c")):
        resumed = runner(rank, tmp_path / name, model_dir=str(tmp_path / "r0"))
        draws.append(resumed.next_seed())
        resumed.close()
    assert draws[0] == first.next_seed()
    assert draws[1] == draws[2] != draws[0]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def gloo_world_one():
    """A one-process gloo group for the test; destroyed after it if the
    runner under test did not."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_world_one_group_collectives(gloo_world_one):
    mesh = make_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, dist.group.WORLD)
    x = torch.arange(6.0).reshape(2, 3)
    n = torch.tensor([5], dtype=torch.int64)
    all_reduce_sum([x, n], mesh)
    assert torch.equal(x, torch.arange(6.0).reshape(2, 3)) and int(n) == 5
    all_reduce_mean([x], mesh)
    assert torch.equal(x, torch.arange(6.0).reshape(2, 3))
    assert mesh.stats["all_reduce_calls"] == 3   # one per dtype per call
    opt = torch.optim.Adam(torch.nn.Linear(2, 2).parameters())
    replicate(opt, mesh)   # a fresh Adam has no state: nothing to send
    assert mesh.stats["broadcast_calls"] == 0


RUNNERS = {
    "control": lambda: (F16SimRunner, ControlEnv(num_envs=4, config="heading", device="cpu")),
    "selfplay": lambda: (SelfplayRunner, SingleCombatEnv(2, aero_backend="stacked",
                                                         device="cpu")),
    "mappo": lambda: (MAPPOSelfplayRunner, MultipleCombatEnv(1, aero_backend="stacked",
                                                             device="cpu")),
}
NET = dict(buffer_size=4, data_chunk_length=2, ppo_epoch=2, num_mini_batch=2,
           hidden_sizes=(16,), act_hidden_sizes=(8,), recurrent_hidden_size=8,
           n_choose_opponents=1, save_interval=100, log_interval=1, num_env_steps=32)


@pytest.mark.parametrize("kind", list(RUNNERS))
def test_world_one_mesh_is_the_run_without_one(tmp_path, gloo_world_one, kind):
    """run() with a world-1 mesh over a gloo group against run() without a
    mesh, same seed: parameters, Adam state and logged metrics bit for bit;
    the mesh ran its collectives, and close() destroyed its group."""
    results = []
    for name, mesh in (("plain", None), ("mesh", make_mesh("cpu", owns_group=True))):
        cls, env = RUNNERS[kind]()
        runner = cls(env, RLConfig(**NET), run_dir=str(tmp_path / name), mesh=mesh)
        runner.run()
        runner.close()
        with open(tmp_path / name / "metrics.jsonl", encoding="utf-8") as f:
            records = [{k: v for k, v in json.loads(line).items()
                        if k not in ("wall_s", "fps")} for line in f]
        results.append((runner, records, mesh))
    (plain, rec_plain, _), (meshed, rec_mesh, mesh) = results
    assert rec_plain == rec_mesh and len(rec_plain) >= 2
    for (k, a), b in zip(plain.policy.state_dict().items(), meshed.policy.state_dict().values()):
        assert torch.equal(a, b), k
    s1, s2 = (r.trainer.optimizer.state_dict()["state"] for r in (plain, meshed))
    assert all(torch.equal(s1[i]["exp_avg_sq"], s2[i]["exp_avg_sq"]) for i in s1)
    assert mesh.stats["all_reduce_calls"] > 0 and not dist.is_initialized()
