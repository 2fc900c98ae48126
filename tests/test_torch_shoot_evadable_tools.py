"""The tools of the 1v1 evadable-missile run (`scripts/train_shoot_evadable.sh`)
on the CPU, at a tiny size:

- `tools/train_legs.py` at a save interval above 1: a leg cut by its
  budget keeps only the lines up to its last checkpoint and the pool that
  checkpoint names; the resumed leg restarts its save and eval cadence at
  its own episode 0, and `leg.json` records the run's episode of each save
  and each eval; the budget rule ends a leg at the last save that the
  median episode says fits; `--export-actor` writes a missile actor (the
  ShootTuple head) as the JAX pickle.
- `tools/heading_collect_compare.py --scenario selfplay_shoot_evadable`:
  one collect of each package from the same JAX init actor, on
  "distilled" (the JAX kernel in interpret mode): the launch, hit, pk and
  termination counts and the reward's event term agree within
  4 sqrt(c + c') + 1, and each package's reward splits by its own event
  rule (200 (done - bad)) with no ego step's rest of 100 or more.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from neuralplane_tpu_torch.algorithms.networks import params_from_jax
from neuralplane_tpu_torch.algorithms.ppo import PPOPolicy
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.envs import SingleCombatShootEnv
from neuralplane_tpu_torch.utils.checkpoint import load_jax_pickle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tool(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_jsonl(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("elapsed, taken, leg_episodes, want", [
    # 20 episodes of 50 s and two evals of 70 s from 2000 s: 3140 s fits
    (2000.0, 41, 100, None),
    # from 2200 s the next save would come at 3340 s: stop at this one
    (2200.0, 41, 100, "wall budget 3300 s: the next save, leg episode 60, predicted at 3340.0 s"),
    # the leg's last episode is nearer than a whole interval: 5 episodes, one eval
    (2900.0, 58, 63, None),
    (3100.0, 58, 63, "wall budget 3300 s: the next save, leg episode 62, predicted at 3420.0 s"),
    # nothing left to run, or the budget already spent
    (3299.0, 60, 60, None),
    (3300.0, 41, 100, "wall budget 3300 s"),
])
def test_budget_stop_ends_a_leg_at_the_last_save_that_fits(elapsed, taken, leg_episodes, want):
    tl = load_tool("train_legs")
    ep_s, eval_s = [50.0] * 30 + [400.0], [70.0, 70.0, 90.0]
    assert tl.budget_stop(elapsed, 3300.0, taken, leg_episodes, 20, 10, ep_s, eval_s) == want


def test_episode_seconds_leave_the_evals_out():
    tl = load_tool("train_legs")
    recs = [{"average_episode_rewards": 0.0, "wall_s": 60.0},
            {"average_episode_rewards": 0.0, "wall_s": 110.0},
            {"latest_elo": 1000.0, "wall_s": 180.0},
            {"average_episode_rewards": 0.0, "wall_s": 231.0}]
    assert tl.episode_seconds(recs) == ([60.0, 50.0, 51.0], [70.0])


def test_train_legs_cut_at_a_save_and_resumed(tmp_path):
    """A tiny 1v1 shoot run at save interval 2 and eval interval 2: leg 0
    cut by its budget at its first save, leg 1 resumed to the end."""
    src = os.path.join(REPO, "neuralplane_tpu_torch", "configs", "selfplay_shoot_evadable.yaml")
    with open(src, encoding="utf-8") as f:
        text = f.read().replace("max_steps: 2000", "max_steps: 4")
    assert "max_steps: 4" in text
    (tmp_path / "shoot.yaml").write_text(text)
    flags = ["--", "--env-name", "SingleCombatShoot", "--scenario-name",
             str(tmp_path / "shoot.yaml"), "--use-selfplay", "--use-prior",
             "--selfplay-algorithm", "fsp", "--n-choose-opponents", "1", "--elo-tie-band", "50",
             "--use-eval", "--eval-interval", "2", "--eval-stochastic",
             "--n-rollout-threads", "2", "--buffer-size", "4", "--data-chunk-length", "4",
             "--num-env-steps", "48", "--ppo-epoch", "1", "--num-mini-batch", "1",
             "--hidden-size", "16", "--act-hidden-size", "8", "--recurrent-hidden-size", "8",
             "--log-interval", "1", "--save-interval", "2", "--device", "cpu",
             "--aero-backend", "stacked"]
    tool = [sys.executable, os.path.join(REPO, "tools", "train_legs.py")]
    leg0, leg1 = tmp_path / "leg_0", tmp_path / "leg_1"
    for extra in (["--out", str(leg0), "--budget-s", "0"],
                  ["--out", str(leg1), "--resume", str(leg0), "--budget-s", "600"]):
        subprocess.run(tool + extra + flags, cwd=REPO, check=True, capture_output=True,
                       timeout=600)
    legs = [json.loads((d / "leg.json").read_text()) for d in (leg0, leg1)]
    assert legs[0]["stopped"] == "wall budget 0 s"
    assert [(leg["episodes"], leg["steps"], leg["first_episode"]) for leg in legs] == [
        (1, 8, 1), (5, 48, 2)]
    # leg 1 saves at its episodes 0, 2 and 4 (its last), evals after 2 and 4
    assert [(leg["save_episodes"], leg["eval_episodes"]) for leg in legs] == [
        ([1], []), ([2, 4, 6], [4, 6])]
    assert all(leg["save_interval"] == 2 and leg["eval_interval"] == 2 for leg in legs)

    # the lines stop at each leg's last checkpoint: one update per episode
    for d, leg, pool in ((leg0, legs[0], 2), (leg1, legs[1], 5)):
        recs = read_jsonl(d / "metrics.jsonl")
        episodes = [r for r in recs if "average_episode_rewards" in r]
        state = torch.load(d / "state_latest.pt", weights_only=True)
        assert state["step"] == leg["first_episode"] - 1 + len(episodes) == leg["save_episodes"][-1]
        # the pool entries are the checkpoint's: one at the start, one per save
        names = sorted(state["selfplay"]["policy_pool"], key=int)
        assert names == [str(k) for k in range(pool)]
        assert sorted(n for n in os.listdir(d) if n.startswith("actor_")) == [
            f"actor_{k}.pt" for k in range(pool)]

    # the merged lines are one run: continuous steps, the evals where recorded
    recs = [r for d in (leg0, leg1) for r in read_jsonl(d / "metrics.jsonl")]
    assert [(r["step"], "eval_episodes_ended" in r) for r in recs] == [
        (8, False), (16, False), (24, False), (32, False), (32, True), (40, False),
        (48, False), (48, True)]
    walls = [r["wall_s"] for r in recs]
    assert walls == sorted(walls)
    assert [r["step"] // 8 for r in recs if "eval_episodes_ended" in r] == \
        legs[0]["eval_episodes"] + legs[1]["eval_episodes"]

    # the final actor exported as the JAX package's pickle: the missile
    # env's ShootTuple head, as the runner built it
    pkl = tmp_path / "actor.pkl"
    subprocess.run(tool + ["--export-actor", str(leg1 / "state_latest.pt"), "--to", str(pkl)]
                   + flags, cwd=REPO, check=True, capture_output=True, timeout=600)
    state = torch.load(leg1 / "state_latest.pt", weights_only=True)
    actor = {k[len("actor."):]: v for k, v in state["policy"].items() if k.startswith("actor.")}
    assert any(k.startswith("head.shoot") for k in actor)
    back = params_from_jax(load_jax_pickle(str(pkl)))
    assert back.keys() == actor.keys()
    for k, v in actor.items():
        assert torch.equal(back[k], v), k


def test_collect_tool_reads_a_port_pool_entry(tmp_path):
    """A port pool entry (`actor_<n>.pt`) as the JAX actor tree the collect
    tool's --opponent takes, at the run's network sizes."""
    cc = load_tool("heading_collect_compare")
    env = SingleCombatShootEnv(1, cc.SHOOT, aero_backend="stacked", device="cpu")
    policy = PPOPolicy(RLConfig(use_prior=True), env.num_observation, env.num_actions,
                       act_space=env.action_space, prior_slots=env.shoot_prior_slots,
                       device="cpu")
    want = {k: v.clone() for k, v in policy.actor.state_dict().items()}
    torch.save(want, tmp_path / "actor_3.pt")
    got = params_from_jax(cc.load_actor(str(tmp_path / "actor_3.pt")))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("case, overrides", [
    ("run", {}),
    # a floor inside the reset's altitudes: many agents end at once, by
    # the bad flag, so the event rules differ
    ("ends", {"altitude_limit": 19500.0}),
])
def test_shoot_collect_counts_and_event_term_match_jax(tmp_path, case, overrides):
    cc = load_tool("heading_collect_compare")
    args = argparse.Namespace(scenario=cc.SHOOT, n=16, steps=48, seed=1, backend="distilled",
                              tmp=str(tmp_path), set=overrides, update=False,
                              checkpoint=None, opponent=None)
    cfg_kw = cc.collect_config(args)
    assert cfg_kw["use_prior"] and cfg_kw["selfplay_algorithm"] == "fsp"
    jrun, jout, _, _ = cc.run_jax(args, cfg_kw)
    jrun.close()
    pout, _, _ = cc.run_port_shoot(args, cfg_kw, args.jax_params)
    line = {"package": "x", "collect": None}
    rows = cc.compare_lines(dict(line, collect=jout), dict(line, collect=pout))
    counts = [r for r in rows if r[3] is not None]
    assert {r[0] for r in counts} >= {"shoot_launches", "shoot_hits", "shoot_pk_sum",
                                      "shoot_x_low_altitude_bad", "shoot_x_shutdown_done",
                                      "shoot_x_ego_done", "shoot_x_ego_bad", "shoot_x_ego_win",
                                      "shoot_x_ego_lose", "ends"}
    bad = [r for r in counts if not r[3]]
    assert not bad, bad
    assert jout["shoot_launches"] > 0 and pout["shoot_launches"] > 0
    for name, out in (("jax", jout), ("port", pout)):
        rt = out["reward_terms"]
        assert rt["done_bad"]["over"] == 0, (name, rt)
        # the event term is the ego's ends by the package's rule
        assert rt["done_bad"]["event_sum"] == 200.0 * (out["shoot_x_ego_done"]
                                                       - out["shoot_x_ego_bad"])
        assert rt["done_bad"]["event_sum"] + rt["done_bad"]["shaped_sum"] == \
            pytest.approx(rt["reward_sum"], rel=1e-12)
        assert rt["reward_sum"] == pytest.approx(
            out["average_episode_rewards"] * max(out["ends"], 1.0), rel=1e-6)
        if case == "ends":
            assert out["shoot_x_low_altitude_bad"] > 30 and out["ends"] > 20, (name, out)
            assert rt["win_lose"]["over"] > 0 and rt["rule"] == "done_bad", (name, rt)
            assert rt["done_bad"]["event_sum"] < 0
        else:
            assert rt["rule"] in ("done_bad", None), (name, rt)


@pytest.mark.parametrize("tool", ["heading_eval", "combat_eval"])
def test_jax_evals_leave_the_backend_variable_as_they_found_it(tool, monkeypatch, tmp_path,
                                                               capsys):
    """The JAX evals choose their envs' backend through
    NEURALPLANE_AERO_BACKEND; a caller in the same process (a test file
    after another on one worker) gets its own value back."""
    monkeypatch.delenv("NEURALPLANE_AERO_BACKEND", raising=False)
    ckpt = os.path.join(REPO, "results", "shoot_evadable", "policy_checkpoint.pkl")
    mod = load_tool(tool)
    if tool == "heading_eval":
        mod.main(["--package", "jax", "--env-name", "SingleCombatShoot", "--scenario",
                  "selfplay_shoot_evadable", "--checkpoint", ckpt, "--n", "2", "--steps", "1",
                  "--repeats", "1", "--backend", "stacked"])
    else:
        os.symlink(ckpt, tmp_path / "actor_final.pkl")
        mod.main(["jax-probe", "pk", "--", "--ckpt-dir", str(tmp_path), "--ego", "final",
                  "--opponent", "random", "--use-prior", "--num-envs", "2", "--steps", "2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "NEURALPLANE_AERO_BACKEND" not in os.environ
