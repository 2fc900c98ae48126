"""The port's 1v1 evadable-missile run on the card (results/shoot_evadable_torch:
`scripts/train_shoot_evadable.sh` trained from scratch through the JAX run's
launch phase change, its episodes 1-120, at `--save-interval 20`), read from
its committed files on the CPU:

- the exported actor (`tools/train_legs.py --export-actor`) is the final
  checkpoint's, and flies as the JAX package's: the same deterministic
  action, and log-probs and entropies within 1e-5, on the JAX env's reset
  obs and seeded obs over every band of the launch prior;
- the REPORT's window and verdict tables are `tools/combat_eval.py curve
  --verdict` of the two `metrics.jsonl` files;
- each leg's `leg.json` and the pool follow the save cadence: a save every
  20 episodes from each leg's episode 0 and at its last, one pool entry
  per save, the merged lines one run of 120 episodes with an eval line
  after each recorded eval episode;
- `chip_smoke.py` phase 42's JAX constant is the JAX probe's line at its
  protocol (`jax_probes.jsonl`).
"""
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
from neuralplane_tpu.envs import SingleCombatShootEnv as JShoot
from neuralplane_tpu.runner import F16SimRunner as JF16SimRunner
from neuralplane_tpu_torch.algorithms.networks import params_to_jax
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.envs import SingleCombatShootEnv
from neuralplane_tpu_torch.runner import F16SimRunner
from neuralplane_tpu_torch.utils.checkpoint import load_checkpoint, load_jax_pickle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "results", "shoot_evadable_torch")
JAX_RUN = os.path.join(REPO, "results", "shoot_evadable")
PICKLE = os.path.join(RUN, "policy_checkpoint.pkl")
TOL = dict(rtol=1e-5, atol=1e-5)
ROWS = 16


def load_tool(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_jsonl(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def legs():
    names = sorted(n for n in os.listdir(RUN) if n.startswith("leg_"))
    out = []
    for n in names:
        with open(os.path.join(RUN, n, "leg.json"), encoding="utf-8") as f:
            out.append(json.load(f))
    return out


def test_exported_actor_is_the_final_checkpoints(tmp_path):
    state = load_checkpoint(os.path.join(RUN, "state_latest.pt"))
    env = SingleCombatShootEnv(1, "selfplay_shoot_evadable", aero_backend="stacked",
                               device="cpu")
    runner = F16SimRunner(env, RLConfig(use_prior=True), run_dir=str(tmp_path))
    runner.close()
    runner.policy.load_state_dict(state["policy"])
    want = params_to_jax(runner.policy.actor)
    got = load_jax_pickle(PICKLE)
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(jax.tree_util.tree_leaves(got))
    for path, w in leaves:
        g = got
        for k in path:
            g = g[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=str(path))
    # 120 episodes of 16 epochs x 5 minibatches
    assert state["step"] == 120 * 80


def test_exported_actor_flies_as_jax(tmp_path):
    env = SingleCombatShootEnv(2, "selfplay_shoot_evadable", device="cpu")
    jenv = JShoot(2, "selfplay_shoot_evadable")
    runner = F16SimRunner(env, RLConfig(use_prior=True), run_dir=str(tmp_path / "port"),
                          model_dir=PICKLE)
    jrun = JF16SimRunner(jenv, JRLConfig(use_prior=True), run_dir=str(tmp_path / "jax"),
                         model_dir=PICKLE)
    runner.close()
    jrun.close()
    _, jobs = jenv.reset(jax.random.PRNGKey(0))
    rng = np.random.default_rng(19)
    obs = rng.normal(0.0, 1.0, (ROWS, env.num_observation)).astype(np.float32)
    slots = env.shoot_prior_slots
    obs[:, slots[0]] = rng.uniform(0.0, np.pi / 2, ROWS)
    obs[:, slots[1]] = rng.uniform(0.2, 2.0, ROWS)
    obs[:len(jobs)] = np.asarray(jobs)
    h = np.zeros((ROWS, 1, 128), np.float32)
    masks = np.ones((ROWS, 1), np.float32)
    jargs = (jnp.asarray(obs), jnp.asarray(h), jnp.asarray(masks))
    ja, _ = jrun.policy.act(jrun.train_state.params, *jargs)
    jdist, _ = jrun.policy._dist_step(jrun.train_state.params, *jargs)
    args = (torch.from_numpy(obs), torch.from_numpy(h), torch.from_numpy(masks))
    with torch.no_grad():
        a, _ = runner.policy.act(*args)
        dist, _ = runner.policy.actor.dist_step(*args)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(dist.log_prob(a).numpy(), np.asarray(jdist.log_prob(ja)), **TOL)
    np.testing.assert_allclose(dist.entropy().numpy(), np.asarray(jdist.entropy()), **TOL)


def test_report_tables_are_the_curve_verdict(capsys):
    ce = load_tool("combat_eval")
    resumes = [leg["first_episode"] - 1 for leg in legs()[1:]]
    ce.main(["curve", os.path.join(JAX_RUN, "metrics.jsonl"), os.path.join(RUN, "metrics.jsonl"),
             "--labels", "JAX", "port", "--verdict", "--resumes", *map(str, resumes)])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("|")]
    with open(os.path.join(RUN, "REPORT.md"), encoding="utf-8") as f:
        report = f.read()
    assert len(lines) > 20
    for ln in lines:
        assert ln in report, ln


def test_legs_and_pool_follow_the_save_cadence():
    recs = read_jsonl(os.path.join(RUN, "metrics.jsonl"))
    episodes = [r for r in recs if "average_episode_rewards" in r]
    assert [r["step"] for r in episodes] == [k * 1_000_000 for k in range(1, 121)]
    walls = [r["wall_s"] for r in recs]
    assert walls == sorted(walls)
    evals = [r["step"] // 1_000_000 for r in recs if "eval_episodes_ended" in r]
    saves = []
    first = 1
    for leg in legs():
        assert leg["first_episode"] == first and leg["save_interval"] == 20
        assert leg["eval_interval"] == 10 and leg["leg_wall_s"] <= 3300.0
        last = first + leg["episodes"] - 1
        want = list(range(first, last + 1, 20))
        if want[-1] != last:
            assert leg["stopped"] == "child exited 0"   # a leg cut by its budget ends on a save
            want.append(last)
        assert leg["save_episodes"] == want
        assert leg["eval_episodes"] == list(range(first + 10, last + 1, 10))
        saves += want
        first = last + 1
    assert first == 121
    assert evals == [e for leg in legs() for e in leg["eval_episodes"]]
    # one pool entry at the start, then one per save
    state = load_checkpoint(os.path.join(RUN, "state_latest.pt"))
    pool = sorted(state["selfplay"]["policy_pool"], key=int)
    assert pool == [str(k) for k in range(len(saves) + 1)]
    files = sorted(n for n in os.listdir(os.path.join(RUN, "pool")))
    assert files == sorted(f"actor_{k}.pt" for k in pool)
    assert state["selfplay"]["latest_elo"] == pytest.approx(
        [r for r in recs if "eval_episodes_ended" in r][-1]["latest_elo"])


def test_phase_42_holds_the_jax_probe_line():
    sys.path.insert(0, REPO)
    import chip_smoke
    probes = read_jsonl(os.path.join(RUN, "jax_probes.jsonl"))
    n, steps = chip_smoke.SHOOT_EVADABLE_PK
    line, = [p["last"] for p in probes
             if p["argv"][p["argv"].index("--steps") + 1] == str(steps)
             and p["argv"][p["argv"].index("--num-envs") + 1] == str(n)
             and p["argv"][p["argv"].index("--opponent") + 1] == "random"]
    assert chip_smoke.SHOOT_EVADABLE_JAX == line
    assert line["ego_fired"] > 100
