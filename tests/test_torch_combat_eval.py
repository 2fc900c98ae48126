"""The port's combat evaluation probes (scripts/ladder_probe.py,
scripts/pk_probe.py) against the JAX package's tools (tools/ladder_probe.py,
tools/pk_probe.py, imported as they are) on the CPU.

- Accounting: a scripted env in each package replays the same numpy
  schedule of rewards, done, bad-done, time-limit, fire and pk-dealt flags
  (actions are ignored), 1v1 and 2v2, through both tools' `head_to_head` and
  `run_match`: episodes, wins and fire counts exactly, per-episode averages
  and pk sums within 1e-5 relative, with and without the both-sides sum.
- Every committed combat checkpoint the probes fly (the evadable flagship's
  2e9 and 2.3e9, the 1.3e9 start, the team game's two, the port's own 1v1
  self-play pool in results/selfplay_torch), the port's pool formats and
  `random` load through the CLIs' resolution with no shape mismatch.
- One real SingleCombatShoot match step (the 2e9 actor against the 1.3e9
  start, both playing the mode) from a JAX reset state carried across, through
  the port's match loop against the JAX step on the JAX actions, on
  "stacked", within `chip_smoke.py`'s COMBAT_LIMITS; the fire tallies
  exactly.
- Each CLI end to end at 4 envs x 5 steps, its last line parsed; the
  default device is the card, so without `--device cpu` it fails here.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralplane_tpu.algorithms.ppo import PPOPolicy as JPPOPolicy
from neuralplane_tpu.algorithms.rl_config import RLConfig as JRLConfig
from neuralplane_tpu.envs import SingleCombatShootEnv as JShoot
from neuralplane_tpu.envs.types import StepOutput as JStepOutput
from neuralplane_tpu_torch.algorithms.networks import params_to_jax
from neuralplane_tpu_torch.algorithms.ppo import PPOPolicy
from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
from neuralplane_tpu_torch.envs import SingleCombatShootEnv
from neuralplane_tpu_torch.envs.types import StepOutput
from neuralplane_tpu_torch.scripts import ladder_probe as lp
from neuralplane_tpu_torch.scripts import pk_probe as pp
from neuralplane_tpu_torch.utils.checkpoint import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "results")
REL = 1e-5


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_LADDER, J_PK = jax_tool("ladder_probe"), jax_tool("pk_probe")

# -------------------------------------------------------------- accounting

OBS, ACT, STEPS = 6, 4, 40


def schedule(n, seed):
    """Per-step rows of the scripted game, from numpy: one schedule for each
    of two matches ([2, STEPS, n])."""
    rng = np.random.default_rng(seed)
    shape = (2, STEPS, n)
    fire = rng.random(shape) < 0.3
    return dict(reward=rng.normal(0.0, 3.0, shape).astype(np.float32),
                done=rng.random(shape) < 0.08, bad_done=rng.random(shape) < 0.04,
                exceed=rng.random(shape) < 0.03, fire=fire,
                pk=(rng.random(shape) * fire).astype(np.float32))


class ScriptedEnv:
    """The k-th reset plays schedule k % 2, its row t at step t, whatever
    the actions; the state is (k % 2, t). `port` picks the package's
    tensors and StepOutput."""

    def __init__(self, port, num_envs, num_agents, sched):
        self.port, self.num_envs, self.num_agents = port, num_envs, num_agents
        self.n = num_envs * num_agents
        self.num_observation, self.num_actions = OBS, ACT
        conv = (lambda a: torch.from_numpy(a)) if port else jnp.asarray
        self.s = {k: conv(v) for k, v in sched.items()}
        self.resets = 0

    def reset(self, seed_or_key):
        xp = torch if self.port else jnp
        k, self.resets = self.resets % 2, self.resets + 1
        return (xp.asarray(k), xp.asarray(0)), xp.zeros((self.n, OBS), dtype=xp.float32)

    def step(self, state, action):
        k, t = state
        s = self.s
        info = {"shoot/fire_vec": s["fire"][k, t], "shoot/pk_dealt_vec": s["pk"][k, t]}
        obs = (torch if self.port else jnp).full((self.n, OBS), 0.1) * (t + 1)
        cls = StepOutput if self.port else JStepOutput
        return (k, t + 1), cls(obs=obs, reward=s["reward"][k, t], done=s["done"][k, t],
                               bad_done=s["bad_done"][k, t],
                               exceed_time_limit=s["exceed"][k, t], info=info)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny tensors: the suite runs six
    workers on the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def small_policies():
    kw = dict(hidden_sizes=(8,), act_hidden_sizes=(4,), recurrent_hidden_size=4)
    jpol = JPPOPolicy(JRLConfig(**kw), OBS, ACT)
    pol = PPOPolicy(RLConfig(**kw), OBS, ACT, device="cpu")
    actors = [pol.init_actor_params(torch.Generator().manual_seed(k)).requires_grad_(False)
              for k in (1, 2)]
    # the same weights in the JAX tree (the JAX init's eager ops cost seconds)
    return jpol, pol, [params_to_jax(a) for a in actors], actors


def assert_close(got, want, what):
    assert abs(got - want) <= REL * max(abs(want), 1.0), (what, got, want)


@pytest.mark.parametrize("num_agents", [2, 4])
def test_ladder_accounting_matches_the_jax_tool(num_agents):
    """head_to_head in both orientations, each alone and summed as
    --both-sides sums them (tools/ladder_probe.py:225-234)."""
    sched = schedule(3 * num_agents, seed=num_agents)
    jenv, env = (ScriptedEnv(port, 3, num_agents, sched) for port in (False, True))
    jpol, pol, (ja, jb), (a, b) = small_policies()
    # the scripted game ignores the actions: both play the mode (the sampled
    # path is the CLI test's)
    want = [J_LADDER.head_to_head(jenv, jpol, x, y, STEPS, jax.random.PRNGKey(s), "none")
            for x, y, s in ((ja, jb, 0), (jb, ja, 1))]
    got = [lp.head_to_head(env, pol, x, y, STEPS, s, "none") for x, y, s in ((a, b, 0), (b, a, 1))]
    for g, w in zip(got, want):
        assert w[2] > 5 and g[2:] == w[2:]          # episodes and wins exactly
        assert_close(g[0], w[0], "ego avg")
        assert_close(g[1], w[1], "opp avg")
    (e, o, ends, ew, ow), (o2, e2, ends2, ow2, ew2) = want
    both_want = ((e * ends + e2 * ends2) / (ends + ends2),
                 (o * ends + o2 * ends2) / (ends + ends2), ends + ends2, ew + ew2, ow + ow2)
    both = lp.both_sides_sum(*got)
    assert both[2:] == both_want[2:]
    assert_close(both[0], both_want[0], "both-sides ego avg")
    assert_close(both[1], both_want[1], "both-sides opp avg")
    d = both[0] - both[1]
    for band in (0.5 * abs(d), 2.0 * abs(d)):
        row = lp.ladder_row(env, pol, a, b, "x", STEPS, 0, "none", True, tie_band=band)
        assert row["diff"] == round(d, 3) and row["episodes"] == both[2]
        assert row["verdict"] == ("tie" if band > abs(d) else "WIN" if d > 0 else "LOSS")


@pytest.mark.parametrize("num_agents", [2, 4])
def test_pk_accounting_matches_the_jax_tool(num_agents):
    sched = schedule(3 * num_agents, seed=10 + num_agents)
    jenv, env = (ScriptedEnv(port, 3, num_agents, sched) for port in (False, True))
    jpol, pol, (ja, jb), (a, b) = small_policies()
    want = J_PK.run_match(jenv, jpol, ja, jb, STEPS, jax.random.PRNGKey(0))
    got = pp.run_match(env, pol, a, b, STEPS, 0)
    assert list(got) == list(want)
    assert want["ego_fired"] > 10 and want["episodes"] > 5
    for k in ("ego_fired", "opp_fired", "ego_wins", "opp_wins", "episodes"):
        assert got[k] == want[k], k
    for k in ("pk_by_ego", "pk_by_opp", "pk_against_ego", "pk_against_opp"):
        assert_close(got[k], want[k], k)


# ------------------------------------------------------------- checkpoints

# pool name -> committed file, and the env its policy flies
COMMITTED = {
    "final": ("shoot_evadable/policy_checkpoint_2e9.pkl", "selfplay_shoot_evadable"),
    "coda": ("shoot_evadable/policy_checkpoint_2p3e9.pkl", "selfplay_shoot_evadable"),
    "start13": ("evadable_pfsp_ab/fsp_final_checkpoint.pkl", "selfplay_shoot_evadable"),
    "team": ("mappo_2v2_evadable/policy_checkpoint_2p5e9.pkl",
             "multiple_selfplay_shoot_evadable"),
    "team1e9": ("mappo_2v2_evadable/policy_checkpoint.pkl", "multiple_selfplay_shoot_evadable"),
}
_POLICIES = {}


def links(tmp_path):
    d = tmp_path / "links"
    d.mkdir(exist_ok=True)
    for name, (path, _) in COMMITTED.items():
        if not (d / f"actor_{name}.pkl").exists():
            os.symlink(os.path.join(RESULTS, path), d / f"actor_{name}.pkl")
    return str(d)


def probe_policy(scenario, env_name=None):
    """The probes' policy for a scenario (the Beta prior on), built once."""
    if scenario not in _POLICIES:
        args = pp.get_parser().parse_args(["--ckpt-dir", ".", "--use-prior", "--device", "cpu"])
        env_name = env_name or ("MultipleCombatShoot" if "multiple" in scenario
                                else "SingleCombatShoot")
        env = lp.ENVS[env_name][0](num_envs=1, config=scenario, device="cpu")
        _POLICIES[scenario] = env, lp.make_policy(args, env)
    return _POLICIES[scenario]


@pytest.mark.parametrize("name", list(COMMITTED))
def test_committed_checkpoints_load_through_the_cli_resolution(name, tmp_path):
    _, policy = probe_policy(COMMITTED[name][1])
    actor = lp.load_actor(policy, links(tmp_path), name)
    want = policy.actor.state_dict()
    assert actor.state_dict().keys() == want.keys()
    assert any(not torch.equal(v, want[k]) for k, v in actor.state_dict().items())


@pytest.mark.parametrize("name", ["1", "10", "61"])
def test_committed_port_pool_loads_through_the_cli_resolution(name):
    """The port's own 1v1 self-play pool (results/selfplay_torch/pool, the
    port's actor_<n>.pt) as the ladder CLI reads it."""
    _, policy = probe_policy("selfplay", "SingleCombat")
    pool = os.path.join(RESULTS, "selfplay_torch", "pool")
    actor = lp.load_actor(policy, pool, name)
    assert policy.is_box and actor.state_dict().keys() == policy.actor.state_dict().keys()
    if name != "1":
        first = lp.load_actor(policy, pool, "1").state_dict()
        assert any(not torch.equal(v, first[k]) for k, v in actor.state_dict().items())


def test_port_pool_entries_and_random_load(tmp_path):
    """The port's own `actor_<n>.pt` and `state_<tag>.pt`, and a mismatched
    checkpoint named by its first differing leaf."""
    env, policy = probe_policy("selfplay_shoot_evadable")
    fresh = policy.init_actor_params(torch.Generator().manual_seed(5))
    save_checkpoint(str(tmp_path / "actor_3.pt"), fresh.state_dict())
    save_checkpoint(str(tmp_path / "state_latest.pt"),
                    {"policy": {f"actor.{k}": v for k, v in fresh.state_dict().items()}})
    for name in ("3", "latest"):
        got = lp.load_actor(policy, str(tmp_path), name)
        for k, v in fresh.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), (name, k)
    with pytest.raises(ValueError, match="first difference"):
        lp.load_actor(policy, links(tmp_path), "team")


# ------------------------------------------------------ one real match step

COMBAT_LIMITS = (1e-5, 1e-3, 0.02, 0.1)   # chip_smoke.py: median, level, share, max


def assert_combat_close(got, want, what):
    """Per column |got - want| / RMS(want): median, share above the level,
    max, at chip_smoke.py's COMBAT_LIMITS."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = np.sqrt(np.mean(want ** 2, axis=0)) + 1e-12
    err = np.abs(got - want) / rms
    med, level, share, mx = COMBAT_LIMITS
    assert np.median(err) <= med and (err > level).mean() <= share and err.max() <= mx, \
        (what, np.median(err), (err > level).mean(), err.max())


def test_one_match_step_from_a_jax_state(monkeypatch, tmp_path):
    # the 43 nets in float32 ("stacked"): the distilled xdot in Pallas
    # interpret mode takes the JAX step ~10 s longer to compile; the kernel
    # itself is held to its plain version on the card (chip_smoke.py 36)
    monkeypatch.setenv("NEURALPLANE_AERO_BACKEND", "stacked")
    cfg = "selfplay_shoot_evadable"
    jenv, env = JShoot(2, cfg), SingleCombatShootEnv(2, cfg, device="cpu")
    jpol = JPPOPolicy(JRLConfig(use_prior=True), jenv.num_observation, jenv.num_actions,
                      act_space=jenv.action_space, prior_slots=jenv.shoot_prior_slots)
    _, policy = probe_policy(cfg)
    d = links(tmp_path)
    j_ego, j_opp = (J_LADDER.load_actor(d, name) for name in ("final", "start13"))
    ego, opp = (lp.load_actor(policy, d, name) for name in ("final", "start13"))

    jstate, jobs = jenv.reset(jax.random.PRNGKey(3))
    h = jnp.zeros((2, 1, 128))
    masks = jnp.ones((2, 1))
    je, jo = jobs.reshape(2, 2, -1)[:, 0], jobs.reshape(2, 2, -1)[:, 1]
    act = jax.jit(lambda p, o: jpol.act({"actor": p}, o, h, masks, deterministic=True)[0])
    a_e, a_o = act(j_ego, je), act(j_opp, jo)
    jstate2, jout = jenv.step(jstate, jnp.stack([a_e, a_o], axis=1).reshape(4, -1))

    carry = lp.match_init(env, policy, 0)
    carry.env_state = env.state_from_jax(jax.tree.map(np.asarray, jstate))
    carry.ego_obs, carry.opp_obs = (torch.tensor(np.asarray(x)) for x in (je, jo))
    carry = lp.match_steps(env, ego, opp, carry, 1, sample=False)
    assert_combat_close(carry.env_state.model.s.numpy(), jstate2.model.s, "model state")
    obs = torch.cat([carry.ego_obs[:, None], carry.opp_obs[:, None]], 1).reshape(4, -1)
    assert_combat_close(obs.numpy(), jout.obs, "obs")
    t = lp.read_tallies(carry)
    fire = np.asarray(jout.info["shoot/fire_vec"]).reshape(2, 2)
    assert (t["ego_fired"], t["opp_fired"]) == (fire[:, 0].sum(), fire[:, 1].sum())
    resets = np.asarray(jout.done | jout.bad_done | jout.exceed_time_limit).reshape(2, 2)
    assert t["episodes"] == resets.any(1).sum()


# -------------------------------------------------------------------- CLIs

def test_both_clis_end_to_end(tmp_path, capsys):
    d = links(tmp_path)
    base = ["--ckpt-dir", d, "--num-envs", "4", "--steps", "5", "--use-prior"]
    pp.main(base + ["--ego", "final", "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"ego_fired", "opp_fired", "ego_wins", "opp_wins", "pk_by_ego",
                         "pk_by_opp", "pk_against_ego", "pk_against_opp", "episodes", "ego",
                         "opponent", "scenario"}
    assert (last["ego"], last["opponent"]) == ("final", "random")
    lp.main(base + ["--final", "final", "--opponents", "start13", "--env",
                    "SingleCombatShoot", "--scenario", "selfplay_shoot_evadable",
                    "--stochastic", "both", "--both-sides", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    rows = json.loads(lines[-1])["ladder"]
    assert [json.loads(x) for x in lines[:-1]] == rows and len(rows) == 1
    for row in rows:
        assert list(row) == ["opponent", "ego_avg", "opp_avg", "diff", "episodes", "ego_wins",
                             "opp_wins", "verdict"]
    if not torch.cuda.is_available():   # the card by default: no CPU fallback
        with pytest.raises((RuntimeError, AssertionError)):
            pp.main(base + ["--ego", "final"])
