"""The port's CUDA kernels against their plain PyTorch versions on the card
(ops/aero_cuda.py, ops/aero_grouped_cuda.py, ops/task_cuda.py,
ops/step_cuda.py in both modes), at n = 4099 (no multiple of any tile) and,
for the persistent tile loops, at ragged sizes around one tile (64 aircraft
in the distilled kernels, 32 in the 43-net ones); and the training loop on
the card (collects launch env_step once per step, the policy on the card
agrees with its CPU copy), and the combat and missile steps (the xdot
kernel against its plain version, no host sync, a MAPPO collect with no
host sync), and the throughput harness's 1v1 missile step on the 43 nets.
Every test here is marked
`cuda` and skips without an NVIDIA GPU. The file imports no JAX, so that it
runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda

It also holds the numpy input generators that the CPU parity tests share.
"""
import numpy as np
import pytest
import torch

from neuralplane_tpu_torch.ops import aero as taero
from neuralplane_tpu_torch.ops import aero_cuda
from neuralplane_tpu_torch.ops import aero_grouped_cuda as tgrp
from neuralplane_tpu_torch.ops import step_cuda, task_cuda
from neuralplane_tpu_torch.utils.config import load_config

T = torch.from_numpy


def envelope_states(rng, n):
    """[n, 12] states and [n, 5] controls inside the termination limits."""
    s = np.zeros((n, 12), np.float32)
    s[:, 0:2] = rng.uniform(-3e3, 3e3, (n, 2))
    s[:, 2] = rng.uniform(5e3, 2.5e4, n)
    s[:, 3:6] = rng.uniform(-0.8, 0.8, (n, 3))
    s[:, 6] = rng.uniform(400.0, 1300.0, n)
    s[:, 7:9] = rng.uniform(-0.2, 0.4, (n, 2))
    s[:, 9:12] = rng.uniform(-0.5, 0.5, (n, 3))
    u = np.zeros((n, 5), np.float32)
    u[:, 0] = rng.uniform(1e3, 1e4, n)
    u[:, 1:4] = rng.uniform(-15.0, 15.0, (n, 3))
    return s, u


def query_points(seed, n):
    """(alpha_deg, beta_deg, el) of tests/test_aero_pallas.py:31-33."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-15, 40, n).astype(np.float32),
            rng.uniform(-25, 25, n).astype(np.float32),
            rng.uniform(-20, 20, n).astype(np.float32))


def envelope(seed, n):
    """States and controls of tests/test_aero_pallas.py:94-110."""
    rng = np.random.default_rng(seed)
    s = np.zeros((n, 12), np.float32)
    s[:, 0] = rng.uniform(-1e4, 1e4, n)
    s[:, 1] = rng.uniform(-1e4, 1e4, n)
    s[:, 2] = rng.uniform(3000, 30000, n)
    s[:, 3] = rng.uniform(-1.0, 1.0, n)
    s[:, 4] = rng.uniform(-0.8, 0.8, n)
    s[:, 5] = rng.uniform(-3.0, 3.0, n)
    s[:, 6] = rng.uniform(300, 1200, n)
    s[:, 7] = rng.uniform(-0.3, 0.7, n)
    s[:, 8] = rng.uniform(-0.4, 0.4, n)
    s[:, 9:12] = rng.uniform(-1.0, 1.0, (n, 3))
    u = np.zeros((n, 5), np.float32)
    u[:, 0] = rng.uniform(0, 5e4, n)
    u[:, 1:4] = rng.uniform(-20, 20, (n, 3))
    return s, u


def totals_feats(seed, n):
    """The inputs of tests/test_aero_pallas.py:55-67."""
    rng = np.random.default_rng(seed)
    alpha, beta, el = (rng.uniform(lo, hi, n) for lo, hi in ((-15, 40), (-25, 25), (-20, 20)))
    dlef = rng.uniform(0.0, 1.0, n)
    dail, drud = rng.uniform(-1.0, 1.0, n), rng.uniform(-1.0, 1.0, n)
    P, Q, R = (rng.uniform(-1, 1, n) for _ in range(3))
    vt = rng.uniform(300, 1200, n)
    return np.stack([alpha, beta, el, dlef, dail, drud, P, Q, R,
                     1.0 / (2.0 * vt)]).astype(np.float32)


def card_weights(backend="pallas"):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return taero.select_aero_weights(backend, device="cuda")


def assert_kernel_close(got, want):
    """chip_smoke.py's limits: per column relative to its RMS, median
    1e-5, at most 1% of rows above 1e-3, none above 0.1."""
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    err = (got - want).abs() / want.pow(2).mean(0).sqrt().clamp_min(1e-12)
    assert err.median(0).values.max() < 1e-5
    assert (err > 1e-3).float().mean(0).max() < 1e-2 and err.max() < 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("row_major", [False, True])
def test_coeffs_kernel_matches_plain_on_card(row_major):
    w = card_weights()
    a, b, e = (T(x).cuda() for x in query_points(8, 4099))
    got = tgrp.aero_coeffs_grouped(w, a, b, e, row_major=row_major)
    want = tgrp.aero_coeffs_grouped_plain(w, a, b, e, row_major=row_major)
    assert got.shape == ((4099, 43) if row_major else (43, 4099))
    assert_kernel_close(got if row_major else got.T, want if row_major else want.T)


@pytest.mark.cuda
def test_totals_kernel_matches_plain_on_card():
    w = card_weights()
    feats = T(totals_feats(9, 4099)).cuda()
    assert_kernel_close(tgrp.aero_totals(w, feats).T, tgrp.aero_totals_plain(w, feats).T)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden_bf16", [True, False])
def test_xdot_kernel_matches_plain_on_card(hidden_bf16):
    w = card_weights()
    s, u = (T(x).cuda() for x in envelope(10, 4099))
    assert_kernel_close(tgrp.nlplant_grouped(w, s, u, hidden_bf16),
                        tgrp.nlplant_grouped_plain(w, s, u, hidden_bf16))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["heading", "control", "tracking"])
@pytest.mark.parametrize("backend", ["pallas", "distilled"])
def test_step_kernel_matches_plain_on_card(backend, variant):
    w = card_weights(backend)
    n = 4099
    rng = np.random.default_rng(12)
    cfg = load_config(variant)
    s, u = envelope_states(rng, n)
    f = lambda a: T(np.ascontiguousarray(a, np.float32)).cuda()
    args = (variant, cfg, w, f(s.T), f(u.T), f(rng.uniform(-1.2, 1.2, (n, 4))),
            T(rng.uniform(size=n) < 0.2).cuda(),
            f(rng.uniform(cfg.min_altitude, cfg.max_altitude, n)),
            f(rng.uniform(cfg.min_vt, cfg.max_vt, n)),
            tuple(f(s[:, k] + rng.uniform(-1, 1, n)) for k in (2, 5, 6)),
            T(rng.integers(0, 2600, n).astype(np.int32)).cuda())
    got, want = step_cuda.env_step(*args), step_cuda.env_step_plain(*args)
    assert_kernel_close(got[0].T, want[0].T)
    assert_kernel_close(got[2], want[2])
    assert (got[3] != want[3]).float().mean() <= 1e-3
    assert (got[4] != want[4]).float().mean() <= 1e-3
    assert (got[6] - want[6]).abs().max() <= 4


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["heading", "control", "tracking"])
def test_task_step_kernel_matches_plain_on_card(variant):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    n = 4099
    rng = np.random.default_rng(13)
    s, u = envelope_states(rng, n)
    f = lambda a: T(np.ascontiguousarray(a, np.float32)).cuda()
    args = (variant, load_config(variant), f(s), f(u), f(rng.normal(0, 1, (n, 12))),
            tuple(f(s[:, k] + rng.uniform(-1, 1, n)) for k in (2, 5, 6)),
            T(rng.integers(0, 2600, n).astype(np.int32)).cuda())
    got, want = task_cuda.task_step(*args), task_cuda.task_step_plain(*args)
    assert_kernel_close(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert torch.equal(got[4], want[4])


# The distilled kernels walk over 64-aircraft tiles with one persistent block
# per SM: one aircraft, one short of a tile, a whole tile, one over, and a
# size that leaves most SMs without a tile (5 tiles and 3 aircraft).
RAGGED = [1, 63, 64, 65, 64 * 5 + 3]


def assert_rows_close(got, want, scale):
    """As assert_kernel_close, with each column's scale taken from a larger
    batch: a handful of rows has no RMS of its own."""
    err = (got - want).abs().reshape(got.shape[0], -1) / scale.reshape(1, -1)
    assert err.median() < 1e-5 and err.max() < 0.1
    assert (err > 1e-3).float().mean() < 1e-2 or got.shape[0] < 100


def check_xdot_ragged(backend, n, hidden_bf16):
    """The first n rows of a 4099-row batch through the xdot kernel of
    `backend`: against the plain version, and bit for bit against the same
    rows inside the larger batch."""
    w = card_weights(backend)
    kernel, plain = ((aero_cuda.nlplant_distilled, aero_cuda.nlplant_distilled_plain)
                     if backend == "distilled" else
                     (tgrp.nlplant_grouped, tgrp.nlplant_grouped_plain))
    s, u = (T(x).cuda() for x in envelope(14, 4099))
    full = plain(w, s, u, hidden_bf16)
    scale = full.pow(2).mean(0).sqrt().clamp_min(1e-12)
    got = kernel(w, s[:n], u[:n], hidden_bf16)
    torch.cuda.synchronize()
    assert got.shape == (n, 12) and torch.isfinite(got).all()
    assert_rows_close(got, full[:n], scale)
    assert torch.equal(got, kernel(w, s, u, hidden_bf16)[:n])


def check_step_ragged(backend, n, hidden_bf16):
    """The first n rows of a 4099-row batch through the step kernel in the
    mode of `backend`, against env_step_plain on the same rows."""
    w = card_weights(backend)
    big = 4099
    rng = np.random.default_rng(15)
    cfg = load_config("heading")
    s, u = envelope_states(rng, big)
    f = lambda a: T(np.ascontiguousarray(a, np.float32)).cuda()
    sf, uf = f(s.T), f(u.T)
    act = f(rng.uniform(-1.2, 1.2, (big, 4)))
    mask = T(rng.uniform(size=big) < 0.2).cuda()
    alt0 = f(rng.uniform(cfg.min_altitude, cfg.max_altitude, big))
    vt0 = f(rng.uniform(cfg.min_vt, cfg.max_vt, big))
    tg = tuple(f(s[:, k] + rng.uniform(-1, 1, big)) for k in (2, 5, 6))
    sc = T(rng.integers(0, 2600, big).astype(np.int32)).cuda()

    def args(m):
        return ("heading", cfg, w, sf[:, :m].contiguous(), uf[:, :m].contiguous(), act[:m],
                mask[:m], alt0[:m], vt0[:m], tuple(t[:m] for t in tg), sc[:m])

    full = step_cuda.env_step_plain(*args(big), hidden_bf16=hidden_bf16)
    got = step_cuda.env_step(*args(n), hidden_bf16=hidden_bf16)
    want = step_cuda.env_step_plain(*args(n), hidden_bf16=hidden_bf16)
    torch.cuda.synchronize()
    assert got[0].shape == (12, n) and got[2].shape == (n, 22)
    rms = lambda t: t.pow(2).mean(0).sqrt().clamp_min(1e-12)
    assert_rows_close(got[0].T, want[0].T, rms(full[0].T))
    assert_rows_close(got[1].T, want[1].T, rms(full[1].T))
    assert_rows_close(got[2], want[2], rms(full[2]))
    assert (got[3] != want[3]).sum() <= 1 and (got[4] != want[4]).sum() <= 1
    assert (got[6] - want[6]).abs().max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("hidden_bf16", [True, False])
@pytest.mark.parametrize("n", RAGGED)
def test_distilled_xdot_kernel_ragged_sizes_on_card(n, hidden_bf16):
    check_xdot_ragged("distilled", n, hidden_bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden_bf16", [True, False])
@pytest.mark.parametrize("n", RAGGED)
def test_distilled_step_kernel_ragged_sizes_on_card(n, hidden_bf16):
    check_step_ragged("distilled", n, hidden_bf16)


# The 43-net kernels walk over 32-aircraft warp tiles, 16 warps to a
# persistent block: one aircraft, one short of a tile, a whole tile, one
# over, a size that leaves most warps of the one busy block idle (5 tiles and
# 3 aircraft), and one that leaves most blocks idle (3 blocks' worth and 7).
GROUPED_RAGGED = [1, 31, 32, 33, 32 * 5 + 3, 512 * 3 + 7]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden_bf16", [True, False])
@pytest.mark.parametrize("n", GROUPED_RAGGED)
def test_grouped_xdot_kernel_ragged_sizes_on_card(n, hidden_bf16):
    check_xdot_ragged("pallas", n, hidden_bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden_bf16", [True, False])
@pytest.mark.parametrize("n", GROUPED_RAGGED)
def test_grouped_step_kernel_ragged_sizes_on_card(n, hidden_bf16):
    check_step_ragged("pallas", n, hidden_bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("row_major", [False, True])
@pytest.mark.parametrize("n", GROUPED_RAGGED)
def test_grouped_coeffs_kernel_ragged_sizes_on_card(n, row_major):
    w = card_weights()
    a, b, e = (T(x).cuda() for x in query_points(16, 4099))
    full = tgrp.aero_coeffs_grouped_plain(w, a, b, e, row_major=True)       # [4099, K]
    scale = full.pow(2).mean(0).sqrt().clamp_min(1e-12)
    got = tgrp.aero_coeffs_grouped(w, a[:n], b[:n], e[:n], row_major=row_major)
    torch.cuda.synchronize()
    assert got.shape == ((n, taero.K) if row_major else (taero.K, n))
    rows = got if row_major else got.T
    assert torch.isfinite(rows).all()
    assert_rows_close(rows, full[:n], scale)
    # the same aircraft inside the larger batch, and in the other layout
    assert torch.equal(rows, tgrp.aero_coeffs_grouped(w, a, b, e, row_major=True)[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("n", GROUPED_RAGGED)
def test_grouped_totals_kernel_ragged_sizes_on_card(n):
    w = card_weights()
    feats = T(totals_feats(17, 4099)).cuda()
    full = tgrp.aero_totals_plain(w, feats).T                                  # [4099, 6]
    scale = full.pow(2).mean(0).sqrt().clamp_min(1e-12)
    got = tgrp.aero_totals(w, feats[:, :n].contiguous())
    torch.cuda.synchronize()
    assert got.shape == (6, n) and torch.isfinite(got).all()
    assert_rows_close(got.T, full[:n], scale)
    assert torch.equal(got, tgrp.aero_totals(w, feats)[:, :n])


def card_runner(tmp_path, n=64, mesh=None, **over):
    """A small F16SimRunner on the card (distilled backend, the fused step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.envs import ControlEnv
    from neuralplane_tpu_torch.runner import F16SimRunner
    cfg = RLConfig(buffer_size=8, data_chunk_length=8, num_mini_batch=2, ppo_epoch=2,
                   hidden_sizes=(32, 32), act_hidden_sizes=(32,),
                   recurrent_hidden_size=32, **over)
    env = ControlEnv(num_envs=n, config="heading", aero_backend="distilled", device="cuda")
    return F16SimRunner(env, cfg, run_dir=str(tmp_path), mesh=mesh)


@pytest.mark.cuda
def test_collect_launches_env_step_once_per_step(tmp_path):
    """Two 8-step collects through the fused step: 16 env_step launches,
    finite batches, and an update that changes the policy."""
    run = card_runner(tmp_path)
    carry = run.init_carry(run.next_seed())
    step_cuda.env_step.launches = 0
    for _ in range(2):
        carry, batch, _ = run.collect(carry)
    torch.cuda.synchronize()
    assert step_cuda.env_step.launches == 16
    assert batch.obs.is_cuda and torch.isfinite(batch.obs).all()
    assert torch.isfinite(batch.value_preds).all()
    before = run.policy.actor.mu.weight.detach().clone()
    metrics = run.train(batch)
    run.close()
    assert all(np.isfinite(v) for v in metrics.values())
    assert not torch.equal(before, run.policy.actor.mu.weight.detach())


@pytest.mark.cuda
def test_policy_on_card_matches_cpu(tmp_path):
    """The phase-15 check at a small size: actor and critic on the card
    against a CPU copy of the same modules, one step and one 8-step chunk of
    a collected batch, within 1e-4 of each output's RMS (float32, TF32 off)."""
    import copy
    run = card_runner(tmp_path, n=256)
    carry = run.init_carry(run.next_seed())
    _, batch, _ = run.collect(carry)
    run.close()
    assert not torch.backends.cuda.matmul.allow_tf32
    cpu = copy.deepcopy(run.policy).to("cpu")
    obs, masks = batch.obs[:8], batch.masks[:8]
    h_a, h_c = batch.rnn_states_actor[0], batch.rnn_states_critic[0]
    with torch.no_grad():
        pairs = [(run.policy.actor.step(obs[0], h_a, masks[0]),
                  cpu.actor.step(obs[0].cpu(), h_a.cpu(), masks[0].cpu())),
                 (run.policy.critic.step(obs[0], h_c, masks[0]),
                  cpu.critic.step(obs[0].cpu(), h_c.cpu(), masks[0].cpu())),
                 (run.policy.actor.seq(obs, h_a, masks),
                  cpu.actor.seq(obs.cpu(), h_a.cpu(), masks.cpu())),
                 (run.policy.critic.seq(obs, h_c, masks),
                  cpu.critic.seq(obs.cpu(), h_c.cpu(), masks.cpu()))]
    for card, host in pairs:
        for g, w in zip(card, host):
            rel = float((g.cpu().double() - w.double()).abs().max()
                        / w.double().pow(2).mean().sqrt().clamp_min(1e-12))
            assert rel < 1e-4


def planning_step_pair(n, inner=10, seed=3):
    """One high-level step of PlanningEnv("tracking", "distilled") from a
    carried state, with nlplant_distilled and with its plain version (same
    generator state and actions): ((state, out) kernel, (state, out) plain,
    kernel launches of the first)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import functools
    import os
    from neuralplane_tpu_torch.envs import PlanningEnv
    from neuralplane_tpu_torch.envs.planning import load_low_level_ckpt
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = PlanningEnv(num_envs=n, config=load_config("tracking", low_level_steps=inner),
                      aero_backend="distilled", device="cuda", low_level_params=load_low_level_ckpt(
                          os.path.join(repo, "results", "control", "policy_checkpoint.pkl")))
    rng = np.random.default_rng(seed)
    st, _ = env.reset(seed)
    st, _ = env.step(st, T(rng.uniform(-1, 1, (n, 3)).astype(np.float32)).cuda())
    a = T(rng.uniform(-1, 1, (n, 3)).astype(np.float32)).cuda()
    gen = env.generator.get_state()
    aero_cuda.nlplant_distilled.launches = step_cuda.env_step.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")   # the inner loop never waits for the card
    try:
        got = env.step(st, a)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = (aero_cuda.nlplant_distilled.launches, step_cuda.env_step.launches)
    env.generator.set_state(gen)
    env.model.dynamics = functools.partial(aero_cuda.nlplant_distilled_plain,
                                           env.model.weights)
    want = env.step(st, a)
    torch.cuda.synchronize()
    return got, want, launches


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 65, 1000])
def test_planning_step_kernel_matches_plain_on_card(n):
    """chip_smoke.py phase 18's check at a small size (10 inner steps): 20
    launches of nlplant_distilled and none of env_step per high-level step,
    no host sync; obs, state and h_low against the plain version, per column
    relative to its RMS: median within 1e-4, at most 5% of rows above 1e-3
    (10 chained steps; phase 18's 50 allow 25%), none above 1; flags on all
    but 1% of rows."""
    (gs, g), (ws, w), launches = planning_step_pair(n)
    assert launches == (20, 0)
    assert g.obs.shape == (n, 22) and torch.isfinite(g.obs).all()
    assert int(gs.env.step_count.min()) >= 10 and gs.env.model.s.shape == (n, 12)
    for got, want in ((g.obs, w.obs), (gs.env.model.s, ws.env.model.s),
                      (gs.h_low.reshape(n, -1), ws.h_low.reshape(n, -1))):
        scale = want.pow(2).mean(0).sqrt().clamp_min(1e-6)
        err = (got - want).abs() / scale
        assert err.median(0).values.max() < 1e-4 and err.max() < 1.0
        assert (err > 1e-3).float().mean(0).max() <= max(5e-2, 1.0 / n)
    for f in ("done", "bad_done", "exceed_time_limit"):
        assert (getattr(g, f) != getattr(w, f)).float().mean() <= max(1e-2, 1.0 / n)


def combat_step_pair(cls, n_envs, seed=5):
    """One combat step on "distilled" from a state two steps in, with
    nlplant_distilled and with its plain version (same generator state and
    actions): ((state, out) kernel, (state, out) plain, (xdot kernel
    launches, env_step launches) of the first), the first under the sync
    debug mode. The missile envs get ShootTuple actions, the bit on half
    the rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import functools
    env = cls(n_envs, aero_backend="distilled", device="cuda")
    rng = np.random.default_rng(seed)
    nvec = getattr(getattr(env, "action_space", None), "nvec", None)

    def act():
        if nvec is None:
            return T(rng.uniform(-1, 1, (env.n, 4)).astype(np.float32)).cuda()
        a = np.concatenate([rng.integers(0, nvec, (env.n, 4)), rng.random((env.n, 1)) < 0.5],
                           axis=1)
        return T(a.astype(np.float32)).cuda()
    st, _ = env.reset(seed)
    for _ in range(2):
        st, _ = env.step(st, act())
    a = act()
    gen = env.generator.get_state()
    aero_cuda.nlplant_distilled.launches = step_cuda.env_step.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")   # the step never waits for the card
    try:
        got = env.step(st, a)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = (aero_cuda.nlplant_distilled.launches, step_cuda.env_step.launches)
    env.generator.set_state(gen)
    env.model.dynamics = functools.partial(aero_cuda.nlplant_distilled_plain,
                                           env.model.weights)
    want = env.step(st, a)
    torch.cuda.synchronize()
    return got, want, launches


@pytest.mark.cuda
@pytest.mark.parametrize("team", [False, True])
@pytest.mark.parametrize("n_envs", [1, 33, 500])
def test_combat_step_kernel_matches_plain_on_card(team, n_envs):
    """chip_smoke.py phase 20's check at small sizes: a 1v1 step launches
    nlplant_distilled 11 times, a team step 3 times, env_step never, with
    no host sync; obs, state and reward against the plain version, per
    column relative to its RMS: median within 1e-4, at most 5% of rows
    above 1e-3, none above 1; flags on all but 1% of rows."""
    from neuralplane_tpu_torch.envs import MultipleCombatEnv, SingleCombatEnv
    cls = MultipleCombatEnv if team else SingleCombatEnv
    (gs, g), (ws, w), launches = combat_step_pair(cls, n_envs)
    assert launches == ((3 if team else 11), 0)
    n = gs.model.s.shape[0]
    assert g.obs.shape == (n, 30 if team else 15) and torch.isfinite(g.obs).all()
    for got, want in ((g.obs, w.obs), (gs.model.s, ws.model.s), (g.reward, w.reward)):
        scale = want.reshape(n, -1).pow(2).mean(0).sqrt().clamp_min(1e-6)
        err = (got - want).reshape(n, -1).abs() / scale
        assert err.median(0).values.max() < 1e-4 and err.max() < 1.0
        assert (err > 1e-3).float().mean(0).max() <= max(5e-2, 1.0 / n)
    for f in ("done", "bad_done", "exceed_time_limit"):
        assert (getattr(g, f) != getattr(w, f)).float().mean() <= max(1e-2, 1.0 / n)


@pytest.mark.cuda
@pytest.mark.parametrize("team", [False, True])
@pytest.mark.parametrize("n_envs", [1, 33, 500])
def test_shoot_step_kernel_matches_plain_on_card(team, n_envs):
    """chip_smoke.py phase 23's check at small sizes, on the missile envs:
    11 (1v1) or 3 (team) nlplant_distilled launches, env_step none, no host
    sync; obs, state, reward and missile positions against the plain
    version as the combat test holds them; ammo, cooldown and the active
    slots on all but 1% of rows."""
    from neuralplane_tpu_torch.envs import MultipleCombatShootEnv, SingleCombatShootEnv
    cls = MultipleCombatShootEnv if team else SingleCombatShootEnv
    (gs, g), (ws, w), launches = combat_step_pair(cls, n_envs)
    assert launches == ((3 if team else 11), 0)
    n = gs.model.s.shape[0]
    assert g.obs.shape == (n, 33 if team else 18) and torch.isfinite(g.obs).all()
    for got, want in ((g.obs, w.obs), (gs.model.s, ws.model.s), (g.reward, w.reward),
                      (gs.missiles.pos, ws.missiles.pos)):
        scale = want.reshape(n, -1).pow(2).mean(0).sqrt().clamp_min(1e-6)
        err = (got - want).reshape(n, -1).abs() / scale
        assert err.median(0).values.max() < 1e-4 and err.max() < 1.0
        assert (err > 1e-3).float().mean(0).max() <= max(5e-2, 1.0 / n)
    for got, want in ((gs.ammo, ws.ammo), (gs.cooldown, ws.cooldown),
                      (gs.missiles.active, ws.missiles.active), (g.done, w.done)):
        assert (got != want).reshape(n, -1).any(1).float().mean() <= max(1e-2, 1.0 / n)


@pytest.mark.cuda
def test_mappo_collect_makes_no_host_sync(tmp_path):
    """A MAPPO self-play collect on the 2v2 missile env (33 envs, the shoot
    head with its prior, a frozen opponent) under CUDA's sync debug mode
    'error': no step reads back to the host; 3 nlplant_distilled launches
    per step, env_step none; finite shared batch on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.envs import MultipleCombatShootEnv
    from neuralplane_tpu_torch.runner import MAPPOSelfplayRunner
    env = MultipleCombatShootEnv(33, aero_backend="distilled", device="cuda")
    cfg = RLConfig(buffer_size=4, data_chunk_length=2, hidden_sizes=(32,),
                   act_hidden_sizes=(32,), recurrent_hidden_size=32, use_prior=True)
    run = MAPPOSelfplayRunner(env, cfg, run_dir=str(tmp_path))
    carry, _, _ = run.collect(run.init_carry(3))   # warm-up
    aero_cuda.nlplant_distilled.launches = step_cuda.env_step.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry, batch, counters = run.collect(carry)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    run.close()
    assert (aero_cuda.nlplant_distilled.launches, step_cuda.env_step.launches) == (12, 0)
    assert batch.share_obs.is_cuda and batch.share_obs.shape == (5, 66, 66)
    assert torch.isfinite(batch.value_preds).all() and torch.isfinite(batch.obs).all()
    assert {"done_count", "shoot_launches", "shoot_hits", "shoot_pk_sum"} <= set(counters)


@pytest.mark.cuda
def test_xdot_kernel_on_freshly_distilled_weights(tmp_path, monkeypatch):
    """A few distillation steps at the kernels' width (H = 256) on the card,
    written by to_npz and read back by load_distilled: nlplant_distilled on
    those weights against its plain version, and the gate's R^2 finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from neuralplane_tpu_torch.surrogates import distill
    monkeypatch.setattr(distill, "STATS_SAMPLES", 1 << 14)
    w43 = taero.load_aero_weights(device="cuda")
    params, mean, std = distill.fit(w43, hidden=256, steps=20, batch=4096, log_every=0)
    path = str(tmp_path / "fresh.npz")
    distill.to_npz(path, params, mean, std, {})
    w = taero.load_distilled(path, device="cuda")
    s, u = (T(x).cuda() for x in envelope(11, 4099))
    for hidden_bf16 in (True, False):
        assert_kernel_close(aero_cuda.nlplant_distilled(w, s, u, hidden_bf16),
                            aero_cuda.nlplant_distilled_plain(w, s, u, hidden_bf16))
    fid = distill.xdot_fidelity(w43, params, mean, std, n=4096)
    assert np.isfinite(fid["xdot_r2"]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shoot", [False, True])
def test_export_on_the_card(shoot):
    """The exported actor on the card against the live policy's
    deterministic act, at several batch sizes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from neuralplane_tpu_torch.algorithms.ppo import PPOPolicy
    from neuralplane_tpu_torch.algorithms.rl_config import RLConfig
    from neuralplane_tpu_torch.algorithms.utils.spaces import ShootTuple
    from neuralplane_tpu_torch.utils.export import export_actor, load_actor
    if shoot:
        pol = PPOPolicy(RLConfig(use_prior=True), 18, act_space=ShootTuple((30, 41, 41, 41)),
                        device="cuda")
    else:
        pol = PPOPolicy(RLConfig(), 22, 4, device="cuda")
    infer = load_actor(export_actor(pol))
    g = torch.Generator(device="cuda").manual_seed(0)
    for n in (1, 5, 64, 1000):
        obs = torch.randn((n, pol.spec.obs_dim), generator=g, device="cuda").abs()
        h, _ = pol.init_rnn_states(n)
        h = torch.randn(h.shape, generator=g, device="cuda") * 0.1
        mask = torch.ones((n, 1), device="cuda")
        with torch.no_grad():
            a_ref, h_ref = pol.act(obs, h, mask)
        a, h2 = infer(obs, h, mask)
        assert a.is_cuda and torch.allclose(a, a_ref, rtol=1e-6, atol=1e-6)
        assert torch.allclose(h2, h_ref, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_world_one_nccl_mesh_is_the_run_without_one(tmp_path):
    """The backend rule picks NCCL for one rank with a card of its own; a
    world-1 NCCL group's mesh runs the collect and update of the run without
    a mesh bit for bit, and closing the runner destroys the group."""
    import socket
    import torch.distributed as dist
    from neuralplane_tpu_torch.parallel import card_id, choose_backend, make_mesh
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL runs on the card")
    assert choose_backend([card_id("cuda:0")]) == "nccl"
    runs = []
    for name in ("plain", "mesh"):
        mesh = None
        if name == "mesh":
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                    world_size=1, rank=0)
            mesh = make_mesh("cuda", owns_group=True)
        run = card_runner(tmp_path / name, mesh=mesh)
        _, batch, _ = run.collect(run.init_carry(run.next_seed()))
        metrics = run.train(batch)
        run.close()
        runs.append((run, metrics, mesh))
    (plain, m_plain, _), (meshed, m_mesh, mesh) = runs
    assert m_plain == m_mesh
    for (k, a), b in zip(plain.policy.state_dict().items(), meshed.policy.state_dict().values()):
        assert torch.equal(a, b), k
    assert mesh.stats["all_reduce_calls"] > 0 and not dist.is_initialized()


@pytest.mark.cuda
def test_measured_shoot_step_on_the_43_nets():
    """measure_combat_step on the 1v1 missile env with aero_backend="pallas"
    (chip_smoke.py phase 34(d) at a small size): nlplant_grouped launches 11
    times per step (plus one at the reset), nlplant_distilled and env_step
    never; one more step from the measured state, held high, against the
    same step with the plain 43-net xdot, as the shoot test holds it."""
    import functools
    from neuralplane_tpu_torch.measure import measure_combat_step
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    kernels = (tgrp.nlplant_grouped, aero_cuda.nlplant_distilled, step_cuda.env_step)
    for k in kernels:
        k.launches = 0
    r = measure_combat_step(1000, steps=5, env_name="SingleCombatShoot", aero_backend="pallas")
    assert [k.launches for k in kernels] == [1 + 11 * 6, 0, 0]
    assert r["n"] == 1000 and r["finite"] and r["device"] == torch.cuda.get_device_name()
    env, st = r["env_obj"], r["state"]
    assert isinstance(env.model.weights, taero.GroupedAeroWeights)
    a = torch.tensor([[20.0, 20.0, 20.0, 20.0, 1.0]], device="cuda").repeat(env.n, 1)
    gen = env.generator.get_state()
    gs, g = env.step(st, a)
    env.generator.set_state(gen)
    env.model.dynamics = functools.partial(tgrp.nlplant_grouped_plain, env.model.weights)
    ws, w = env.step(st, a)
    torch.cuda.synchronize()
    n = env.n
    for got, want in ((g.obs, w.obs), (gs.model.s, ws.model.s), (g.reward, w.reward),
                      (gs.missiles.pos, ws.missiles.pos)):
        scale = want.reshape(n, -1).pow(2).mean(0).sqrt().clamp_min(1e-6)
        err = (got - want).reshape(n, -1).abs() / scale
        assert err.median(0).values.max() < 1e-4 and err.max() < 1.0
        assert (err > 1e-3).float().mean(0).max() <= 5e-2
    for got, want in ((gs.ammo, ws.ammo), (gs.cooldown, ws.cooldown),
                      (gs.missiles.active, ws.missiles.active), (g.done, w.done)):
        assert (got != want).reshape(n, -1).any(1).float().mean() <= 1e-2
