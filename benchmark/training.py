"""Traffic of kind "train": PPO training at the configuration's envs and
buffer, `F16SimRunner.collect` then `F16SimRunner.train`, repeated; no
checkpoint, evaluation or metrics line is written.

Set-up builds the env and the runner, loads the policy's weights made from
the seed on the device (`reference.policy.make_params`), and drives one
whole iteration through the same calls the window makes: the warm-up. The
window then runs whole iterations back to back from its start and ends at
the first iteration boundary at or after `--seconds`, with a synchronize.

Kept for the comparison: of the warm-up's update and of the window's first
update, the rollout batch (copied to the host), the generator's state
before the update and, of their first three optimizer steps, the
parameters and Adam's moments and step count before the first, each
step's loss, Adam's first moment after the first and the parameters after
the third (`_watch_update`: a wrapper around the trainer's minibatch step,
in place for the whole run, that keeps these only when armed); of the
window's first collect, `check_env_steps` env steps (drawn from the seed,
every env) and, of `check_envs` envs (drawn from the seed), the collected
observations, actions, log-probs, values, masks and recurrent states with
the parameters that produced them.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict

import torch

from . import judge, program, trace
from .harness import ROOT
from .reference import policy as ref_policy
from .reference import step as ref_step

BATCH_KEYS = ("obs", "actions", "rewards", "masks", "bad_masks", "action_log_probs",
              "value_preds")


class TrainRun:
    def __init__(self, cell: dict, seed: int, device="cuda"):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.config, self.traffic = cell["config"], cell["traffic"]
        c = self.config
        self.n, self.T, self.L = c["n_rollout_threads"], c["buffer_size"], c["data_chunk_length"]

    # ---- set-up ----
    def setup(self) -> None:
        from neuralplane_tpu_torch.runner import F16SimRunner
        dev = self.device
        self.env = program.make_env(self.config, self.n, dev, program.recording_env_class())
        self.env.rows = torch.arange(self.n, device=dev)
        self.obs_dim, self.act_dim = self.env.num_observation, self.env.num_actions
        self.run_dir = tempfile.TemporaryDirectory(prefix="bench-run-")
        self.runner = F16SimRunner(self.env, program.rl_config(self.config, self.seed),
                                   run_dir=self.run_dir.name)
        spec = ref_policy.param_spec(self.config["networks"], self.obs_dim, self.act_dim)
        self.runner.policy.load_state_dict(ref_policy.make_params(spec, self.seed, dev),
                                           strict=True)
        self.carry = self.runner.init_carry(self.runner.next_seed())
        g = torch.Generator(device=dev).manual_seed(self.seed)
        tr = self.traffic
        self.fwd_envs = torch.randperm(self.n, generator=g, device=dev)[:int(tr["check_envs"])]
        env_steps = torch.randperm(self.T, generator=g, device=dev)[:int(tr["check_env_steps"])]
        # the window's first collect is the env's second T steps
        self.env.armed = {self.T + int(t) for t in env_steps.tolist()}
        self._watch_update()
        self._warmup()

    def _watch_update(self) -> None:
        """Wrap the trainer's minibatch step for the whole run. Armed with
        a dict (`self.armed`), its first `check_update_steps` steps keep:
        before the first, the optimizer's state (`_state`); each step's
        loss; Adam's first moment after the first step; the parameters
        after the last. Device copies only: nothing waits on the card."""
        trainer, upd = self.runner.trainer, self.config
        steps = int(self.traffic["check_update_steps"])
        orig = trainer._update_minibatch
        self.armed = None

        def update_minibatch(sample):
            kept = self.armed
            if kept is None:
                return orig(sample)
            k = len(kept["losses"]) + 1
            if k == 1:
                kept.update(self._state())
            out = orig(sample)
            kept["losses"].append(out["policy_loss"]
                                  + out["value_loss"] * upd["value_loss_coef"]
                                  + out["policy_entropy_loss"] * upd["entropy_coef"])
            if k == 1:
                kept["m1"] = self._state()["m0"]
            if k == steps:
                kept["params"] = self._state()["p0"]
                self.armed = None
            return out
        trainer._update_minibatch = update_minibatch

    def _state(self) -> dict:
        """Copies of the parameters (p0), Adam's moments (m0, v0) and its
        step count (step0); an optimizer that kept no state gives zeros."""
        policy, state = self.runner.policy, self.runner.trainer.optimizer.state
        leaves = list(policy.named_parameters())

        def adam(key):
            return {n: (state[p][key].detach().clone() if key in state[p]
                        else torch.zeros_like(p)) for n, p in leaves}
        p0 = leaves[0][1]
        return {"p0": {n: p.detach().clone() for n, p in leaves}, "m0": adam("exp_avg"),
                "v0": adam("exp_avg_sq"),
                "step0": state[p0]["step"].clone() if "step" in state[p0] else torch.zeros(())}

    def _arm(self, batch, host: Dict[str, torch.Tensor]) -> dict:
        """Copy the batch into `host` (in stream order: nothing waits), note
        the generator's state and arm the wrapper for the update that
        follows; returns what the update will keep."""
        for k, t in _batch_tensors(batch).items():
            host[k].copy_(t, non_blocking=True)
        self.armed = {"losses": [], "gen": self.runner.generator.get_state(), "batch": host}
        return self.armed

    def _warmup(self) -> None:
        runner = self.runner
        self.carry, batch, _ = runner.collect(self.carry)
        pin = self.device.type == "cuda"
        hosts = [{k: torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                  for k, t in _batch_tensors(batch).items()} for _ in range(2)]
        self.warm_kept = self._arm(batch, hosts[0])
        self.win_host = hosts[1]
        runner.train(batch)
        # the state the window's first update has to start from
        self.warm_end = self._state()
        del batch
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ---- window ----
    def window(self, seconds: float, tracer=None) -> dict:
        """Whole iterations until `seconds` have passed. With a tracer the
        first iteration is profiled, every collect and update is timed
        between synchronizes (spans the per-layer metrics read), and
        untraced iterations follow it for `seconds`: the profiler slows the
        host, so the layers' times are read there."""
        runner = self.runner
        sync = tracer is not None
        self.collect_s, self.update_s = [], []
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        it = 0
        while True:
            with (tracer.record() if tracer is not None and it == 0 else contextlib.nullcontext()):
                with trace.span("collect", self.collect_s, sync):
                    self.carry, batch, _ = runner.collect(self.carry)
                if it == 0:
                    self._keep_forward(batch)
                    self.win_kept = self._arm(batch, self.win_host)
                with trace.span("update", self.update_s, sync):
                    runner.train(batch)
            del batch
            if it == 0 and tracer is not None:
                t0 = time.perf_counter()
            it += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        return {"iterations": it, "window_s": window_s, "work": it * self.T * self.n}

    def _keep_forward(self, batch) -> None:
        cols = self.fwd_envs
        self.fwd = {k: getattr(batch, k)[:, cols] for k in BATCH_KEYS}
        self.fwd["h0_actor"] = batch.rnn_states_actor[:, cols]
        self.fwd["h0_critic"] = batch.rnn_states_critic[:, cols]
        self.fwd["params"] = {n: p.detach().clone()
                              for n, p in self.runner.policy.named_parameters()}

    def end_to_end(self, w: dict) -> dict:
        return {"train_agent_steps_per_s": w["work"] / w["window_s"]}

    def context(self, w: dict, tracer) -> dict:
        return {"kind": "train", "config": self.config, "iterations": w["iterations"],
                "window_s": w["window_s"], "trace": tracer, "T": self.T, "n": self.n,
                "obs_dim": self.obs_dim, "act_dim": self.act_dim,
                "collect_s": self.collect_s, "update_s": self.update_s}

    def release(self) -> None:
        self.kept_env = list(self.env.records)
        self.runner.close()
        for name in ("runner", "env", "carry"):
            self.__dict__.pop(name, None)
        self.run_dir.cleanup()

    # ---- the comparison ----
    def numbers(self, mode: str = "program") -> dict:
        """The cell's compared numbers. `mode` "program" judges what the
        program kept; "control" puts the reference in its place with float8
        surrogate operands and TF32 network products; "fault:unchanged" an
        optimizer step that leaves the parameters as they were,
        "fault:half" each minibatch's mean over half of its rows,
        "fault:altered" every eighth reward of the env step altered."""
        from .sim import fault_outputs
        cfg, dev = self.config, self.device
        net = cfg["networks"]
        out = {}
        # env steps of the window's first collect
        w = ref_step.load_surrogate(cfg["surrogate"]["kind"],
                                    os.path.join(ROOT, cfg["surrogate"]["file"]), dev)
        rows = torch.arange(self.n, device=dev)
        pairs = []
        for _, x, y in self.kept_env:
            def ref(precision="bf16", x=x):
                return ref_step.step_rows(cfg["task"], cfg["scenario"], cfg["surrogate"]["kind"],
                                          w, x["x"], x["gen_state"], self.n, rows, precision)
            pairs.append((fault_outputs("program" if mode in ("fault:unchanged", "fault:half")
                                        else mode, x["x"], y, lambda: ref("fp8")), ref()))
        out.update(judge.step_numbers(pairs, prefix="env_"))
        # the policy's forward over the window's first collect
        f = self.fwd
        logp_ref, v_ref = self._forward(f, "float32")
        if mode == "control":
            logp_p, v_p = self._forward(f, "tf32")
        else:
            logp_p, v_p = f["action_log_probs"], f["value_preds"][:self.T]
        out.update(judge.forward_numbers(logp_p, v_p, logp_ref, v_ref))
        # the first optimizer steps of the warm-up's update, from the start
        # the reference works out itself (the weights from the seed, Adam
        # empty), and of the window's first update, from the program's state
        spec = ref_policy.param_spec(net, self.obs_dim, self.act_dim)
        start = {"p0": ref_policy.make_params(spec, self.seed, dev), "m0": None, "v0": None,
                 "step0": 0}
        out.update(self._update_numbers(mode, self.warm_kept, start, ""))
        out.update(self._update_numbers(mode, self.win_kept, None, "win_"))
        out["update_carry_off"] = self._carry_off(mode)
        return out

    def _carry_off(self, mode: str) -> float:
        """The share of leaves whose parameter or Adam moment, as the
        window's first update found it, differs at all from what the
        warm-up's update left (exact); 1 where Adam's step count differs.
        "fault:unchanged" leaves Adam's state as it was before the warm-up."""
        end, start = self.warm_end, self.win_kept
        if "p0" not in start:
            return float("inf")
        if mode == "fault:unchanged":
            start = dict(self.warm_kept, p0=start["p0"])
        if int(end["step0"]) != int(start["step0"]):
            return 1.0
        off = [not torch.equal(end[k][n], start[k][n]) for k in ("p0", "m0", "v0")
               for n in end["p0"]]
        return sum(off) / len(off)

    def _update_numbers(self, mode: str, kept: dict, start, prefix: str) -> dict:
        """loss_gap, grad_gap and change_gap of the first optimizer steps of
        the update `kept` watched. `start` is where the reference begins
        (parameters, Adam's moments and step count); None takes the
        program's state as the update found it."""
        cfg, dev = self.config, self.device
        steps = int(self.traffic["check_update_steps"])
        if "params" not in kept:
            # the update took fewer minibatch steps than are compared
            return {prefix + k: float("inf") for k in ("loss_gap", "grad_gap", "change_gap")}
        if start is None:
            start = {k: kept[k] for k in ("p0", "m0", "v0")}
            start["step0"] = int(kept["step0"])
        p0 = start["p0"]
        batch = {k: v.to(dev) for k, v in kept["batch"].items()}

        def follow(precision="float32", half=False):
            losses, grad1, params = ref_policy.update_steps(
                p0, cfg["networks"], cfg, batch, _generator(kept["gen"], dev), steps,
                precision, half, m0=start["m0"], v0=start["v0"], step0=start["step0"])
            return {"losses": losses, "grad1": grad1, "params": params}
        ref = follow()
        if mode == "program" or mode == "fault:altered":
            # Adam's first moment after one step is 0.9 x the one before it
            # + 0.1 x the gradient it got
            prog = {"losses": [float(v) for v in kept["losses"]],
                    "grad1": {n: (kept["m1"][n] - 0.9 * kept["m0"][n]) / 0.1 for n in kept["m1"]},
                    "params": kept["params"]}
        elif mode == "control":
            prog = follow("tf32")
        elif mode == "fault:half":
            prog = follow(half=True)
        elif mode == "fault:unchanged":
            prog = dict(ref, params=p0)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        return {prefix + k: v for k, v in judge.update_numbers(prog, ref, p0).items()}

    def _forward(self, f: dict, precision: str):
        """Log-probs and values [T, m, 1] the reference gives the kept
        envs' collect, chunk by chunk from each chunk's recorded recurrent
        states; the collect zeroes a recurrent state after any done or bad
        flag, so the step's mask is masks x bad_masks."""
        net, L, T = self.config["networks"], self.L, self.T
        masks = f["masks"][:T] * f["bad_masks"][:T]
        logps, values = [], []
        with torch.no_grad():
            for c in range(T // L):
                sl = slice(c * L, (c + 1) * L)
                v, lp, _ = ref_policy.evaluate(f["params"], net, f["obs"][sl], f["h0_actor"][c],
                                               f["h0_critic"][c], f["actions"][sl], masks[sl],
                                               precision)
                logps.append(lp)
                values.append(v)
        return torch.cat(logps), torch.cat(values)


def _batch_tensors(batch) -> Dict[str, torch.Tensor]:
    """The rollout batch's tensors the update reads, by the reference's names."""
    out = {k: getattr(batch, k) for k in BATCH_KEYS}
    out["h0_actor"], out["h0_critic"] = batch.rnn_states_actor, batch.rnn_states_critic
    return out


def _generator(state: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g
