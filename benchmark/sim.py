"""Traffic of kind "sim": the simulator alone. `aircraft` aircraft step in
lockstep through `ControlEnv.step`, no policy; the actions come from a
bank of `action_bank` uniform draws in [-1, 1] made on the device from the
seed at set-up and cycled, so the window holds no draw of the benchmark's.
Episodes end and reset inside the env as they do in training.

Set-up builds the env, resets it from the seed and runs `warmup_steps`
steps (the first builds or loads the kernels). The window steps until
`--seconds` have passed and ends in a synchronize; in a traced run the
profiler covers its first `trace_seconds`. At `check_steps` pairs
of consecutive steps, drawn from the seed among the window's first
`check_within`, it keeps `check_rows` rows (drawn from the seed) of what
the step read and produced, for the reference once the window has closed.
"""
from __future__ import annotations

import os
import time

import torch

from . import judge, program, trace
from .harness import ROOT
from .reference import step as ref_step


class SimRun:
    def __init__(self, cell: dict, seed: int, device="cuda"):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.n = int(self.traffic["aircraft"])

    # ---- set-up ----
    def setup(self) -> None:
        tr, dev = self.traffic, self.device
        self.env = program.make_env(self.config, self.n, dev)
        self.state, _ = self.env.reset(self.seed)
        g = torch.Generator(device=dev).manual_seed(self.seed)
        self.bank = torch.rand((int(tr["action_bank"]), self.n, self.env.num_actions),
                               generator=g, device=dev) * 2.0 - 1.0
        m = min(self.n, int(tr["check_rows"]))
        self.rows = torch.randperm(self.n, generator=g, device=dev)[:m].sort().values
        starts = torch.randperm(int(tr["check_within"]) // 2, generator=g,
                                device=dev)[:int(tr["check_steps"])] * 2
        self.check_at = sorted({int(k) + d for k in starts.tolist() for d in (0, 1)})
        for k in range(int(tr["warmup_steps"])):
            self.state, _ = self.env.step(self.state, self.bank[k % len(self.bank)])
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ---- window ----
    def window(self, seconds: float, tracer=None) -> dict:
        """Steps until `seconds` have passed (and every kept step is done).
        With a tracer the profiler covers `trace_seconds` of steps from its
        start, and untraced steps follow for the rest of `seconds`: the
        profiler slows the host, so the device's work per step is read in
        its stretch and the time a step takes in the rest."""
        self.kept, self.k = {}, 0
        self._sync()
        t0 = time.perf_counter()
        w = {}
        if tracer is not None:
            traced = float(self.traffic["trace_seconds"])
            with tracer.record():
                with trace.span("step"):
                    self._steps(time.perf_counter(), traced)
            t1 = t0 = time.perf_counter()
            k1 = w["traced_steps"] = self.k
            seconds = max(0.0, seconds - traced)
        self._steps(t0, seconds)
        self._sync()
        w.update(steps=self.k, window_s=time.perf_counter() - t0, work=self.n * self.k)
        if tracer is not None:
            w.update(untraced_steps=self.k - k1, untraced_s=time.perf_counter() - t1)
        return w

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _steps(self, t0: float, seconds: float) -> None:
        """Step until `seconds` after t0, and past the last kept step."""
        env, bank, rows = self.env, self.bank, self.rows
        checks, last = set(self.check_at), max(self.check_at)
        state, k = self.state, self.k
        while k <= last or time.perf_counter() - t0 < seconds:
            a = bank[k % len(bank)]
            if k in checks:
                x = program.snap_inputs(env, state, a, rows)
                state, out = env.step(state, a)
                self.kept[k] = (x, program.snap_outputs(env, state, out, rows))
            else:
                state, out = env.step(state, a)
            k += 1
        self.state, self.k = state, k

    def end_to_end(self, w: dict) -> dict:
        return {"sim_agent_steps_per_s": w["work"] / w["window_s"]}

    def context(self, w: dict, tracer) -> dict:
        return {"kind": "sim", "config": self.config, "aircraft": self.n, "trace": tracer,
                **{k: w[k] for k in ("traced_steps", "untraced_steps", "untraced_s") if k in w}}

    def release(self) -> None:
        for name in ("env", "state", "bank"):
            self.__dict__.pop(name, None)

    # ---- the comparison ----
    def numbers(self, mode: str = "program") -> dict:
        """The cell's compared numbers. `mode` "program" judges the kept
        outputs; "control" puts the reference at float8 surrogate operands
        in the program's place; "fault:unchanged" a step that returns its
        state unchanged, "fault:altered" every eighth reward altered."""
        cfg = self.config
        w = ref_step.load_surrogate(cfg["surrogate"]["kind"],
                                    os.path.join(ROOT, cfg["surrogate"]["file"]), self.device)
        pairs = []
        for k in self.check_at:
            x, y = self.kept[k]
            ref = ref_step.step_rows(cfg["task"], cfg["scenario"], cfg["surrogate"]["kind"], w,
                                     x["x"], x["gen_state"], self.n, self.rows)
            pairs.append((fault_outputs(mode, x["x"], y, lambda: ref_step.step_rows(
                cfg["task"], cfg["scenario"], cfg["surrogate"]["kind"], w, x["x"],
                x["gen_state"], self.n, self.rows, precision="fp8")), ref))
        out = judge.step_numbers(pairs)
        chains = [(self.kept[k][1], self.kept[k + 1][0]["x"]) for k in self.check_at
                  if k + 1 in self.kept]
        out.update(judge.carry_numbers(chains))
        return out


def fault_outputs(mode: str, x: dict, y: dict, control) -> dict:
    """The outputs judged in `mode` (see SimRun.numbers)."""
    if mode == "program":
        return y
    if mode == "control":
        return control()
    y = dict(y)
    if mode == "fault:unchanged":
        y["sf"], y["uf"] = x["sf"], x["uf"]
    elif mode == "fault:altered":
        r = y["reward"].clone()
        r[::8] += 1.0
        y["reward"] = r
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return y
