"""The comparison that decides `correct`: the program's outputs, kept from
its timed path, against the reference's, computed once the window has
closed, as the numbers each cell's limits file bounds.

Env steps (`step_numbers`): per output column of the sampled rows, the
gap |program - reference| relative to a scale: for the state and the
controls the RMS of the reference's change over the step (so that an
error in the step's derivative shows at its own size, not at the state's),
for the observation, the targets and the reward (where both sides agree on
the flags) the RMS of the reference's column.
  step_err   the largest over columns of the column's median gap;
  rows_off   the share of rows with any gap above ROW_TOL, or a done, bad
             or step count that differs;
  carry_off  the share of rows whose state, as the next step read it,
             differs at all from what the step before produced (exact).

Policy forward (`forward_numbers`): fwd_err, the larger of the median gaps
of log-probabilities and values, each relative to the reference's RMS.

Update (`update_numbers`), the first three optimizer steps that set-up
drove: loss_gap, the largest relative gap of a step's loss; grad_gap, of
the first gradient as Adam got it (its first moment after one step over
0.1), and change_gap, of each leaf's change over the three steps, both by
the worst leaf: |norm(program) - norm(reference)| over the larger of the
reference leaf's norm and the median leaf's. Leaves whose reference
gradient is under 1e-3 of the median leaf's move under Adam by round-off
alone and are left out of change_gap.
"""
from __future__ import annotations

from typing import Dict, List

import torch

ROW_TOL = 1e-3
SMALL_LEAF = 1e-3


def _rms(x: torch.Tensor) -> torch.Tensor:
    return x.double().pow(2).mean().sqrt()


def _gap(g: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    d = (g.double() - w.double()).abs()
    s = scale.double()
    return torch.where(d == 0, torch.zeros_like(d), d / s.clamp_min(1e-30))


def step_gaps(prog: Dict, ref: Dict):
    """(per-column gaps [c, m], rows with a flag or step count off [m])."""
    flags = (prog["done"] != ref["done"]) | (prog["bad"] != ref["bad"]) \
        | (prog["step_count"] != ref["step_count"])
    cols = []
    for i in range(ref["sf"].shape[0]):
        cols.append(_gap(prog["sf"][i], ref["sf"][i], _rms(ref["ds"][i])))
    for i in range(ref["uf"].shape[0]):
        cols.append(_gap(prog["uf"][i], ref["uf"][i], _rms(ref["du"][i])))
    for j in range(ref["obs"].shape[1]):
        cols.append(_gap(prog["obs"][:, j], ref["obs"][:, j], _rms(ref["obs"][:, j])))
    for i in range(3):
        cols.append(_gap(prog[f"tg{i}"], ref[f"tg{i}"], _rms(ref[f"tg{i}"])))
    agree = ~flags
    r = _gap(prog["reward"], ref["reward"], _rms(ref["reward"][agree]) if agree.any()
             else torch.ones((), device=agree.device))
    cols.append(torch.where(agree, r, torch.zeros_like(r)))
    return torch.stack(cols), flags


def step_numbers(pairs: List, prefix: str = "") -> Dict[str, float]:
    """step_err and rows_off over the sampled steps' rows; `pairs` holds
    (program outputs, reference outputs) per sampled step."""
    gaps, flags = zip(*(step_gaps(p, r) for p, r in pairs))
    gaps, flags = torch.cat(gaps, dim=1), torch.cat(flags)
    off = flags | (gaps > ROW_TOL).any(dim=0)
    return {f"{prefix}step_err": float(gaps.median(dim=1).values.max()),
            f"{prefix}rows_off": float(off.double().mean())}


def carry_numbers(chains: List, prefix: str = "") -> Dict[str, float]:
    """carry_off over pairs (outputs of step k, inputs of step k + 1)."""
    off = []
    for y, x in chains:
        bad = (y["step_count"] != x["step_count"]) | (y["done"] != x["is_done"]) \
            | (y["bad"] != x["bad_done"]) | x["exceed"]
        for k in ("sf", "uf"):
            bad = bad | (y[k] != x[k]).any(dim=0)
        for i in range(3):
            bad = bad | (y[f"tg{i}"] != x[f"tg{i}"])
        off.append(bad)
    return {f"{prefix}carry_off": float(torch.cat(off).double().mean())}


def forward_numbers(prog_logp, prog_values, ref_logp, ref_values) -> Dict[str, float]:
    e1 = _gap(prog_logp, ref_logp, _rms(ref_logp)).median()
    e2 = _gap(prog_values, ref_values, _rms(ref_values)).median()
    return {"fwd_err": float(torch.maximum(e1, e2))}


def _leaf_gaps(prog: Dict, ref: Dict, keep=None) -> float:
    names = [n for n in ref if keep is None or n in keep]
    pn = {n: float(prog[n].double().norm()) for n in names}
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = float(torch.tensor([rn[n] for n in ref]).median())
    return max(abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in names)


def update_numbers(prog: Dict, ref: Dict, p0: Dict) -> Dict[str, float]:
    """prog/ref: {"losses": [3], "grad1": {leaf: tensor}, "params": {leaf:
    tensor after the third step}}; p0 the parameters before the first."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    g_norms = {n: float(g.double().norm()) for n, g in ref["grad1"].items()}
    med = float(torch.tensor(list(g_norms.values())).median())
    moving = {n for n, v in g_norms.items() if v >= SMALL_LEAF * med}
    d_prog = {n: prog["params"][n] - p0[n] for n in p0}
    d_ref = {n: ref["params"][n] - p0[n] for n in p0}
    return {"loss_gap": loss_gap, "grad_gap": _leaf_gaps(prog["grad1"], ref["grad1"]),
            "change_gap": _leaf_gaps(d_prog, d_ref, keep=moving)}
