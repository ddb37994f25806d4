"""The numbers that decide ``correct`` for a training cell.

Set-up drives the program from the seed through its first steps (the
window's own call); the reference follows the same steps from the same
inputs.  Three numbers, each held to a limit of its own:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``first_change_gap``: the worst leaf's gap between the norms of the
  program's and the reference's change after the first step (the first
  update as the state shows it);
- ``change_gap``: the same for the change after the last checked step.

A leaf's gap is ``|‖Δp‖ − ‖Δr‖|`` over the larger of the reference's
``‖Δr‖`` of that leaf and of the median leaf.  Leaves whose first change
in the reference is under a thousandth of the median leaf's (rounding
alone moves them) are left out.
"""

from __future__ import annotations

import math

import torch

#: a leaf whose reference change is under this share of the median leaf's
#: is left out
NEGLIGIBLE = 1e-3


def _norms(leaves) -> torch.Tensor:
    """Per-leaf norms (f64): a list of tensors, or the rows of one tensor."""
    if isinstance(leaves, torch.Tensor):
        return torch.linalg.vector_norm(leaves.double(), dim=1).cpu()
    return torch.stack([torch.linalg.vector_norm(x.double()).cpu()
                        for x in leaves])


def _delta(after, before):
    if isinstance(after, torch.Tensor):
        return after.double() - before.double()
    return [a.double() - b.double() for a, b in zip(after, before)]


def leaf_gap(prog_after, ref_after, before, kept: torch.Tensor) -> float:
    """The worst kept leaf's gap of change norms (module docstring)."""
    pn = _norms(_delta(prog_after, before))
    rn = _norms(_delta(ref_after, before))
    scale = torch.clamp(rn, min=float(rn.median()))
    gap = (pn - rn).abs() / scale.clamp_min(1e-300)
    gap = gap[kept]
    return float(gap.max()) if gap.numel() else 0.0


def kept_leaves(ref_first, before) -> torch.Tensor:
    rn = _norms(_delta(ref_first, before))
    return rn >= NEGLIGIBLE * float(rn.median())


def numbers(before, prog: list, ref: list) -> dict:
    """``before``: the initial parameters; ``prog`` and ``ref``: ``[(params,
    loss)]`` after each checked step (params a tensor whose rows are the
    leaves, or a list of tensors)."""
    if len(prog) != len(ref) or not prog:
        raise ValueError("program and reference need the same steps")
    losses = [abs(p - r) / abs(r) if r else abs(p - r)
              for (_, p), (_, r) in zip(prog, ref)]
    loss_gap = max(losses)
    if any(not math.isfinite(p) for _, p in prog):
        loss_gap = math.inf
    kept = kept_leaves(ref[0][0], before)
    return {"loss_gap": loss_gap,
            "first_change_gap": leaf_gap(prog[0][0], ref[0][0], before,
                                         kept),
            "change_gap": leaf_gap(prog[-1][0], ref[-1][0], before, kept)}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number finite and
    within its limit."""
    checks = {name: {"value": values[name], "limit": limits[name]}
              for name in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
