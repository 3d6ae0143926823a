"""The numbers that decide ``correct``: the program's first training steps
against the plain reference's, on the same weights and batches.

Readings of a run, each a list over the check's steps or over the leaves
(in the family's ``params`` order):

  * ``losses``: each step's mean loss (at several ranks, the ranks' mean);
  * ``grad``: each leaf's norm of the first gradient as the optimizer got
    it, read from its state after one step (SGD's momentum buffer after
    the first step: the gradient plus the weight decay);
  * ``change``: each leaf's norm of the parameters' change after the
    check's steps.

Numbers compared, each a worst case:

  * ``loss_gap``: the largest |program - reference| / |reference| over
    the steps' losses;
  * ``grad_gap``: over the leaves, the gap between the program's norm and
    the reference's, against the larger of the reference's norm of that
    leaf and of the median leaf;
  * ``update_gap``: the same for the change, over the leaves whose
    reference gradient is at least a thousandth of the median leaf's
    (a leaf with no gradient moves by round-off alone);
  * ``grad_median_gap``, ``update_median_gap``: the median over the same
    leaves of the same per-leaf gaps. The worst leaf swings from seed to
    seed (bfloat16 rounding, amplified through the backward into the
    early batch norms' scale and shift, moves a leaf by 20-40 % in the
    program and in the reference rounded alike); the median leaf is
    steady.
"""

from __future__ import annotations

import statistics

MOVED = 1e-3  # a leaf counts in update_gap above this share of the median


def _gaps(prog: list, ref: list, keep: list) -> list[float]:
    """Per kept leaf, |program - reference| over the larger of the
    reference's leaf and median leaf."""
    med = statistics.median(r for r, k in zip(ref, keep) if k)
    return [abs(p - r) / max(r, med) for p, r, k in zip(prog, ref, keep)
            if k]


def numbers(prog: dict, ref: dict) -> dict:
    losses = max(abs(p - r) / abs(r)
                 for p, r in zip(prog["losses"], ref["losses"]))
    med_g = statistics.median(ref["grad"])
    grad = _gaps(prog["grad"], ref["grad"], [True] * len(ref["grad"]))
    change = _gaps(prog["change"], ref["change"],
                   [g >= MOVED * med_g for g in ref["grad"]])
    return {"loss_gap": losses,
            "grad_gap": max(grad), "update_gap": max(change),
            "grad_median_gap": statistics.median(grad),
            "update_median_gap": statistics.median(change)}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when the limits name
    at least one number and every number they name is within its limit;
    a number they do not name is reported and not compared."""
    rows = {k: {"value": v, "limit": limits.get(k)} for k, v in values.items()}
    ok = bool(limits) and all(k in values and values[k] <= lim
                              for k, lim in limits.items())
    return ok, rows
