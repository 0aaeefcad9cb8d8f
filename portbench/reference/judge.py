"""The numbers that decide ``correct``: the program's checked rounds
against the reference's, each number with the limit its cell states.

Over the checked rounds (records of ``fl.RoundRecord``'s form):

* ``first_loss_gap``: the largest relative gap of a user's loss on the
  first checked round's first batch: the forward pass of the timed local
  step from the initial global both sides share (a later step's or
  round's loss also carries the round-off that ReLU kinks amplify);
* ``loss_gap``: the largest relative gap of a user's round loss (the
  mean over its epoch's steps);
* ``local_gap``: each trained user model's change from its round's
  global, leaf by leaf: the gap between the program's norm and the
  reference's, over the larger of the reference's norm of that leaf and
  of the user's median leaf; the largest;
* ``prio_gap``: the largest relative gap of an Eq. 2 priority;
* ``winners_mismatch``: rounds whose winners, in delivery order, differ
  from the reference's selection by the program's priorities (exact);
* ``step1_gap``: the first merge's change of the global (what the server
  steps by), leaf by leaf as ``local_gap``;
* ``change3_gap``: the global's change after the three checked rounds,
  the same way.

Both change gaps read each record's ``change``: the norms of the merged
global's change from the initial global, summed leaf by leaf in f64.

A leaf the reference moves by under a thousandth of its median leaf's
change is left out of a change gap (its change is round-off).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

NUMBERS = ("first_loss_gap", "loss_gap", "local_gap", "prio_gap",
           "winners_mismatch", "step1_gap", "change3_gap")
#: a leaf moved by less than this share of the median leaf's change is
#: round-off, and left out of a change gap
MOVED = 1e-3


def _finite(a):
    a = np.asarray(a, np.float64)
    return np.where(np.isfinite(a), a, np.inf)


def norm_gap(got: np.ndarray, want: np.ndarray) -> float:
    """Largest gap between two (..., L) arrays of leaf norms, each over
    the larger of the reference's norm and its row's median leaf."""
    got, want = _finite(got), np.asarray(want, np.float64)
    med = np.median(want, axis=-1, keepdims=True)
    moved = want >= MOVED * med
    gap = np.abs(got - want) / np.maximum(want, med)
    gap = np.where(moved, gap, 0.0)
    return float(np.nan_to_num(gap, nan=np.inf).max())


def _rel(got, want) -> float:
    got, want = _finite(got), np.asarray(want, np.float64)
    gap = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    return float(np.nan_to_num(gap, nan=np.inf).max())


def numbers(prog: List, ref: List) -> Dict[str, float]:
    """``prog`` / ``ref``: the checked rounds' records, both begun from
    the same initial global."""
    n = len(ref)
    out = {
        "first_loss_gap": _rel(prog[0].first_loss, ref[0].first_loss),
        "loss_gap": max(_rel(p.loss, r.loss) for p, r in zip(prog, ref)),
        "local_gap": max(norm_gap(p.local, r.local)
                         for p, r in zip(prog, ref)),
        "prio_gap": max(_rel(p.prio, r.prio) for p, r in zip(prog, ref)),
        "winners_mismatch": float(sum(
            list(p.winners) != list(r.winners) for p, r in zip(prog, ref))),
        "step1_gap": norm_gap(prog[0].change, ref[0].change),
        "change3_gap": norm_gap(prog[n - 1].change, ref[n - 1].change),
    }
    return out


def verdict(values: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: every number at or under its limit, and the
    ``{name: {"value", "limit"}}`` table in ``NUMBERS`` order."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in checks.values())
    return ok, checks
