"""The comparison that decides ``correct`` for a training cell.

The program's first steps are held against the reference's on the same
weights and batches, by five numbers, each against a limit of the cell's
own (``portbench/limits/<cell>.json``):

- ``loss``: the first step's relative loss gap, ``|L - L_ref| / |L_ref|``;
- ``loss_steps``: the worst step's; steps 2 on read the parameters that
  the earlier steps' updates wrote, so an update of the wrong sign, or one
  that lands on the wrong rows of a store, shows here most (a norm of one
  step's change does not see either);
- ``grad``: the first step's gradient, as the optimizer gets it, by the
  worst leaf: ``| |g| - |g_ref| | / max(|g_ref|, median leaf |g_ref|)``;
- ``change``: every leaf's change over the checked steps, the same way, by
  the median leaf;
- ``change_worst``: the same by the worst leaf, which a leaf left unmoved
  or moved twice drives to about 1.

Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of both changes: adagrad moves them by round-off alone.
Adagrad's first step moves every weight by ±lr by the sign of its
gradient, so a gradient at round-off level flips a move of 2·lr: a sound
program's later losses and small leaves depart from the reference by that
(``PERF.md`` §2 has the readings and the limits set from them).

A gap of norms is taken, not the norm of a difference: it does not depend
on which rows a dedupe or a reduction order put where.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Tuple

NUMBERS = ("loss", "loss_steps", "grad", "change", "change_worst")
ROUNDOFF_SHARE = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """``{leaf: | |p| - |ref| | / max(|ref|, median leaf |ref|)}``."""
    names = sorted(ref if leaves is None else leaves)
    if set(prog) != set(ref):
        raise ValueError(f"leaves differ: program {sorted(prog)}, "
                         f"reference {sorted(ref)}")
    median = statistics.median(ref[k] for k in names)
    out = {}
    for k in names:
        base = max(ref[k], median)
        out[k] = abs(prog[k] - ref[k]) / base if base > 0 else \
            (0.0 if prog[k] == 0 else float("inf"))
    return out


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves: Optional[Iterable[str]] = None
                   ) -> Tuple[float, str]:
    """``(gap, leaf)`` of the leaf whose norm departs most from the
    reference's, relative to its own norm or the median leaf's, whichever
    is larger."""
    gaps = leaf_gaps(prog, ref, leaves)
    leaf = max(gaps, key=lambda k: gaps[k])
    return gaps[leaf], leaf


def moved_leaves(ref_grad: Dict[str, float]) -> list:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    median = statistics.median(ref_grad.values())
    return sorted(k for k, v in ref_grad.items()
                  if v >= ROUNDOFF_SHARE * median)


def readings(prog: dict, ref: dict) -> Dict[str, dict]:
    """Each number compared, with the step or leaf it comes from.
    ``prog`` and ``ref`` hold ``losses``, ``grad_norm`` and
    ``change_norm``."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the program and the reference ran different "
                         "numbers of steps")
    loss_gaps = [abs(a - b) / abs(b) for a, b in
                 zip(prog["losses"], ref["losses"])]
    grad, grad_leaf = worst_leaf_gap(prog["grad_norm"], ref["grad_norm"])
    moved = moved_leaves(ref["grad_norm"])
    change = leaf_gaps(prog["change_norm"], ref["change_norm"], moved)
    worst = max(change, key=lambda k: change[k])
    return {"loss": {"value": loss_gaps[0], "at": "step 1"},
            "grad": {"value": grad, "at": grad_leaf},
            "change": {"value": statistics.median(change.values()),
                       "at": "median leaf"},
            "change_worst": {"value": change[worst], "at": worst},
            "loss_steps": {"value": max(loss_gaps), "at": str(loss_gaps)}}


def verdict(found: Dict[str, dict], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """``(correct, {number: {value, limit}})``: correct when every number
    is finite and within its limit."""
    out, ok = {}, True
    for name in NUMBERS:
        value = float(found[name]["value"])
        limit = float(limits[name])
        out[name] = {"value": value, "limit": limit}
        ok = ok and value == value and value <= limit
    return ok, out
