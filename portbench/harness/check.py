"""The comparison that decides ``correct``: the program's first steps,
read from its own state, against the plain reference's steps from the
same weights and batches.

Three numbers, each against a limit of its own (the cell's file states
the limits):

``loss``    the largest relative gap between the program's and the
            reference's loss over the checked steps;
``grad``    over the leaves, the largest gap between the program's and
            the reference's norm of the first gradient as AdamW took it,
            relative to the larger of the reference's norm of that leaf
            and of the median leaf;
``update``  the same for the norm of each leaf's change over the checked
            steps, leaving out leaves whose first gradient in the
            reference is under a thousandth of the median leaf's (they
            move under AdamW by rounding alone).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

#: leaves whose first gradient is under this share of the median leaf's
#: move by rounding alone and are left out of ``update``
STILL = 1e-3


def worst_leaf(prog: Sequence[float], ref: Sequence[float],
               keep: Sequence[bool]) -> float:
    kept = [(p, r) for p, r, k in zip(prog, ref, keep) if k]
    median = statistics.median(r for _, r in kept)
    return max(_gap(p, r, max(r, median)) for p, r in kept)


def _gap(p: float, r: float, scale: float) -> float:
    """``|p - r| / scale``, infinite where either side is not finite."""
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / scale


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three numbers compared. ``prog`` and ``ref`` hold ``loss`` (a
    list a step), ``grad`` and ``change`` (a list a leaf, in the same
    leaf order); ``ref`` also ``raw_grad``, the first gradient before the
    clip."""
    loss = max(_gap(p, r, abs(r)) for p, r in zip(prog["loss"],
                                                  ref["loss"]))
    every = [True] * len(ref["grad"])
    median = statistics.median(ref["raw_grad"])
    moving = [g >= STILL * median for g in ref["raw_grad"]]
    return {"loss": loss,
            "grad": worst_leaf(prog["grad"], ref["grad"], every),
            "update": worst_leaf(prog["change"], ref["change"], moving)}


def verdict(got: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every number within its limit, and each number
    beside its limit, in the order of ``limits``."""
    checks = {name: {"value": got[name], "limit": limit}
              for name, limit in limits.items()}
    correct = all(got[name] <= limit for name, limit in limits.items())
    return correct, checks


def lines(checks: Dict) -> List[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in checks.items()]
