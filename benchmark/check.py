"""The numbers that decide ``correct``: how far the program's outputs lie
from the plain reference's, each held to its limit.

Train steps (norms by leaf, each gap against the reference's norm of that
leaf or of the median leaf, whichever is larger):

- ``loss_gap``: the largest relative gap of a checked step's loss;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient;
- ``delta_gap``: the worst leaf's gap between the norms of the parameters'
  change after the checked steps;
- ``latent_gap`` (where the reference's head follows the program's
  latents, ``benchmark/drivers/supervised_train.py``): the largest
  relative gap (Frobenius) of a checked step's head-input latent at a
  scale against the reference's own rollout; a latent of another shape
  reads infinite.

Leaves whose reference gradient is under a thousandth of the median leaf's
(a conv bias ahead of an instance norm, which the norm cancels) move by
round-off alone and are left out of both by that rule.

Streaming:

- ``state_gap``: the largest relative gap (Frobenius) of a level's carried
  h or c at the end of a segment;
- ``cm_moved``: the largest share of a scored window's pixels whose
  (label, prediction) cell differs from the reference's.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable

import numpy as np

ZERO_GRAD = 1e-3


def counted_leaves(ref_grad1: Dict[str, float]) -> list:
    med = statistics.median(ref_grad1.values())
    return [k for k, v in ref_grad1.items() if v >= ZERO_GRAD * med]


def worst(values: Iterable[float]) -> float:
    """The largest value; infinite where any is not finite."""
    values = [float(v) for v in values]
    return max(values) if np.isfinite(values).all() else float("inf")


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Iterable[str]) -> Dict[str, float]:
    leaves = list(leaves)
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med)
            for k in leaves}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Iterable[str]) -> float:
    return worst(leaf_gaps(prog, ref, leaves).values())


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    leaves = counted_leaves(ref["grad1"])
    loss_gap = worst(abs(p - r) / abs(r)
                     for p, r in zip(prog["losses"], ref["losses"]))
    out = {"loss_gap": loss_gap,
           "grad_gap": leaf_gap(prog["grad1"], ref["grad1"], leaves),
           "delta_gap": leaf_gap(prog["delta"], ref["delta"], leaves)}
    if "latents" in ref:
        out["latent_gap"] = worst(
            _rel(p[s], r[s]) if p[s].shape == r[s].shape else float("inf")
            for p, r in zip(prog["latents"], ref["latents"]) for s in r)
    return out


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def stream_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    state_gap = worst(_rel(p, r)
                    for idx, levels in prog["states"].items()
                    for pl, rl in zip(levels, ref[idx]["state"])
                    for p, r in zip(pl, rl))
    cm_moved = worst(0.5 * np.abs(cm - ref[idx]["cm"]).sum()
                     / ref[idx]["cm"].sum() for idx, cm in prog["cms"])
    return {"state_gap": state_gap, "cm_moved": cm_moved}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(numbers[k] <= lim for k, lim in limits.items())
