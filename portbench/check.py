"""The comparison that decides ``correct``.

After the window, the family's plain reference (``reference/``, which
imports nothing of the program) works out again, from the benchmark's
inputs, seeds and initial weights:

* the program's batches of the checked steps and of two steps of the
  window's own path, compared by the family's ``pipeline_numbers``;
* the first three training steps from the same weights, compared here:
  each step's loss (the worst relative gap), the first gradient as the
  optimizer holds it and the parameters' change after the three steps
  (each the worst leaf's gap of norms, against the larger of the reference
  leaf's norm and the median leaf's, and the median leaf's gap).

Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of the two leaf numbers: the optimizer moves them by
round-off alone.

The control puts the reference itself in the program's place, one
precision step down, as the family defines it (``low=True``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


def median(xs):
    return float(np.median(np.asarray(xs, np.float64)))


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              ref_grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per leaf, ``|norm(prog) - norm(ref)| / max(norm(ref), median leaf
    norm)``, over the leaves that the reference's gradient moves."""
    gnorm = {k: float(g.double().norm()) for k, g in ref_grads.items()}
    gmed = median(list(gnorm.values()))
    keep = [k for k in ref if gnorm[k] >= 1e-3 * gmed]
    rnorm = {k: float(ref[k].double().norm()) for k in keep}
    rmed = median(list(rnorm.values()))
    gaps = {}
    for k in keep:
        gap = abs(float(prog[k].double().norm()) - rnorm[k]) / max(rnorm[k], rmed, 1e-30)
        gaps[k] = gap if math.isfinite(gap) else math.inf
    return gaps


def worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    where = max(gaps, key=gaps.get)
    return gaps[where], where


def rel_gap(a: float, b: float) -> float:
    gap = abs(a - b) / max(abs(b), 1e-30)
    return gap if math.isfinite(gap) else math.inf


def numbers(prog: dict, ref: dict, weights: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The step numbers of ``prog`` (the program's readings, or the
    control's) against the reference's; ``_worst`` names the worst leaves."""
    gaps = [rel_gap(a, b) for a, b in zip(prog["losses"], ref["losses"])]
    out = {"loss_gap": max(gaps), "first_loss_gap": gaps[0]}
    grads = leaf_gaps(prog["grads"], ref["grads"], ref["grads"])
    out["grad_gap"], grad_leaf = worst(grads)
    out["grad_median_gap"] = median(list(grads.values()))
    moved_prog = {k: prog["params"][k] - weights[k] for k in weights}
    moved_ref = {k: ref["params"][k] - weights[k] for k in weights}
    moved = leaf_gaps(moved_prog, moved_ref, ref["grads"])
    out["update_gap"], update_leaf = worst(moved)
    out["update_median_gap"] = median(list(moved.values()))
    out["_worst"] = {"grad_gap": grad_leaf, "update_gap": update_leaf}
    return out


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, dict, dict]:
    """``(correct, compared, not compared)``: ``compared`` is ``{name: [value,
    limit]}`` of the numbers that have a limit, and the run is correct when
    there is one and each is at most its limit."""
    compared = {k: [v, limits[k]] for k, v in values.items() if k in limits}
    ok = bool(compared) and set(limits) <= set(values) and all(
        math.isfinite(v) and v <= lim for v, lim in compared.values())
    return ok, compared, {k: v for k, v in values.items() if k not in limits}
