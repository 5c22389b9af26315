"""The comparison that decides ``correct``.

After the window, the reference (``reference/``, which imports nothing of
the program) works out again, from the benchmark's inputs, seeds and
initial weights:

* the pipeline's outputs of the batches that the checked steps used and of
  two batches of the window's own path (``window_batches``), compared
  with what the program delivered: the share of image values off by more
  than ``IMAGE_TOL`` (a thousandth of a normalized unit, under a tenth of
  one 8-bit level), the largest heatmap difference, and the targets
  (active flag, peak, offset, size) that differ;
* the first three training steps from the same weights: each step's loss
  (the worst relative gap), the first gradient as the optimizer holds it
  and the parameters' change after the three steps (each the worst leaf's
  gap of norms, against the larger of the reference leaf's norm and the
  median leaf's, and the median leaf's gap).

Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of the two leaf numbers: Adam moves them by round-off alone.

The control (``control=True``) puts the reference itself in the program's
place, one precision step down: its products in fp8 instead of bf16 and the
pipeline's hue product in TF32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference import centernet as ref_centernet
from .reference import pipeline as ref_pipeline
from .reference.layers import Adam

IMAGE_TOL = 1e-3
TARGET_TOL = 1e-5


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


class Inputs:
    """The reference's view of the benchmark's inputs on ``device``."""

    def __init__(self, inputs, config: dict, seed: int, device):
        self.inputs, self.config, self.seed, self.device = inputs, config, seed, device
        self.b = int(config["batch_size"])

    def batch(self, host_batch: int, echo, tf32: bool = False) -> List[dict]:
        idx = np.arange(host_batch * self.b, (host_batch + 1) * self.b)
        inp = self.inputs
        frames = np.stack([np.stack([inp.frame(int(i), c) for c in range(inp.num_cams)])
                           for i in idx])
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        return ref_pipeline.batch_outputs(put(frames), put(inp.boxes[idx]), put(inp.categories[idx]),
                                          self.seed, host_batch, self.config, echo=echo, tf32=tf32)


def pipeline_numbers(prog: List[dict], ref: List[List[dict]], cams: int) -> Dict[str, float]:
    """``prog``: the program's output dicts; ``ref``: per batch, per camera."""
    off = total = 0
    heat = 0.0
    targets = 0
    for out, cams_ref in zip(prog, ref):
        for c in range(cams):
            r = cams_ref[c]

            def p(key):
                return out[f"cameras.[{c}].{key}"]

            d = (p("image").float() - r["image"]).abs()
            off += int((d > IMAGE_TOL).sum())
            total += d.numel()
            heat = max(heat, float((p("annotations.heatmap") - r["heatmap"]).abs().max()))
            act_p, act_r = p("annotations.active").bool(), r["active"]
            bad = act_p != act_r
            bad |= act_r & (p("annotations.center").int() != r["center"]).any(-1)
            bad |= act_r & ((p("annotations.offset") - r["offset"]).abs() > TARGET_TOL).any(-1)
            bad |= act_r & ((p("annotations.hw") - r["hw"]).abs() > TARGET_TOL * 64).any(-1)
            targets += int(bad.sum())
    return {"image_off_share": off / max(total, 1), "heatmap_max_diff": heat,
            "targets_off": float(targets)}


def reference_steps(config: dict, weights: Dict[str, torch.Tensor], batches: List[List[dict]],
                    low: str) -> dict:
    """The reference's first steps from ``weights`` on the reference's
    batches, with convolutions of ``low`` operands: losses, the first
    gradients and the parameters after the steps."""
    opt = config["optimizer"]
    adam = Adam(opt["lr"], opt["b1"], opt["b2"], opt["eps"])
    p = {k: v.detach().clone() for k, v in weights.items()}
    losses, first = [], None
    for cams in batches:
        loss, grads = ref_centernet.loss_and_grads(p, ref_centernet.step_inputs(cams), config, low)
        losses.append(float(loss))
        first = grads if first is None else first
        p = adam.step(p, grads)
    return {"losses": losses, "grads": first, "params": p}


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
