"""Detection evaluation: batched IoU, greedy matching, mAP.

PyTorch port of ``accvlab_tpu/models/eval.py``, with the same split of the
work:

* **on the device, fixed shapes**: the pairwise IoU matrix
  (:func:`box_iou_matrix`) and the score-ordered greedy TP/FP matching
  (:func:`match_detections`, :func:`match_detections_3d`). The JAX package
  runs the sequential dependency as one ``lax.scan`` over the K detection
  slots; here it is a loop over K of batched ops;
* **on the host, tiny data**: :class:`DetectionEvaluator` keeps the
  per-detection ``(score, tp, class)`` triplets and computes AP and mAP at
  the end (:func:`_interpolated_ap`, a copy of the JAX package's numpy).

The matching protocol is the standard single-match greedy one (VOC/COCO):
detections visit in descending score order; a detection is a true positive
iff its best *unmatched* ground truth of the *same class* passes the gate,
and it consumes that ground truth. AP uses 101-point interpolation.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ragged import RaggedBatch

Tensor = torch.Tensor


def box_iou_matrix(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise IoU of two batched ``x1,y1,x2,y2`` box sets ``(B, N, 4)``
    and ``(B, M, 4)``: ``(B, N, M)`` float32; degenerate pairs give 0."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = torch.clamp(b1[..., 2] - b1[..., 0], min=0.0) * torch.clamp(b1[..., 3] - b1[..., 1],
                                                                         min=0.0)
    area2 = torch.clamp(b2[..., 2] - b2[..., 0], min=0.0) * torch.clamp(b2[..., 3] - b2[..., 1],
                                                                         min=0.0)
    union = area1 + area2 - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)


def _no_slots(pred: RaggedBatch, gt: RaggedBatch) -> bool:
    return pred.tensor.shape[-2] == 0 or gt.tensor.shape[-2] == 0


def match_detections(pred_boxes: RaggedBatch, pred_scores: RaggedBatch,
                     pred_classes: RaggedBatch, gt_boxes: RaggedBatch, gt_classes: RaggedBatch,
                     iou_threshold: float = 0.5) -> Tensor:
    """Greedy score-ordered TP/FP assignment of 2-D boxes. Predictions must
    be sorted by descending score within each sample (the decodes return
    them so). Returns ``tp (B, K) bool``; padded slots are False."""
    if _no_slots(pred_boxes, gt_boxes):
        return torch.zeros(pred_scores.tensor.shape, dtype=torch.bool,
                           device=pred_scores.tensor.device)
    iou = box_iou_matrix(pred_boxes.tensor, gt_boxes.tensor)
    eligible = _eligibility(pred_scores, pred_classes, gt_classes) & (iou >= iou_threshold)
    return _greedy_match(torch.where(eligible, iou, float("-inf")))


def match_detections_3d(pred_boxes3d: RaggedBatch, pred_scores: RaggedBatch,
                        pred_classes: RaggedBatch, gt_boxes3d: RaggedBatch,
                        gt_classes: RaggedBatch, distance_threshold: float = 2.0) -> Tensor:
    """nuScenes-style 3-D matching: a detection is a TP iff the NEAREST
    unmatched same-class ground truth lies strictly within
    ``distance_threshold`` meters of BEV centre distance (``[..., :2]`` of
    ``x, y, z, w, l, h, yaw`` boxes). Returns ``tp (B, K) bool``."""
    if _no_slots(pred_boxes3d, gt_boxes3d):
        return torch.zeros(pred_scores.tensor.shape, dtype=torch.bool,
                           device=pred_scores.tensor.device)
    dist2 = _center_dist2(pred_boxes3d, gt_boxes3d)
    eligible = _eligibility(pred_scores, pred_classes, gt_classes) & (
        dist2 < float(distance_threshold) ** 2)
    # nearest first: the affinity is the negative squared distance
    return _greedy_match(torch.where(eligible, -dist2, float("-inf")))


def _center_dist2(pb: RaggedBatch, gb: RaggedBatch) -> Tensor:
    d = pb.tensor[..., :, None, :2] - gb.tensor[..., None, :, :2]
    return (d * d).sum(dim=-1)


def _eligibility(pred_scores: RaggedBatch, pred_classes: RaggedBatch,
                 gt_classes: RaggedBatch) -> Tensor:
    same_class = pred_classes.tensor[..., :, None] == gt_classes.tensor[..., None, :]
    return same_class & gt_classes.mask[..., None, :] & pred_scores.mask[..., :, None]


def _greedy_match(cand: Tensor) -> Tensor:
    """Greedy assignment over score-sorted slots: ``cand (B, K, M)`` holds
    the affinity of eligible pairs and ``-inf`` elsewhere; each slot in turn
    takes its best-affinity unmatched ground truth (the first on a tie),
    consuming it, or is a FP."""
    b, k, m = cand.shape
    matched = torch.zeros((b, m), dtype=torch.bool, device=cand.device)
    tp = []
    for j in range(k):
        avail = torch.where(matched, float("-inf"), cand[:, j])
        best = avail.argmax(dim=1, keepdim=True)
        ok = avail.gather(1, best) > float("-inf")
        matched = matched.scatter(1, best, matched.gather(1, best) | ok)
        tp.append(ok[:, 0])
    return torch.stack(tp, dim=1) if tp else torch.zeros((b, 0), dtype=torch.bool,
                                                         device=cand.device)


def _match_all_thresholds(metric: str, thresholds: Sequence[float], pb: RaggedBatch,
                          ps: RaggedBatch, pc: RaggedBatch, gb: RaggedBatch,
                          gc: RaggedBatch) -> Tensor:
    """The whole threshold ladder at once: the ``(B, K, M)`` affinity and
    eligibility are computed once and each threshold only re-gates them.
    Returns ``(T, B, K)`` bool."""
    if _no_slots(pb, gb):
        return torch.zeros((len(thresholds),) + tuple(ps.tensor.shape), dtype=torch.bool,
                           device=ps.tensor.device)
    elig = _eligibility(ps, pc, gc)
    if metric == "iou":
        aff = box_iou_matrix(pb.tensor, gb.tensor)
        gates = [aff >= t for t in thresholds]
    else:
        dist2 = _center_dist2(pb, gb)
        aff = -dist2
        gates = [dist2 < t * t for t in thresholds]
    return torch.stack([_greedy_match(torch.where(elig & g, aff, float("-inf")))
                        for g in gates])


def _interpolated_ap(scores, tp, num_gt, num_points=101):
    """COCO-style AP: precision envelope sampled at evenly spaced recalls."""
    if num_gt == 0:
        return float("nan")  # class absent from ground truth -> excluded
    if scores.size == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = tp[order].astype(np.float64)
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(1.0 - tp)
    recall = cum_tp / num_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-12)
    # precision envelope (monotone non-increasing from the right)
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    sample_recalls = np.linspace(0.0, 1.0, num_points)
    idx = np.searchsorted(recall, sample_recalls, side="left")
    sampled = np.where(idx < precision.size, precision[np.minimum(idx, precision.size - 1)], 0.0)
    return float(sampled.mean())


class DetectionEvaluator:
    """Streaming mAP over batches of decoded detections.

    ``update()`` runs the matching on the detections' device and reads the
    per-detection triplets back to the host in one copy per batch;
    ``compute()`` builds AP per class and the mean. One evaluator instance per
    threshold ladder.
    """

    def __init__(self, iou_thresholds: Sequence[float] = (0.5,), num_points: int = 101, *,
                 metric: str = "iou", thresholds: Optional[Sequence[float]] = None):
        """``metric``: ``"iou"`` (2-D boxes, ``iou_thresholds``) or
        ``"center_distance"`` (3-D boxes, thresholds in meters; the nuScenes
        ladder is ``(0.5, 1, 2, 4)``). ``thresholds`` overrides
        ``iou_thresholds`` for either metric."""
        if metric not in ("iou", "center_distance"):
            raise ValueError(f"unknown metric {metric!r}")
        ts = thresholds if thresholds is not None else iou_thresholds
        self._metric = metric
        self._box_field = "boxes" if metric == "iou" else "boxes3d"
        self._thresholds = tuple(float(t) for t in ts)
        self._num_points = int(num_points)
        self._records = {t: [] for t in self._thresholds}
        self._gt_counts: collections.Counter = collections.Counter()

    def update(self, detections: Dict[str, RaggedBatch], ground_truth: Dict[str, RaggedBatch]):
        """Accumulate one batch: ``detections`` ``{"boxes"|"boxes3d",
        "scores", "classes"}`` as the decodes return them (score-sorted),
        ``ground_truth`` ``{"boxes"|"boxes3d", "classes"}``."""
        bf = self._box_field
        pb, ps, pc = detections[bf], detections["scores"], detections["classes"]
        gb, gc = ground_truth[bf], ground_truth["classes"]
        with torch.no_grad():
            tp_all = _match_all_thresholds(self._metric, self._thresholds, pb, ps, pc, gb, gc)
            # one copy to the host: every per-detection and per-gt field as float64
            parts = [ps.mask, ps.tensor, pc.tensor, gc.tensor, gc.mask, tp_all]
            host = torch.cat([p.reshape(-1).to(torch.float64) for p in parts]).cpu().numpy()
        pieces, at = [], 0
        for p in parts:
            pieces.append(host[at:at + p.numel()].reshape(p.shape))
            at += p.numel()
        pred_valid, scores, classes, gt_classes, gt_valid, tp_all = pieces
        gt_valid = gt_valid.astype(bool)
        for c, n in zip(*np.unique(gt_classes[gt_valid], return_counts=True)):
            self._gt_counts[int(c)] += int(n)
        v = pred_valid.astype(bool).reshape(-1)
        for ti, t in enumerate(self._thresholds):
            self._records[t].append((scores.reshape(-1)[v], tp_all[ti].astype(bool).reshape(-1)[v],
                                     classes.reshape(-1)[v]))

    def compute(self) -> Dict[str, object]:
        """AP per class and threshold; ``mAP@t`` is the mean over the classes
        present in the ground truth, ``mAP`` the mean over thresholds."""
        out: Dict[str, object] = {"per_class": {}}
        maps = []
        classes_present = sorted(self._gt_counts)
        for t in self._thresholds:
            recs = self._records[t]
            if recs:
                scores = np.concatenate([r[0] for r in recs])
                tp = np.concatenate([r[1] for r in recs])
                cls = np.concatenate([r[2] for r in recs])
            else:
                scores = tp = cls = np.zeros((0,))
            aps = {}
            for c in classes_present:
                sel = cls == c
                aps[c] = _interpolated_ap(scores[sel], tp[sel], self._gt_counts[c],
                                          self._num_points)
            vals = [a for a in aps.values() if not np.isnan(a)]
            m = float(np.mean(vals)) if vals else float("nan")
            out["per_class"][t] = aps
            out[f"mAP@{t:g}"] = m
            maps.append(m)
        vals = [m for m in maps if not np.isnan(m)]
        out["mAP"] = float(np.mean(vals)) if vals else float("nan")
        return out

    def reset(self):
        self._records = {t: [] for t in self._thresholds}
        self._gt_counts.clear()
