"""The batched set loss of ``examples/batched_loss_computation.py`` on the port.

A detection head's predictions are matched one to one with each sample's
ground-truth objects and a loss is taken over the matched pairs, batched
over RaggedBatches (``batched_indexing_access``, ``average_over_targets``)
as in the JAX example. Matching comes two ways:

* :func:`match`: the example's host loop, the cost read back to the host and
  scipy's Hungarian per sample (a synchronisation every step);
* :func:`match_on_device`: ``batched_auction_matching`` on the
  ``(B, num_gt, num_pred)`` cost (the example's
  ``device_matching_comparison``): on the card the CUDA auction kernel, one
  launch, with no host synchronisation.

:func:`train_step` is the example's full iteration (head forward, loss,
autograd, SGD) with the matches from either. :func:`per_sample_loss_loop`
is the example's per-sample baseline. Entry points run on the card unless
``device="cpu"``; the arithmetic follows the JAX example's float32 order.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .ragged import (RaggedBatch, average_over_targets, batched_auction_matching,
                     batched_indexing_access, combine_data, get_mask_from_indices)

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def iou_cost(rects_gt: Tensor, rects_pred: Tensor) -> Tensor:
    """``(B, Tg, 4) x (B, Tp, 4) -> (B, Tp, Tg)`` negative IoU."""
    gt = rects_gt[:, None, :, :]
    pr = rects_pred[:, :, None, :]
    x1 = torch.maximum(gt[..., 0], pr[..., 0])
    y1 = torch.maximum(gt[..., 1], pr[..., 1])
    x2 = torch.minimum(gt[..., 2], pr[..., 2])
    y2 = torch.minimum(gt[..., 3], pr[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area_g = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
    area_p = (pr[..., 2] - pr[..., 0]) * (pr[..., 3] - pr[..., 1])
    return -(inter / torch.clamp(area_g + area_p - inter, min=1e-6))


def class_cost(classes_gt: Tensor, class_logits_pred: Tensor) -> Tensor:
    """``(B, Tg) x (B, Tp, C) -> (B, Tp, Tg)``: minus the predicted
    probability of each ground-truth label."""
    probs = torch.softmax(class_logits_pred, dim=-1)
    b, tp, _ = probs.shape
    idx = classes_gt.to(torch.int64)[:, None, :].expand(b, tp, classes_gt.shape[1])
    return -torch.gather(probs, 2, idx)


def compute_cost_matrices(rects_gt: RaggedBatch, classes_gt: RaggedBatch, rects_pred: Tensor,
                          logits_pred: Tensor) -> RaggedBatch:
    """The ``(B, Tp, Tg)`` matching cost, non-uniform along the ground truth
    (dim 2)."""
    total = iou_cost(rects_gt.tensor, rects_pred) + class_cost(classes_gt.tensor, logits_pred)
    return classes_gt.create_with_sample_sizes_like_self(total, non_uniform_dim=2)


def match(rects_gt: RaggedBatch, classes_gt: RaggedBatch, rects_pred: Tensor,
          logits_pred: Tensor) -> Tuple[RaggedBatch, RaggedBatch]:
    """The example's host matcher: the cost read back, scipy's Hungarian per
    sample, the matches sent back to the cost's device. Returns
    ``(matches_gt, matches_pred)``, each sample's pairs in prediction order."""
    from scipy.optimize import linear_sum_assignment

    cost = compute_cost_matrices(rects_gt, classes_gt, rects_pred, logits_pred)
    gt_idx, pred_idx = [], []
    for mat in cost.cpu().split():  # cut to each sample's ground truth
        m_pred, m_gt = linear_sum_assignment(mat.numpy())
        gt_idx.append(np.asarray(m_gt, np.int32))
        pred_idx.append(np.asarray(m_pred, np.int32))
    matches_gt = combine_data(gt_idx, device=cost.tensor.device)
    matches_pred = combine_data(pred_idx, other_with_same_sample_sizes=matches_gt,
                                device=cost.tensor.device)
    return matches_gt, matches_pred


def match_on_device(rects_gt: RaggedBatch, classes_gt: RaggedBatch, rects_pred: Tensor,
                    logits_pred: Tensor, implementation: str = "auto"
                    ) -> Tuple[RaggedBatch, RaggedBatch]:
    """The same matching by the auction on the ``(B, num_gt, num_pred)``
    cost (``batched_auction_matching``, the CUDA kernel on the card), with
    no host synchronisation. Returns ``(matches_gt, matches_pred)``, each
    sample's pairs in ground-truth order; the assignment is within
    ``num_gt * eps`` of the optimum."""
    cost = compute_cost_matrices(rects_gt, classes_gt, rects_pred, logits_pred)
    return batched_auction_matching(cost.tensor.transpose(1, 2).contiguous(),
                                    classes_gt.sample_sizes, implementation=implementation)


def batched_loss(bboxes_gt: RaggedBatch, classes_gt: RaggedBatch, bboxes_pred: Tensor,
                 logits_pred: Tensor, existence_logits_pred: Tensor, weights_gt: RaggedBatch,
                 matches_gt: RaggedBatch, matches_pred: RaggedBatch) -> Tensor:
    """The example's fully batched loss: class cross-entropy and box L1 over
    the matched pairs (weighted, averaged per sample, then over the batch)
    plus the existence BCE of every prediction (matched slots positive)."""
    cls_gt_m = batched_indexing_access(classes_gt, matches_gt)
    cls_pred_m = batched_indexing_access(logits_pred, matches_pred)
    bbx_gt_m = batched_indexing_access(bboxes_gt, matches_gt)
    bbx_pred_m = batched_indexing_access(bboxes_pred, matches_pred)
    w_m = batched_indexing_access(weights_gt, matches_gt)

    ce = -torch.log_softmax(cls_pred_m.tensor, dim=-1)
    cls_idx = cls_gt_m.tensor.to(torch.int64)[..., None]
    cls_loss_data = torch.gather(ce, -1, cls_idx)[..., 0] * w_m.tensor
    bbox_loss_data = (bbx_gt_m.tensor - bbx_pred_m.tensor).abs().sum(-1) * w_m.tensor
    cls_loss = cls_gt_m.create_with_sample_sizes_like_self(cls_loss_data)
    bbox_loss = bbx_gt_m.create_with_sample_sizes_like_self(bbox_loss_data)

    target = get_mask_from_indices(existence_logits_pred.shape[1], matches_pred).to(torch.float32)
    ex_p = torch.sigmoid(existence_logits_pred)
    ex_loss = -(target * torch.log(ex_p + 1e-8)
                + (1 - target) * torch.log(1 - ex_p + 1e-8)).mean()
    return (torch.mean(average_over_targets(cls_loss)) + torch.mean(average_over_targets(bbox_loss))
            + ex_loss)


def one_sample_loss(bb_gt: Tensor, cls_gt: Tensor, bb_pred: Tensor, logits: Tensor,
                    ex_logits: Tensor, w: Tensor, m_gt: Tensor, m_pred: Tensor) -> Tensor:
    """The example's per-sample loss on one sample's matched index lists."""
    m_gt, m_pred = m_gt.to(torch.int64), m_pred.to(torch.int64)
    cls_gt_m, bb_gt_m, w_m = cls_gt[m_gt], bb_gt[m_gt], w[m_gt]
    bb_pred_m, logits_m = bb_pred[m_pred], logits[m_pred]
    ce = -torch.log_softmax(logits_m, dim=-1)
    cls_loss = (torch.gather(ce, 1, cls_gt_m.to(torch.int64)[:, None])[:, 0] * w_m).mean()
    bb_loss = ((bb_gt_m - bb_pred_m).abs().sum(-1) * w_m).mean()
    tgt = torch.zeros(ex_logits.shape[0], dtype=torch.float32, device=ex_logits.device)
    tgt = tgt.index_fill(0, m_pred, 1.0)
    ex_p = torch.sigmoid(ex_logits)
    ex_loss = -(tgt * torch.log(ex_p + 1e-8) + (1 - tgt) * torch.log(1 - ex_p + 1e-8)).mean()
    return cls_loss + bb_loss + ex_loss


def per_sample_loss_loop(data: Dict, matches_gt: RaggedBatch,
                         matches_pred: RaggedBatch) -> Tensor:
    """The example's per-sample baseline: :func:`one_sample_loss` per
    sample (the sizes read back to the host), averaged."""
    sizes = matches_gt.sample_sizes.cpu().numpy()
    totals = []
    for i in range(data["bboxes_gt"].tensor.shape[0]):
        n = int(sizes[i])
        totals.append(one_sample_loss(
            data["bboxes_gt"].tensor[i], data["classes_gt"].tensor[i], data["bboxes_pred"][i],
            data["logits_pred"][i], data["existence_pred"][i], data["weights_gt"].tensor[i],
            matches_gt.tensor[i, :n], matches_pred.tensor[i, :n]))
    return torch.mean(torch.stack(totals))


def make_data(batch_size: int = 8, max_gt: int = 48, num_pred: int = 300,
              num_classes: int = 10, seed: int = 0, device: DeviceLike = None) -> Dict:
    """The example's synthetic batch, drawn from ``numpy.random.default_rng(
    seed)`` in its order: ground-truth boxes, classes and weights as
    RaggedBatches of sample sizes in {16, 32, 48}; predicted boxes, class
    logits and existence logits as tensors."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    sizes = rng.choice([16, 32, 48], size=(batch_size,)).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    mk = lambda x: RaggedBatch(t(x), sample_sizes=t(sizes))  # noqa: E731
    xy = rng.uniform(0, 500, (batch_size, max_gt, 2))
    wh = rng.uniform(20, 120, (batch_size, max_gt, 2))
    bboxes_gt = np.concatenate([xy, xy + wh], axis=2).astype(np.float32)
    xy_p = rng.uniform(0, 500, (batch_size, num_pred, 2))
    wh_p = rng.uniform(20, 120, (batch_size, num_pred, 2))
    return {
        "bboxes_gt": mk(bboxes_gt),
        "classes_gt": mk(rng.integers(0, num_classes, (batch_size, max_gt)).astype(np.float32)),
        "weights_gt": mk(rng.uniform(0.5, 1.5, (batch_size, max_gt)).astype(np.float32)),
        "bboxes_pred": t(np.concatenate([xy_p, xy_p + wh_p], 2).astype(np.float32)),
        "logits_pred": t(rng.normal(size=(batch_size, num_pred, num_classes)).astype(np.float32)),
        "existence_pred": t(rng.normal(size=(batch_size, num_pred)).astype(np.float32)),
    }


def make_head(dim: int = 256, num_classes: int = 10, seed: int = 0,
              device: DeviceLike = None) -> Params:
    """The example's linear head ``{"wb": (dim, 4), "wc": (dim, classes),
    "we": (dim,)}``, normal times 0.02, from ``numpy.random.default_rng(
    seed)`` (the example draws it from ``jax.random``, whose bits torch
    cannot reproduce: tests hand both sides the same numpy weights)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    shapes = {"wb": (dim, 4), "wc": (dim, num_classes), "we": (dim,)}
    return {k: torch.from_numpy((rng.normal(size=s) * 0.02).astype(np.float32)).to(dev)
            for k, s in shapes.items()}


def head_forward(params: Params, feat: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """``(.., num_pred, dim)`` features -> boxes, class logits, existence."""
    return feat @ params["wb"], feat @ params["wc"], feat @ params["we"]


def loss_and_grads(params: Params, feat: Tensor, data: Dict,
                   matches: Tuple[RaggedBatch, RaggedBatch]) -> Tuple[Tensor, Params]:
    """Head forward on ``feat``, the batched loss over ``matches``, and its
    gradient with respect to each head parameter (``jax.value_and_grad``)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    boxes, logits, ex = head_forward(leaves, feat)
    loss = batched_loss(data["bboxes_gt"], data["classes_gt"], boxes, logits, ex,
                        data["weights_gt"], *matches)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def train_step(params: Params, feat: Tensor, data: Dict,
               matches: Optional[Tuple[RaggedBatch, RaggedBatch]] = None,
               lr: float = 1e-3) -> Tuple[Params, Tensor]:
    """The example's batched full iteration: :func:`loss_and_grads`, then one
    SGD step. ``matches=None`` matches inside the step with
    :func:`match_on_device` (the data's predicted boxes and logits against
    its ground truth: the cost the example's host loop matches); pass
    :func:`match`'s result for the host form. Returns ``(new params, loss)``."""
    if matches is None:
        matches = match_on_device(data["bboxes_gt"], data["classes_gt"], data["bboxes_pred"],
                                  data["logits_pred"])
    loss, grads = loss_and_grads(params, feat, data, matches)
    with torch.no_grad():
        return {k: p - lr * grads[k] for k, p in params.items()}, loss
