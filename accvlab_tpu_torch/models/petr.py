"""StreamPETR-style multi-camera 3-D detector (second model family).

PyTorch port of ``accvlab_tpu/models/petr.py``: a per-camera conv backbone
(stride 8) -> flattened image tokens -> a query-based transformer decoder
(PETR pattern) -> per-query 3-D box / class / existence heads, trained with
the batched ragged set loss of :mod:`accvlab_tpu_torch.ragged`. Images are
``(B, N_cam, H, W, 3)``, as in the JAX package.

Numerics follow flax's, not ``torch.autocast``'s (parameters stay float32 and
are cast inside ``forward``, so their gradients arrive in float32):

* the backbone is CenterNet's ``ConvBlock`` (bf16 3x3 convs with XLA's
  'SAME' padding, float32 GroupNorm with eps 1e-6 and fast variance);
* the token projection, the attention and the MLP run in bf16, the
  position encoder, ``memory_proj``, the heads and the LayerNorms (eps
  1e-6, fast variance) in float32; a bf16 ``Dense`` rounds its product and
  then its bias addition, as flax adds the bias after the dot;
* attention is flax's ``MultiHeadDotProductAttention(dtype=bf16)`` written
  out: q, k, v projected in bf16, the QUERY divided by ``sqrt(head_dim)``
  rounded to bf16 before the dot, the softmax in bf16 (``jax.nn.softmax``'s
  max, exp, sum and division, each rounded). ``scaled_dot_product_attention``
  scales and softmaxes differently and is not used;
* ``lax.top_k`` gives ties to the lower index: the top-k here is a stable
  descending sort (an all-zero first memory makes ties real);
* the float32 products (``compensate_ref_points``, the float32 Dense layers)
  need TF32 off on the card, PyTorch's default for matmuls
  (``torch.backends.cuda.matmul.allow_tf32`` is False).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import device_of, resolve_device
from ..ragged import (RaggedBatch, average_over_targets, batched_indexing_access,
                      get_mask_from_indices)
from .centernet import LECUN_TRUNCATION, ConvBlock

Tensor = torch.Tensor
LAYER_NORM_EPS = 1e-6  # flax's default (torch's is 1e-5)


def dense(x: Tensor, layer: nn.Linear, dtype: torch.dtype = torch.float32) -> Tensor:
    """flax ``nn.Dense(dtype=dtype)``: the product in ``dtype``, then the
    bias added in ``dtype``."""
    x = x.to(dtype)
    y = torch.matmul(x, layer.weight.to(dtype).t())
    return y + layer.bias.to(dtype)


def layer_norm(x: Tensor, norm: nn.LayerNorm) -> Tensor:
    """flax ``nn.LayerNorm()`` in float32: fast variance, eps 1e-6, the
    scale folded into the inverse deviation."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + LAYER_NORM_EPS) * norm.weight
    return (x - mean) * mul + norm.bias


class CameraBackbone(nn.Module):
    """Three stride-2 ``ConvBlock``s (width, width, 2 * width) over every
    camera; tokens ``(B, N_cam * Hf * Wf, 2 * width)`` bf16 in NHWC order."""

    def __init__(self, width: int = 64):
        super().__init__()
        self.width = width
        self.blocks = nn.ModuleList([ConvBlock(3, width, stride=2),
                                     ConvBlock(width, width, stride=2),
                                     ConvBlock(width, 2 * width, stride=2)])

    def forward(self, images: Tensor) -> Tensor:
        b, n, h, w, c = images.shape
        x = images.reshape(b * n, h, w, c).to(torch.bfloat16).permute(0, 3, 1, 2)
        for block in self.blocks:
            x = block(x)
        x = x.to(torch.bfloat16)
        cf, hf, wf = x.shape[1:]
        return x.permute(0, 2, 3, 1).reshape(b, n * hf * wf, cf)


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention(num_heads, qkv_features=dim,
    dtype=bf16)`` with q from the queries and k = v from the tokens."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q_in: Tensor, tokens: Tensor) -> Tensor:
        bf = torch.bfloat16
        b, nq, dim = q_in.shape
        d = dim // self.heads
        q = dense(q_in, self.query, bf).reshape(b, nq, self.heads, d)
        k = dense(tokens, self.key, bf).reshape(b, tokens.shape[1], self.heads, d)
        v = dense(tokens, self.value, bf).reshape(b, tokens.shape[1], self.heads, d)
        q = q / torch.full((), math.sqrt(d), dtype=bf, device=q.device)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        e = torch.exp(w - w.amax(dim=-1, keepdim=True).detach())
        w = e / e.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, nq, dim)
        return dense(o, self.out, bf)


class DecoderLayer(nn.Module):
    """Pre-norm cross-attention to the tokens + a 4x MLP (bf16)."""

    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.norm0 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn = Attention(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.mlp0 = nn.Linear(dim, 4 * dim)
        self.mlp1 = nn.Linear(4 * dim, dim)

    def forward(self, queries: Tensor, tokens: Tensor) -> Tensor:
        bf = torch.bfloat16
        q = layer_norm(queries, self.norm0)
        queries = queries + self.attn(q.to(bf), tokens).float()
        y = layer_norm(queries, self.norm1)
        y = F.relu(dense(y, self.mlp0, bf))
        return queries + dense(y, self.mlp1, bf).float()


class PETRDetector(nn.Module):
    """Multi-camera query-based 3-D detector.

    ``num_memory > 0`` makes it streaming: ``num_memory`` extra query slots
    are filled from the previous frame's propagated top-k query features.
    ``motion_aware=True`` (needs ``num_memory > 0``) adds learned 3-D anchors
    for the fresh queries, the previous frame's centres compensated by
    ``ego_transform`` for the memory queries, a position encoder that adds
    them to the query features, and box xyz predicted as an offset from each
    query's reference; outputs gain ``ref_points (B, Q+M, 3)``. ``remat``
    recomputes each decoder layer in the backward pass
    (``torch.utils.checkpoint``); the parameters are the same with it or
    without it.
    """

    def __init__(self, num_queries: int = 128, num_classes: int = 10, dim: int = 128,
                 num_layers: int = 3, num_memory: int = 0, remat: bool = False,
                 motion_aware: bool = False):
        super().__init__()
        if motion_aware and num_memory <= 0:
            raise ValueError("motion_aware needs num_memory > 0")
        self.num_queries = num_queries
        self.num_classes = num_classes
        self.dim = dim
        self.num_layers = num_layers
        self.num_memory = num_memory
        self.remat = remat
        self.motion_aware = motion_aware
        self.backbone = CameraBackbone()
        self.token_proj = nn.Linear(2 * self.backbone.width, dim)
        self.queries = nn.Parameter(torch.zeros(num_queries, dim))
        if motion_aware:
            self.ref_anchors = nn.Parameter(torch.zeros(num_queries, 3))
            self.position_encoder_hidden = nn.Linear(3, dim)
            self.position_encoder_out = nn.Linear(dim, dim)
        if num_memory:
            self.memory_proj = nn.Linear(dim, dim)
        self.layers = nn.ModuleList([DecoderLayer(dim) for _ in range(num_layers)])
        self.head_boxes = nn.Linear(dim, 7)
        self.head_classes = nn.Linear(dim, num_classes)
        self.head_existence = nn.Linear(dim, 1)

    def pos_enc(self, x: Tensor) -> Tensor:
        return dense(F.relu(dense(x, self.position_encoder_hidden)), self.position_encoder_out)

    def forward(self, images: Tensor, memory: Optional[Tensor] = None,
                memory_ref: Optional[Tensor] = None,
                ego_transform: Optional[Tensor] = None) -> Dict[str, Tensor]:
        tokens = dense(self.backbone(images), self.token_proj, torch.bfloat16)
        b, dev = images.shape[0], images.device
        q = self.queries[None].expand(b, self.num_queries, self.dim).float()
        refs = None
        if self.motion_aware:
            refs = self.ref_anchors[None].expand(b, self.num_queries, 3)
            # the (Q, 3) anchors are encoded once and broadcast
            q = q + self.pos_enc(self.ref_anchors)[None].expand(b, self.num_queries, self.dim)
        if self.num_memory:
            if memory is None:
                memory = torch.zeros((b, self.num_memory, self.dim), device=dev)
            mem_q = dense(memory, self.memory_proj)
            if self.motion_aware:
                if memory_ref is None:
                    memory_ref = torch.zeros((b, self.num_memory, 3), device=dev)
                mem_ref = compensate_ref_points(memory_ref, ego_transform)
                mem_q = mem_q + self.pos_enc(mem_ref)
                refs = torch.cat([refs, mem_ref], dim=1)
            q = torch.cat([q, mem_q], dim=1)
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                q = checkpoint(layer, q, tokens, use_reentrant=False)
            else:
                q = layer(q, tokens)
        boxes = dense(q, self.head_boxes)
        if self.motion_aware:
            boxes = torch.cat([boxes[..., :3] + refs, boxes[..., 3:]], dim=-1)
        out = {
            "boxes3d": boxes,
            "logits": dense(q, self.head_classes),
            "existence": dense(q, self.head_existence)[..., 0],
            "queries": q,
        }
        if self.motion_aware:
            out["ref_points"] = refs
        return out


def _lecun_normal_(weight: Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / LECUN_TRUNCATION
    draws = torch.empty(weight.shape, dtype=weight.dtype)
    nn.init.trunc_normal_(draws, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    weight.copy_(draws)


def init_params(model: PETRDetector, generator: torch.Generator) -> PETRDetector:
    """flax's initialisers, drawn on the CPU from ``generator``:
    ``lecun_normal`` kernels (fan-in over the contracted axes), zero biases,
    unit norm scales, queries normal(0.02), anchors normal(1.0). The
    distribution matches flax's, the bits cannot."""
    with torch.no_grad():
        for block in model.backbone.blocks:
            w = block.conv.weight
            _lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3], generator)
            block.norm.weight.fill_(1.0)
            block.norm.bias.zero_()
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                _lecun_normal_(mod.weight, mod.weight.shape[1], generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        model.queries.copy_(torch.randn(model.queries.shape, generator=generator) * 0.02)
        if model.motion_aware:
            model.ref_anchors.copy_(torch.randn(model.ref_anchors.shape, generator=generator))
    return model


def compensate_ref_points(ref_points: Tensor, ego_transform: Optional[Tensor]) -> Tensor:
    """Apply an ego-motion transform ``(B, 4, 4)`` (frame t-1 ego coords ->
    frame t, homogeneous) to ``ref_points (B, M, 3)``; ``None`` is the
    identity."""
    if ego_transform is None:
        return ref_points
    rot = ego_transform[:, :3, :3]
    trans = ego_transform[:, :3, 3]
    return torch.einsum("bij,bmj->bmi", rot, ref_points) + trans[:, None, :]


def _top_k(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``lax.top_k`` along the last axis: descending, ties to the lower
    index (a stable sort; ``torch.topk`` gives no tie order on the card)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _select_topk_queries(outputs: Dict[str, Any], num_memory: int):
    """Top-``num_memory`` queries by existence score: ``(gated_feats, idx,
    top_scores)``."""
    scores = torch.sigmoid(outputs["existence"])
    top_scores, idx = _top_k(scores, num_memory)
    q = outputs["queries"]
    feats = torch.gather(q, 1, idx[..., None].expand(*idx.shape, q.shape[-1]))
    return feats * top_scores[..., None], idx, top_scores


def propagate_queries_with_motion(outputs: Dict[str, Any],
                                  num_memory: int) -> Tuple[Tensor, Tensor]:
    """The top-``num_memory`` queries' (features, predicted centres), both
    gated by their existence scores: the next frame's memory and memory
    reference points. Needs ``motion_aware=True`` outputs."""
    feats, idx, top_scores = _select_topk_queries(outputs, num_memory)
    centers = torch.gather(outputs["boxes3d"][..., :3], 1, idx[..., None].expand(*idx.shape, 3))
    return feats, centers * top_scores[..., None]


def propagate_queries(outputs: Dict[str, Any], num_memory: int) -> Tensor:
    """The top-``num_memory`` queries' features, gated by their existence
    scores: ``(B, num_memory, dim)``."""
    return _select_topk_queries(outputs, num_memory)[0]


def decode_detections_3d(outputs: Dict[str, Tensor], max_detections: int = 64,
                         score_threshold: float = 0.3) -> Dict[str, RaggedBatch]:
    """Existence-gated class scores -> per-sample top-k -> ragged 3-D
    detections (no NMS). Scores sort descending, so the valid detections
    form the prefix. Returns RaggedBatch ``boxes3d (B, K, 7)``,
    ``scores (B, K)``, ``classes (B, K)`` int32."""
    logits = outputs["logits"]
    k = min(max_detections, logits.shape[1])
    cls_prob = torch.softmax(logits, dim=-1)
    exist = torch.sigmoid(outputs["existence"])[:, :, None]
    score_per_query = (cls_prob * exist).amax(dim=-1)
    cls_per_query = cls_prob.argmax(dim=-1).to(torch.int32)
    scores, idx = _top_k(score_per_query, k)
    boxes = torch.gather(outputs["boxes3d"], 1, idx[:, :, None].expand(*idx.shape, 7))
    classes = torch.gather(cls_per_query, 1, idx)
    num_valid = (scores > score_threshold).sum(dim=1, dtype=torch.int32)
    return {
        "boxes3d": RaggedBatch(boxes, sample_sizes=num_valid),
        "scores": RaggedBatch(scores, sample_sizes=num_valid),
        "classes": RaggedBatch(classes, sample_sizes=num_valid),
    }


def petr_loss(outputs: Dict[str, Any], gt_boxes: RaggedBatch, gt_classes: RaggedBatch,
              matches_gt: RaggedBatch, matches_pred: RaggedBatch) -> Dict[str, Tensor]:
    """Batched matched loss: L1 on matched boxes, CE on matched classes, BCE
    existence over all queries (the reference's StreamPETR batched loss)."""
    gt_box_m = batched_indexing_access(gt_boxes, matches_gt)
    gt_cls_m = batched_indexing_access(gt_classes, matches_gt)
    pred_box_m = batched_indexing_access(outputs["boxes3d"], matches_pred)
    pred_logit_m = batched_indexing_access(outputs["logits"], matches_pred)

    box_l1 = torch.abs(gt_box_m.tensor - pred_box_m.tensor).sum(dim=-1)
    box_loss = average_over_targets(gt_box_m.create_with_sample_sizes_like_self(box_l1)).mean()
    ce = -torch.log_softmax(pred_logit_m.tensor, dim=-1)
    cls_data = torch.gather(ce, -1, gt_cls_m.tensor.to(torch.int64)[..., None])[..., 0]
    cls_loss = average_over_targets(gt_cls_m.create_with_sample_sizes_like_self(cls_data)).mean()
    target = get_mask_from_indices(outputs["existence"].shape[1], matches_pred).float()
    p = torch.sigmoid(outputs["existence"])
    ex_loss = -(target * torch.log(p + 1e-8) + (1 - target) * torch.log(1 - p + 1e-8)).mean()
    total = box_loss * 0.25 + cls_loss + ex_loss
    return {"loss": total, "box_loss": box_loss, "cls_loss": cls_loss, "existence_loss": ex_loss}


def _batch_loss(outputs, batch):
    return petr_loss(outputs, batch["gt_boxes"], batch["gt_classes"], batch["matches_gt"],
                     batch["matches_pred"])


def adamw(params) -> torch.optim.Optimizer:
    """``optax.adamw(2e-4)``'s counterpart: optax's defaults are b1 0.9, b2
    0.999, eps 1e-8 and weight decay 1e-4 on every leaf (torch's AdamW
    defaults to 1e-2, so it is given)."""
    return torch.optim.AdamW(params, lr=2e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def _init(model: PETRDetector, make_optimizer, key, example_images, device):
    dev = device_of(example_images, device)
    gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
    init_params(model, gen).to(dev)
    return model, make_optimizer(model.parameters()), dev


def _grad_update(model: PETRDetector, opt: torch.optim.Optimizer, batch, *inputs):
    """One step: forward, the set loss, backward, one optimizer update.
    Returns ``(outputs, detached losses)``."""
    outputs = model(batch["images"], *inputs)
    losses = _batch_loss(outputs, batch)
    opt.zero_grad(set_to_none=True)
    losses["loss"].backward()
    opt.step()
    return outputs, {k: v.detach() for k, v in losses.items()}


def make_petr_train_step(model: PETRDetector,
                         optimizer: Optional[Callable[[Any], torch.optim.Optimizer]] = None):
    """``(init_fn, train_step)``. ``init_fn(key, example_images, device=None)``
    draws the parameters from ``key`` (a ``torch.Generator`` or an int) onto
    the images' device (default the card) and returns ``(model, optimizer)``;
    ``train_step(model, optimizer, batch)`` runs one step in place and
    returns ``(model, optimizer, metrics)`` with detached device scalars.
    ``optimizer`` builds the optimizer from the parameters (default
    :func:`adamw`)."""
    make_optimizer = optimizer or adamw

    def init_fn(key, example_images, device=None):
        return _init(model, make_optimizer, key, example_images, device)[:2]

    def train_step(params: PETRDetector, opt_state: torch.optim.Optimizer, batch):
        _, metrics = _grad_update(params, opt_state, batch)
        return params, opt_state, metrics

    return init_fn, train_step


def make_streaming_petr_train_step(model: PETRDetector, optimizer=None):
    """Streaming variant: ``init_fn`` also returns the zero memory ``(B,
    num_memory, dim)``; ``train_step(model, optimizer, batch, memory)``
    returns ``(model, optimizer, new_memory, metrics)``. The propagated
    memory is detached (the JAX package stops its gradient): each frame
    trains alone while conditioning on the previous frame's queries."""
    if model.num_memory <= 0:
        raise ValueError("streaming training needs num_memory > 0")
    make_optimizer = optimizer or adamw

    def init_fn(key, example_images, device=None):
        model_, opt, dev = _init(model, make_optimizer, key, example_images, device)
        memory0 = torch.zeros((example_images.shape[0], model.num_memory, model.dim), device=dev)
        return model_, opt, memory0

    def train_step(params: PETRDetector, opt_state: torch.optim.Optimizer, batch, memory):
        outputs, metrics = _grad_update(params, opt_state, batch, memory)
        new_memory = propagate_queries(outputs, params.num_memory).detach()
        return params, opt_state, new_memory, metrics

    return init_fn, train_step


def make_motion_petr_train_step(model: PETRDetector, optimizer=None):
    """Streaming step with motion-aware memory: the carry is ``(memory,
    memory_ref)`` and each batch may supply ``ego_transform (B, 4, 4)``.
    ``train_step(model, optimizer, batch, memory, memory_ref)`` returns
    ``(model, optimizer, new_memory, new_memory_ref, metrics)``; the carry
    is detached."""
    if not (model.motion_aware and model.num_memory > 0):
        raise ValueError("make_motion_petr_train_step needs motion_aware=True and num_memory > 0")
    make_optimizer = optimizer or adamw

    def init_fn(key, example_images, device=None):
        model_, opt, dev = _init(model, make_optimizer, key, example_images, device)
        b = example_images.shape[0]
        memory0 = torch.zeros((b, model.num_memory, model.dim), device=dev)
        ref0 = torch.zeros((b, model.num_memory, 3), device=dev)
        return model_, opt, memory0, ref0

    def train_step(params: PETRDetector, opt_state: torch.optim.Optimizer, batch, memory,
                   memory_ref):
        outputs, metrics = _grad_update(params, opt_state, batch, memory, memory_ref,
                                        batch.get("ego_transform"))
        new_memory, new_ref = propagate_queries_with_motion(outputs, params.num_memory)
        return params, opt_state, new_memory.detach(), new_ref.detach(), metrics

    return init_fn, train_step


def make_petr_example_batch(batch_size=2, num_cams=2, hw=(32, 48), max_gt=12, num_classes=10,
                            seed=0, num_queries=128, device=None):
    """The JAX package's example batch (the same numbers for the same
    arguments) on ``device`` (default the card). ``num_queries`` must be the
    model's total query count (queries + memory slots): ``matches_pred``
    indices are drawn from it."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, max_gt + 1, (batch_size,)).astype(np.int32)
    put = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    mk = lambda x: RaggedBatch(put(x), sample_sizes=put(sizes))  # noqa: E731
    matches = np.stack([rng.permutation(max_gt) for _ in range(batch_size)]).astype(np.int32)
    return {
        "images": put(rng.uniform(0, 1, (batch_size, num_cams, *hw, 3)).astype(np.float32)),
        "gt_boxes": mk(rng.normal(size=(batch_size, max_gt, 7)).astype(np.float32)),
        "gt_classes": mk(rng.integers(0, num_classes, (batch_size, max_gt)).astype(np.float32)),
        "matches_gt": mk(matches),
        "matches_pred": mk(rng.integers(0, num_queries, (batch_size, max_gt)).astype(np.int32)),
    }
