"""CenterNet-style detector + masked ragged loss.

PyTorch port of ``accvlab_tpu/models/centernet.py``. Inputs and outputs
keep the JAX package's NHWC contract: images ``(B, H, W, 3)``, heads
``(B, H/4, W/4, C)``. Inside, the images are viewed as NCHW in channels-last
memory, which cuDNN takes as it is.

Numerics follow flax's, not ``torch.autocast``'s:

* each ``ConvBlock`` casts its input and kernel to bfloat16 and its conv
  outputs bfloat16; GroupNorm then runs in float32 with flax's epsilon
  (1e-6) and fast variance (E[x²] − E[x]², clipped at 0); the heads are
  float32 convs. Parameters stay float32 and are cast inside ``forward``,
  so their gradients arrive in float32;
* convs pad ``'SAME'`` as XLA does: a stride-2 3x3 conv over an even size
  pads 0 before and 1 after, not 1 on both sides.

``torch.clamp`` and ``torch.maximum`` give the whole gradient to one side
at a tie where JAX splits it in halves; in :func:`focal_loss` that only
matters where the sigmoid lands exactly on 1e-6 or 1 − 1e-6.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import device_of, resolve_device
from ..ragged import RaggedBatch, average_over_targets, batched_indexing_access
from ..tools.trace_range import _profiled

Tensor = torch.Tensor

GROUPS = 8
GROUP_NORM_EPS = 1e-6  # flax's default (torch's is 1e-5)
LECUN_TRUNCATION = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _same_pads(n: int, k: int, s: int):
    """(before, after) padding of XLA's ``'SAME'`` for size ``n``, kernel
    ``k``, stride ``s``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d_same(x: Tensor, weight: Tensor, stride: int, bias: Optional[Tensor] = None) -> Tensor:
    """``F.conv2d`` of NCHW ``x`` with XLA's ``'SAME'`` padding."""
    (top, bottom), (left, right) = (_same_pads(x.shape[-2], weight.shape[-2], stride),
                                    _same_pads(x.shape[-1], weight.shape[-1], stride))
    if top == bottom and left == right:
        return F.conv2d(x, weight, bias, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, bias, stride=stride)


def group_norm(x: Tensor, scale: Tensor, bias: Tensor, num_groups: int = GROUPS,
               eps: float = GROUP_NORM_EPS) -> Tensor:
    """flax ``nn.GroupNorm(dtype=float32)`` of NCHW ``x``: statistics and
    output in float32, fast variance. Works on the NHWC view, so a
    channels-last ``x`` is not copied to regroup it."""
    b, c, h, w = x.shape
    shape = (1, 1, num_groups, c // num_groups)
    xg = x.permute(0, 2, 3, 1).reshape(b, h * w, num_groups, c // num_groups).float()
    mean = xg.mean(dim=(1, 3), keepdim=True)
    mean2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * scale.reshape(shape)
    y = (xg - mean) * mul + bias.reshape(shape)
    return y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class ConvBlock(nn.Module):
    """bf16 3x3 conv (no bias) -> float32 GroupNorm(8) -> ReLU.

    ``conv`` and ``norm`` hold the parameters (float32); ``forward`` applies
    them with flax's numerics, not through their own ``forward``.
    """

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(in_features, features, 3, stride=stride, bias=False)
        self.norm = nn.GroupNorm(GROUPS, features, eps=GROUP_NORM_EPS)

    def forward(self, x: Tensor) -> Tensor:
        x = conv2d_same(x.to(torch.bfloat16), self.conv.weight.to(torch.bfloat16), self.stride)
        return F.relu(group_norm(x, self.norm.weight, self.norm.bias))


class CenterNetDetector(nn.Module):
    """Small multi-camera CenterNet: conv backbone (stride 4) + 3 heads.

    Input ``(B, H, W, 3)`` float; outputs heatmap logits ``(B, H/4, W/4, C)``,
    offsets ``(B, H/4, W/4, 2)``, sizes ``(B, H/4, W/4, 2)``.
    """

    def __init__(self, num_classes: int = 10, width: int = 64):
        super().__init__()
        self.num_classes = num_classes
        self.width = width
        w = width
        self.blocks = nn.ModuleList([
            ConvBlock(3, w, stride=2),
            ConvBlock(w, w, stride=1),
            ConvBlock(w, 2 * w, stride=2),
            ConvBlock(2 * w, 2 * w, stride=1),
            ConvBlock(2 * w, 2 * w, stride=1),
        ])
        self.head_heatmap = nn.Conv2d(2 * w, num_classes, 1)
        self.head_offset = nn.Conv2d(2 * w, 2, 1)
        self.head_size = nn.Conv2d(2 * w, 2, 1)

    def heads(self) -> Dict[str, nn.Conv2d]:
        return {"heatmap": self.head_heatmap, "offset": self.head_offset,
                "size": self.head_size}

    def forward(self, images: Tensor) -> Dict[str, Tensor]:
        x = images.to(torch.bfloat16).permute(0, 3, 1, 2)
        for block in self.blocks:
            x = block(x)
        feat = x.float()
        return {name: F.conv2d(feat, head.weight, head.bias).permute(0, 2, 3, 1)
                for name, head in self.heads().items()}


def init_params(model: CenterNetDetector, generator: torch.Generator) -> CenterNetDetector:
    """flax's initialisers, drawn from ``generator``: ``lecun_normal``
    kernels (a normal truncated to ±2 std, scaled to variance 1/fan_in),
    zero biases, GroupNorm scale 1 and bias 0. The distribution matches
    flax's, the bits cannot. The draws are made on the CPU (``generator``
    is a CPU generator), so a model gets the same bits on any device."""
    convs = [b.conv for b in model.blocks] + list(model.heads().values())
    with torch.no_grad():
        for conv in convs:
            fan_in = conv.weight.shape[1] * conv.weight.shape[2] * conv.weight.shape[3]
            std = math.sqrt(1.0 / fan_in) / LECUN_TRUNCATION
            draws = torch.empty(conv.weight.shape, dtype=conv.weight.dtype)
            nn.init.trunc_normal_(draws, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            conv.weight.copy_(draws)
            if conv.bias is not None:
                conv.bias.zero_()
        for block in model.blocks:
            block.norm.weight.fill_(1.0)
            block.norm.bias.zero_()
    return model


def focal_loss(pred_logits: Tensor, target_heatmap: Tensor, alpha: float = 2.0,
               beta: float = 4.0) -> Tensor:
    """Penalty-reduced pixel-wise focal loss (CenterNet eq. 1)."""
    pred = torch.sigmoid(pred_logits)
    pred = torch.clamp(pred, 1e-6, 1.0 - 1e-6)
    pos = target_heatmap >= 0.999
    pos_loss = -torch.log(pred) * (1.0 - pred) ** alpha
    neg_loss = -torch.log(1.0 - pred) * pred**alpha * (1.0 - target_heatmap) ** beta
    loss = torch.where(pos, pos_loss, neg_loss)
    num_pos = pos.sum().to(loss.dtype).clamp(min=1.0)
    return loss.sum() / num_pos


def centernet_loss(outputs: Dict[str, Any], targets: Dict[str, Any]) -> Dict[str, Tensor]:
    """Full detection loss.

    ``targets``: ``heatmap (B, Hf, Wf, C)``; ``centers`` RaggedBatch
    ``(B, T, 2)`` int (x, y in feature coords); ``offsets`` RaggedBatch
    ``(B, T, 2)``; ``sizes`` RaggedBatch ``(B, T, 2)`` as **(w, h)** in
    feature coords (the pipeline's ``hw`` annotation is (h, w): flip it
    when building targets).

    The per-object terms gather head outputs at the (ragged) center
    locations with :func:`batched_indexing_access`, whose adjoint sums
    duplicate centres in a fixed order, and reduce with
    :func:`average_over_targets`.
    """
    heat_loss = focal_loss(outputs["heatmap"], targets["heatmap"])

    centers: RaggedBatch = targets["centers"]
    b = outputs["offset"].shape[0]
    wf = outputs["offset"].shape[2]
    flat_idx = centers.tensor[..., 1] * wf + centers.tensor[..., 0]  # (B, T)
    idx = centers.create_with_sample_sizes_like_self(flat_idx.to(torch.int32))

    def gather_per_object(head):  # (B, Hf, Wf, 2) -> RaggedBatch (B, T, 2)
        flat = head.reshape(b, -1, head.shape[-1])
        return batched_indexing_access(flat, idx)

    pred_offset = gather_per_object(outputs["offset"])
    pred_size = gather_per_object(outputs["size"])

    def l1(pred_rb: RaggedBatch, tgt_rb: RaggedBatch):
        diff = pred_rb.apply(lambda t: torch.abs(t - tgt_rb.tensor))
        return average_over_targets(diff).mean()

    offset_loss = l1(pred_offset, targets["offsets"])
    size_loss = l1(pred_size, targets["sizes"])
    total = heat_loss + offset_loss + 0.1 * size_loss
    return {
        "loss": total,
        "heatmap_loss": heat_loss,
        "offset_loss": offset_loss,
        "size_loss": size_loss,
    }


def decode_detections(
    outputs: Dict[str, Tensor],
    max_detections: int = 100,
    score_threshold: float = 0.1,
    stride: int = 4,
) -> Dict[str, RaggedBatch]:
    """NMS-free CenterNet decode: peaks are local maxima of the sigmoid
    heatmap (3x3 max-pool equality), then the best ``max_detections`` of all
    (pixel, class) scores per image. Scores are sorted with a stable sort,
    so equal scores keep ascending index order, as ``lax.top_k`` does.

    Returns RaggedBatch ``boxes (B, K, 4)`` as x1,y1,x2,y2 in input coords,
    ``scores (B, K)``, ``classes (B, K)`` int32; the valid detections (score
    above ``score_threshold``) form the prefix.
    """
    heat = torch.sigmoid(outputs["heatmap"])  # (B, Hf, Wf, C)
    b, hf, wf, c = heat.shape
    k = min(max_detections, hf * wf * c)

    pooled = F.max_pool2d(heat.permute(0, 3, 1, 2), 3, stride=1, padding=1).permute(0, 2, 3, 1)
    peaks = torch.where(heat == pooled, heat, 0.0)

    scores, flat_idx = torch.sort(peaks.reshape(b, hf * wf * c), dim=1, descending=True,
                                  stable=True)
    scores, flat_idx = scores[:, :k], flat_idx[:, :k]
    classes = (flat_idx % c).to(torch.int32)
    pix = flat_idx // c
    ys = (pix // wf).to(torch.float32)
    xs = (pix % wf).to(torch.float32)

    off = outputs["offset"].reshape(b, hf * wf, 2)
    sz = outputs["size"].reshape(b, hf * wf, 2)
    off_k = torch.gather(off, 1, pix[:, :, None].expand(b, k, 2))  # (B, K, 2)
    sz_k = torch.gather(sz, 1, pix[:, :, None].expand(b, k, 2))

    cx = (xs + off_k[:, :, 0]) * stride
    cy = (ys + off_k[:, :, 1]) * stride
    w = sz_k[:, :, 0] * stride
    h = sz_k[:, :, 1] * stride
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)

    num_valid = (scores > score_threshold).sum(dim=1, dtype=torch.int32)
    return {
        "boxes": RaggedBatch(boxes, sample_sizes=num_valid),
        "scores": RaggedBatch(scores, sample_sizes=num_valid),
        "classes": RaggedBatch(classes, sample_sizes=num_valid),
    }


def adam(params) -> torch.optim.Optimizer:
    """``optax.adam(1e-3)``'s counterpart."""
    return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


def make_train_step(
    model: CenterNetDetector,
    optimizer: Optional[Callable[[Any], torch.optim.Optimizer]] = None,
):
    """Build ``(init_fn, train_step)``.

    ``init_fn(key, example_images, device=None)`` draws the parameters from
    ``key`` (a ``torch.Generator`` or an int seed), moves the model to the
    images' device (or to ``device`` for numpy images; default the card)
    and returns ``(model, optimizer)``. ``optimizer`` builds the optimizer
    from the parameters (default :func:`adam`).

    ``train_step(model, optimizer, batch, key=None)`` runs one step in
    place and returns ``(model, optimizer, metrics)``; the metrics are
    detached device scalars, so nothing is read back to the host.
    """
    make_optimizer = optimizer or adam

    def init_fn(key: Union[int, torch.Generator], example_images, device=None):
        dev = device_of(example_images, device)
        gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
        init_params(model, gen)
        model.to(dev)
        return model, make_optimizer(model.parameters())

    def train_step(params: CenterNetDetector, opt_state: torch.optim.Optimizer, batch, key=None):
        del key
        # each phase is an accvlab.train_step.* range while a profiler records
        with _profiled("accvlab.train_step.forward"):
            outputs = params(batch["images"])
        with _profiled("accvlab.train_step.loss"):
            losses = centernet_loss(outputs, batch["targets"])
        with _profiled("accvlab.train_step.optimizer"):
            opt_state.zero_grad(set_to_none=True)
        with _profiled("accvlab.train_step.backward"):
            losses["loss"].backward()
        with _profiled("accvlab.train_step.optimizer"):
            opt_state.step()
        return params, opt_state, {k: v.detach() for k, v in losses.items()}

    return init_fn, train_step


def make_example_batch(batch_size=2, hw=(64, 96), num_classes=10, max_targets=8, seed=0,
                       device=None):
    """Tiny synthetic batch matching the pipeline's output contract (the
    same numbers as the JAX package's for the same arguments). ``device``
    defaults to the card."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    hf, wf = hw[0] // 4, hw[1] // 4
    images = rng.uniform(0, 1, (batch_size, *hw, 3)).astype(np.float32)
    sizes = rng.integers(1, max_targets + 1, (batch_size,)).astype(np.int32)
    centers = np.stack(
        [rng.integers(0, wf, (batch_size, max_targets)),
         rng.integers(0, hf, (batch_size, max_targets))],
        axis=-1,
    ).astype(np.int32)
    heatmap = np.zeros((batch_size, hf, wf, num_classes), np.float32)
    for b in range(batch_size):
        for t in range(sizes[b]):
            c = rng.integers(0, num_classes)
            heatmap[b, centers[b, t, 1], centers[b, t, 0], c] = 1.0
    put = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    mk = lambda x: RaggedBatch(put(x), sample_sizes=put(sizes))  # noqa: E731
    return {
        "images": put(images),
        "targets": {
            "heatmap": put(heatmap),
            "centers": mk(centers),
            "offsets": mk(rng.uniform(0, 1, (batch_size, max_targets, 2)).astype(np.float32)),
            "sizes": mk(rng.uniform(1, 8, (batch_size, max_targets, 2)).astype(np.float32)),
        },
    }
