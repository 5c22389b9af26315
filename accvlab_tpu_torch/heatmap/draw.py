"""Batched Gaussian heatmap rasterization (PyTorch + CUDA).

PyTorch counterpart of ``accvlab_tpu/heatmap/draw.py``. The two TPU kernels
there (``_batched_kernel`` and ``_tiled_kernel``) become one hand-written
CUDA rasterizer (``csrc/draw_heatmap.cu``, bound in :mod:`._kernel`), which
takes the raw centers, radii and counts and prepares the targets itself; next
to it sits a plain PyTorch version with the same arithmetic
(:func:`_prep_target_params` and :func:`raster_plain`).

Math (``draw_heatmap_cuda_kernel.cuh:36-48`` of the reference):

* ``diameter = 2 * radius + 1``; ``sigma = diameter / diameter_to_sigma_factor``;
  ``iv = 1 / (2 * sigma^2)``;
* a target contributes ``exp(-(dy^2 + dx^2) * iv) * k_scale`` to every pixel
  of its Chebyshev-radius box (``|dy| <= r``, ``|dx| <= r``);
* contributions combine with the existing heatmap via **max**.

``implementation=``: ``"auto"`` runs the CUDA kernel for CUDA tensors and the
plain version for CPU tensors; ``"kernel"`` demands the kernel (a CPU tensor
raises); ``"torch"`` runs the plain version on either device. Nothing falls
back quietly.

Out-of-range destination ids raise when the ids lie on the CPU (the eager
case: they can be read without a device sync) and are masked out otherwise
(a bad id matches no map and draws nothing; it is never clamped).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import device_of
from .._device import use_kernel as _use_kernel
from ..ragged import RaggedBatch
from . import _kernel
from .repro_exp import exp_f32


def _validate_ids_eager(ids: torch.Tensor, num_valid: int, what: str, live_mask=None):
    """Raise ``ValueError`` for out-of-range ids that lie on the CPU; ids on
    the card are never read back (that would sync the device per call) and
    get the mask-out semantics instead (parity: ``draw.py:63-105``)."""
    if ids.device.type != "cpu":
        return
    bad = (ids < 0) | (ids >= num_valid)
    if live_mask is not None:
        bad = bad & live_mask.to(bad.device)
    if bool(bad.any()):
        bad_vals = torch.unique(ids[bad]).tolist()
        raise ValueError(
            f"{what} out of range [0, {num_valid}): {bad_vals[:10]}"
            f"{' ...' if len(bad_vals) > 10 else ''}"
        )


def _gauss_inv_var(radii_f32: torch.Tensor, factor: float) -> torch.Tensor:
    """Reference order (cuh:62-64,40): diameter -> sigma -> var, then
    ``1/var``. Tensor-by-tensor IEEE division is correctly rounded on the CPU
    and on CUDA, which is what ``exact`` pins (``repro_exp.div_f32``)."""
    diameter = 2.0 * radii_f32 + 1.0
    sigma = diameter / torch.full_like(diameter, float(np.float32(factor)))
    var = 2.0 * sigma * sigma
    return torch.ones_like(var) / var


def _prep_target_params(centers_t, radii_t, nums, factor):
    """(B, T, 2) centers / (B, T) radii / (B,) counts (None: all valid) -> f32
    (B, T) xs, ys, masked radii (invalid -> -1, in-box never true) and 1/var."""
    radii_f = radii_t.to(torch.float32)
    rr = radii_f
    if nums is not None:
        valid = torch.arange(radii_t.shape[1], device=radii_t.device)[None, :] < nums[:, None]
        rr = torch.where(valid, radii_f, torch.full_like(radii_f, -1.0))
    iv = _gauss_inv_var(radii_f, factor)
    xs = centers_t[:, :, 0].to(torch.float32)
    ys = centers_t[:, :, 1].to(torch.float32)
    return xs.contiguous(), ys.contiguous(), rr.contiguous(), iv.contiguous()


def _exp(x, exact: bool):
    return exp_f32(x) if exact else torch.exp(x)


def raster_plain(hm, xs, ys, rr, iv, sel, kt, k_scale, exact, log_domain):
    """Plain PyTorch version of the CUDA rasterizer on prepared targets
    (:func:`_prep_target_params`, or ``draw_gaussians.gaussian_params`` with
    its per-target peaks ``kt``), same arithmetic: ``(B, C, H, W)`` out."""
    b, c, h, w = hm.shape
    dev = hm.device
    py = torch.arange(h, device=dev, dtype=torch.float32).view(1, 1, h, 1)
    px = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, 1, w)

    def e(a):
        return a[:, :, None, None]

    dy = py - e(ys)  # (B, T, H, W)
    dx = px - e(xs)
    inbox = (dy.abs() <= e(rr)) & (dx.abs() <= e(rr))
    q = -(dy * dy + dx * dx) * e(iv)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    if log_domain:
        val = q
    elif kt is not None:
        val = _exp(q, exact) * e(kt)
    else:
        val = _exp(q, exact) * float(k_scale)
    maps = []
    for cls in range(c):
        m = inbox if sel is None else inbox & e(sel == cls)
        red = torch.where(m, val, neg_inf).amax(dim=1)  # (B, H, W)
        if log_domain:
            hit = red > neg_inf
            red = torch.where(
                hit, _exp(torch.where(hit, red, 0.0), exact) * float(k_scale), neg_inf
            )
        maps.append(red)
    return torch.maximum(hm, torch.stack(maps, dim=1))


def _rasterize(entry, kernel, hm, centers, radii, nums, sel, factor, k_scale, exact):
    """``hm`` (B, C, H, W), ``centers`` (B, T, 2), ``radii`` (B, T), ``nums``
    (B,) or None, ``sel`` (B, T) or None, on the kernel or its plain version."""
    log_domain = float(k_scale) > 0
    if kernel:
        return _kernel.launch_draw(entry, hm, centers.contiguous(), radii.contiguous(), nums,
                                   sel, factor, k_scale, exact, log_domain)
    xs, ys, rr, iv = _prep_target_params(centers, radii, nums, factor)
    return raster_plain(hm, xs, ys, rr, iv, sel, None, k_scale, exact, log_domain)


def _as_f32_map(heatmap, device) -> torch.Tensor:
    dev = device_of(heatmap, device)
    return torch.as_tensor(
        heatmap if isinstance(heatmap, torch.Tensor) else np.asarray(heatmap),
        dtype=torch.float32, device=dev,
    )


def _as_int(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=torch.int32)


def draw_heatmap(
    heatmaps,
    centers,
    radii,
    heatmap_idxes,
    diameter_to_sigma_factor: float = 6.0,
    k_scale: float = 1.0,
    implementation: str = "auto",
    exact: bool = False,
    device=None,
) -> torch.Tensor:
    """Flat-format heatmap drawing (explicit per-target heatmap indices).

    Parity: ``accvlab_tpu.heatmap.draw_heatmap``. Functional: returns new
    heatmaps.

    Args:
        heatmaps: ``(num_heatmaps, H, W)`` float32 (tensor; a numpy array
            goes to ``device``, default CUDA).
        centers: ``(num_targets, 2)`` int — x, y per target.
        radii: ``(num_targets,)`` int.
        heatmap_idxes: ``(num_targets,)`` int — destination heatmap per target.
        exact: ``True`` pins the bit-reproducible exp (identical bits on the
            CPU, on CUDA and in the committed golden artifacts).
    """
    hm = _as_f32_map(heatmaps, device)
    dev = hm.device
    kernel = _use_kernel(implementation, dev)
    idx_raw = heatmap_idxes if isinstance(heatmap_idxes, torch.Tensor) else torch.as_tensor(
        np.asarray(heatmap_idxes)
    )
    _validate_ids_eager(idx_raw, hm.shape[0], "heatmap_idxes")
    centers = _as_int(centers, dev).reshape(-1, 2)
    radii = _as_int(radii, dev).reshape(-1)
    idxes = _as_int(idx_raw, dev).reshape(-1)
    if centers.shape[0] == 0:  # no targets -> nothing to draw
        return hm
    # the flat format is the classwise rasterizer with one mega-sample whose
    # targets are all valid: maps act as classes, every target selects its
    # map via heatmap_idxes
    out = _rasterize(
        "draw_heatmap", kernel, hm[None], centers[None], radii[None], None,
        idxes[None].contiguous(), diameter_to_sigma_factor, k_scale, exact,
    )
    return out[0]


def draw_heatmap_batched(
    heatmap,
    centers: RaggedBatch,
    radii: RaggedBatch,
    diameter_to_sigma_factor: float = 6.0,
    k_scale: float = 1.0,
    labels: Optional[RaggedBatch] = None,
    implementation: str = "auto",
    exact: bool = False,
    device=None,
) -> torch.Tensor:
    """Draw heatmaps for a batch of samples (optionally classwise).

    Parity: ``accvlab_tpu.heatmap.draw_heatmap_batched``.

    Args:
        heatmap: ``(batch, H, W)`` — or ``(batch, num_classes, H, W)`` when
            ``labels`` is given.
        centers: RaggedBatch ``(batch, max_num_targets, 2)`` (x, y).
        radii: RaggedBatch ``(batch, max_num_targets)``.
        labels: optional RaggedBatch ``(batch, max_num_targets)`` of class ids.
        exact: ``True`` pins the bit-reproducible exp.
    """
    hm = _as_f32_map(heatmap, device)
    dev = hm.device
    kernel = _use_kernel(implementation, dev)
    centers_t = _as_int(centers.tensor, dev)
    radii_t = _as_int(radii.tensor, dev)
    assert centers_t.shape[0] == radii_t.shape[0], (
        "centers and radii must have the same size batch size"
    )
    assert centers_t.shape[1] == radii_t.shape[1], (
        "centers and radii must have the same maximum number of objects"
    )
    nums = _as_int(centers.sample_sizes, dev).contiguous()
    t = radii_t.shape[1]

    if labels is None:
        if t == 0:
            return hm
        out = _rasterize(
            "draw_heatmap_batched", kernel, hm[:, None], centers_t, radii_t, nums, None,
            diameter_to_sigma_factor, k_scale, exact,
        )
        return out[:, 0]

    labels_raw = labels.tensor
    labels_t = _as_int(labels_raw, dev)
    assert centers_t.shape[0] == labels_t.shape[0], (
        "centers and labels must have the same size batch size"
    )
    assert centers_t.shape[1] == labels_t.shape[1], (
        "centers and labels must have the same maximum number of objects"
    )
    num_classes = hm.shape[1]
    # eager validation of LIVE targets' class ids (padding is unconstrained)
    if isinstance(labels_raw, torch.Tensor) and labels_raw.device.type == "cpu" \
            and centers.sample_sizes.device.type == "cpu":
        live = torch.arange(t)[None, :] < centers.sample_sizes.to(torch.int64)[:, None]
        _validate_ids_eager(labels_raw, num_classes, "labels", live_mask=live)
    if t == 0:
        return hm
    return _rasterize(
        "draw_heatmap_batched_classwise", kernel, hm, centers_t, radii_t, nums,
        labels_t.contiguous(), diameter_to_sigma_factor, k_scale, exact,
    )
