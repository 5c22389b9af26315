"""Polyline arc-length interpolation.

PyTorch port of ``accvlab_tpu/polyline/functions.py``: the prefix sum of
segment lengths, a per-sample ``searchsorted`` and the lerp, in the JAX
module's arithmetic order. The JAX package hands these ops to XLA and has no
Pallas kernel for them, so the port has none either: every function is a
plain chain of torch ops on the inputs' device, and autograd differentiates
it as ``jax.grad`` differentiates the JAX functions.

Semantics (as in the JAX package):

* distances below 0 clamp to the first point; beyond the total length to
  the last (valid) point; ``relative=True`` scales by the total length first;
* a segment shorter than float eps contributes its first point (no divide);
* empty polylines (0 points) give NaN samples and NaN length; in the
  var-size forms, samples past a polyline's ``num_distances`` are 0.

Differences that are not bugs:

* ``torch.cumsum`` adds in sequence; XLA's CPU ``cumsum`` does not, so arc
  lengths may differ from the JAX package's by a few float32 ulps of the
  total length, and the samples with them;
* the gradient is NaN at repeated points (and at the padded points of the
  var-size forms): ``sqrt`` of a zero segment, before the mask. The JAX
  functions give NaN at the same places.

Tensors stay on their device; other array-likes go to ``device`` (default
the CUDA device, which raises without a card; pass ``device="cpu"``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .._device import DeviceLike, device_of
from ..ragged import RaggedBatch

Tensor = torch.Tensor


def _as_input(x, device: DeviceLike) -> Tensor:
    dev = device_of(x, device)
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, device=dev)


def _accum_distances(points: Tensor, num_valid: Optional[Tensor] = None) -> Tensor:
    """Per-sample prefix sum of segment lengths. points (B, N, D) -> (B, N)."""
    diffs = points[:, 1:] - points[:, :-1]
    seg = torch.sqrt(torch.sum(diffs * diffs, dim=-1))  # (B, N-1)
    if num_valid is not None:
        # zero out segments past the valid range so accum plateaus at the total
        seg_idx = torch.arange(seg.shape[1], device=seg.device)
        seg = torch.where(seg_idx[None, :] < num_valid[:, None] - 1, seg, 0.0)
    zeros = torch.zeros((points.shape[0], 1), dtype=seg.dtype, device=seg.device)
    return torch.cat([zeros, torch.cumsum(seg, dim=1)], dim=1)


def _take(values: Tensor, idx: Tensor) -> Tensor:
    """``take_along_axis(values, idx, axis=1)`` with trailing dims broadcast."""
    if values.ndim == 3:
        idx = idx[:, :, None].expand(-1, -1, values.shape[2])
    return torch.gather(values, 1, idx)


def _interpolate_impl(points: Tensor, distances: Tensor, relative: bool,
                      num_points_valid: Optional[Tensor],
                      num_dist_valid: Optional[Tensor]) -> Tensor:
    b, n, d = points.shape
    dev = points.device
    if n == 0:
        return torch.full((b, distances.shape[1], d), float("nan"), dtype=points.dtype,
                          device=dev)

    accum = _accum_distances(points, num_points_valid)
    if num_points_valid is None:
        nv = torch.full((b,), n, dtype=torch.int64, device=dev)
    else:
        nv = num_points_valid.to(torch.int64)
    last = torch.clamp(nv - 1, min=0)[:, None]  # (B, 1)
    total = torch.gather(accum, 1, last)[:, 0]

    dist = distances.to(accum.dtype)
    if relative:
        dist = dist * total[:, None]

    # index of the last accum entry <= dist; equal runs resolve to the last entry
    idx = torch.searchsorted(accum.contiguous(), dist.contiguous(), right=True) - 1

    below = idx < 0  # distance < 0 -> first point
    beyond = idx >= last  # distance >= total -> last valid point

    lo = torch.clamp(idx, 0, max(n - 2, 0))
    hi = torch.clamp(lo + 1, max=n - 1)
    d_lo = torch.gather(accum, 1, lo)
    d_hi = torch.gather(accum, 1, hi)
    seg_len = d_hi - d_lo
    eps = torch.finfo(accum.dtype).eps
    long_enough = seg_len >= eps
    w_hi = torch.where(long_enough, (dist - d_lo) / torch.where(long_enough, seg_len, 1.0), 0.0)

    p_lo = _take(points, lo)
    p_hi = _take(points, hi)
    interp = p_lo + (p_hi - p_lo) * w_hi[:, :, None].to(points.dtype)

    p_first = points[:, 0:1].expand_as(interp)
    p_last = _take(points, last).expand_as(interp)
    res = torch.where(below[:, :, None], p_first, interp)
    res = torch.where(beyond[:, :, None], p_last, res)

    # empty polylines -> NaN
    empty = (nv == 0)[:, None, None]
    res = torch.where(empty, float("nan"), res)
    if num_dist_valid is not None:
        valid_d = torch.arange(distances.shape[1], device=dev) < num_dist_valid[:, None]
        res = torch.where(valid_d[:, :, None], res, 0.0)
    return res


def interpolate(points, distances, *, relative: bool = False,
                device: DeviceLike = None) -> Tensor:
    """Interpolate batched polylines at requested distances.

    Args:
        points: ``(batch, num_points, num_dims)``.
        distances: ``(batch, num_distances)``; clamped to the polyline ends.
        relative: interpret distances as fractions of the total length.
        device: where array-likes go (tensors stay on theirs).

    Returns:
        ``(batch, num_distances, num_dims)``.
    """
    points = _as_input(points, device)
    distances = _as_input(distances, points.device)
    return _interpolate_impl(points, distances, relative, None, None)


def lengths(points, *, device: DeviceLike = None) -> Tensor:
    """Total length of each polyline in a fixed-size batch; empty -> NaN."""
    points = _as_input(points, device)
    if points.shape[1] == 0:
        return torch.full((points.shape[0],), float("nan"), dtype=points.dtype,
                          device=points.device)
    return _accum_distances(points)[:, -1].to(points.dtype)


def interpolate_var_size_batch(points: RaggedBatch, distances: RaggedBatch, *,
                               relative: bool = False) -> RaggedBatch:
    """Interpolate variable-length batched polylines; the result has the
    distances' sample sizes."""
    assert points.num_batch_dims == 1, "points must have exactly one batch dimension"
    assert distances.num_batch_dims == 1, "distances must have exactly one batch dimension"
    assert points.non_uniform_dim == 1, (
        "points.non_uniform_dim must be 1 for shape (batch, max_num_points, num_dims)"
    )
    assert distances.non_uniform_dim == 1, (
        "distances.non_uniform_dim must be 1 for shape (batch, max_num_distances)"
    )
    res = _interpolate_impl(
        points.tensor,
        distances.tensor,
        relative,
        points.sample_sizes,
        distances.sample_sizes,
    )
    return distances.create_with_sample_sizes_like_self(res)


def lengths_var_size_batch(points: RaggedBatch) -> Tensor:
    """Total length of each polyline in a variable-size batch; empty -> NaN."""
    assert points.num_batch_dims == 1, "points must have exactly one batch dimension"
    assert points.non_uniform_dim == 1, (
        "points.non_uniform_dim must be 1 for shape (batch, max_num_points, num_dims)"
    )
    t = points.tensor
    nv = points.sample_sizes.to(torch.int64)
    if t.shape[1] == 0:
        return torch.full((t.shape[0],), float("nan"), dtype=t.dtype, device=t.device)
    accum = _accum_distances(t, nv)
    total = torch.gather(accum, 1, torch.clamp(nv - 1, min=0)[:, None])[:, 0]
    return torch.where(nv == 0, float("nan"), total).to(t.dtype)
