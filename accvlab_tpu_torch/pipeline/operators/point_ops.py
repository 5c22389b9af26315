"""Point operators, batched (port of ``accvlab_tpu/pipeline/operators/point_ops.py``;
``pad_to_common_size`` is the host's numpy form).

Transforms are ``(..., 2, 3)`` (one per sample) and point sets ``(..., N, 2)``.
The 2x3 products are written out as multiply-adds in the order of a dot
product (no matrix-multiply library call, so no TF32 and no reordering).
``apply_transform_to_points`` and ``add_post_transform_to_projection_matrix``
take numpy arrays (the JAX package's numpy form, on the host) or tensors
(batched, on the tensor's device).
"""

from __future__ import annotations

import numpy as np
import torch


def transform_points(pts: torch.Tensor, trafo: torch.Tensor) -> torch.Tensor:
    """``(..., N, 2)`` points through ``(..., 2, 3)`` homogeneous transforms."""
    t = trafo.to(torch.float32)[..., None, :, :]  # (..., 1, 2, 3)
    x, y = pts[..., 0], pts[..., 1]
    xo = t[..., 0, 0] * x + t[..., 0, 1] * y + t[..., 0, 2]
    yo = t[..., 1, 0] * x + t[..., 1, 1] * y + t[..., 1, 2]
    return torch.stack([xo, yo], dim=-1)


def homogeneous(transform: torch.Tensor) -> torch.Tensor:
    """``(..., 2, 3)`` affines as ``(..., 3, 3)`` with the row ``0 0 1``."""
    bottom = torch.zeros_like(transform[..., :1, :])
    bottom[..., 2] = 1.0
    return torch.cat([transform, bottom], dim=-2)


def _on_device_of(a, b):
    """``(a, b)`` as float32 tensors on the device of the one that is a
    tensor, or None when neither is (the numpy form)."""
    t = a if isinstance(a, torch.Tensor) else b if isinstance(b, torch.Tensor) else None
    if t is None:
        return None
    return (torch.as_tensor(a, dtype=torch.float32, device=t.device),
            torch.as_tensor(b, dtype=torch.float32, device=t.device))


def apply_transform_to_points(points, transform):
    """Apply a homogeneous 2-D transform to a point set whose rows hold one or
    more (x, y) pairs. Parity: ``point_ops.py:14``.

    ``points``: ``(*batch, ..., 2*k)``; ``transform``: ``(*batch, 2, 3)`` or
    ``(*batch, 3, 3)`` (its first two rows are applied).
    """
    pair = _on_device_of(points, transform)
    if pair is None:
        points = np.asarray(points, dtype=np.float32)
        transform = np.asarray(transform, dtype=np.float32)
    else:
        points, transform = pair
    if points.size == 0 if pair is None else points.numel() == 0:
        return np.zeros_like(points) if pair is None else torch.zeros_like(points)
    row_length = points.shape[-1]
    if row_length % 2:
        raise ValueError(
            "apply_transform_to_points(): rows must contain (x, y) pairs, got "
            f"a row length of {row_length}."
        )
    if pair is not None:
        # every (x, y) pair of a sample in one row: (*batch, pairs, 2)
        pairs = points.reshape(*points.shape[:-1], row_length // 2, 2)
        moved = transform_points(pairs.flatten(transform.dim() - 2, -2), transform)
        return moved.reshape(points.shape)
    outs = []
    for i in range(row_length // 2):
        pts = points[:, 2 * i:2 * i + 2].T  # (2, N)
        homog = np.concatenate([pts, np.ones((1, pts.shape[1]), np.float32)], axis=0)
        outs.append((transform @ homog)[:2].T)
    return np.concatenate(outs, axis=1).astype(points.dtype)


def add_post_transform_to_projection_matrix(proj_mat, transform):
    """Left-compose a 2x3 image-space transform onto a 3x? projection matrix:
    ``[transform; 0 0 1] @ proj_mat`` (batched over leading dims).
    Parity: ``point_ops.py:42``."""
    pair = _on_device_of(proj_mat, transform)
    if pair is not None:
        proj_mat, transform = pair
        return torch.matmul(homogeneous(transform), proj_mat)
    proj_mat = np.asarray(proj_mat, dtype=np.float32)
    transform = np.asarray(transform, dtype=np.float32)
    full = np.concatenate([transform, np.array([[0.0, 0.0, 1.0]], np.float32)], axis=0)
    return full @ proj_mat


def apply_clipping_and_get_with_clipping_info(rects, centers, scaling_trafo, image_hw):
    """Transform boxes/centers by a homogeneous 2-D transform, clip to the
    image, and report clipped sizes + surviving area fraction.
    Parity: ``point_ops.py:53``.

    Returns ``(rects_clipped, centers_clipped, hw_clipped, fraction_area)``.
    """
    rects = rects.to(torch.float32)
    centers = centers.to(torch.float32)
    h, w = image_hw[0], image_hw[1]
    p1 = transform_points(rects[..., :2], scaling_trafo)
    p2 = transform_points(rects[..., 2:], scaling_trafo)
    x1c = torch.clamp(p1[..., 0], 0, w - 1)
    y1c = torch.clamp(p1[..., 1], 0, h - 1)
    x2c = torch.clamp(p2[..., 0], 0, w - 1)
    y2c = torch.clamp(p2[..., 1], 0, h - 1)
    rects_clipped = torch.stack([x1c, y1c, x2c, y2c], dim=-1)

    h_clipped = (y2c - y1c).abs()
    w_clipped = (x2c - x1c).abs()
    h_orig = (p2[..., 1] - p1[..., 1]).abs()
    w_orig = (p2[..., 0] - p1[..., 0]).abs()
    hw_clipped = torch.stack([h_clipped, w_clipped], dim=-1)
    fraction_area = (h_clipped * w_clipped) / (h_orig * w_orig)

    c = transform_points(centers, scaling_trafo)
    centers_clipped = torch.stack(
        [torch.clamp(c[..., 0], 0, w - 1), torch.clamp(c[..., 1], 0, h - 1)], dim=-1
    )
    return rects_clipped, centers_clipped, hw_clipped, fraction_area


def get_is_active(
    hw,
    classes,
    fraction_areas,
    min_object_size,
    per_class_min_object_sizes,
    num_classes: int,
    min_fraction_area_thresh: float,
):
    """Per-object active mask from class validity, min (per-class) size, and
    surviving-area fraction. Parity: ``point_ops.py:98``."""
    hw = hw.to(torch.float32)
    dev = hw.device
    ones = torch.ones(hw.shape[:-1], dtype=torch.bool, device=dev)
    if classes is not None:
        active_classes = classes < num_classes
        safe_classes = torch.where(active_classes, classes, torch.zeros_like(classes)).long()
        if per_class_min_object_sizes is not None:
            sizes = torch.as_tensor(per_class_min_object_sizes, dtype=torch.float32, device=dev)
            active_size = (hw[..., 0] >= sizes[safe_classes, 0]) & (
                hw[..., 1] >= sizes[safe_classes, 1]
            )
        elif min_object_size is not None:
            mo = [float(v) for v in min_object_size]
            active_size = (hw[..., 0] >= mo[0]) & (hw[..., 1] >= mo[1])
        else:
            active_size = ones
    else:
        active_classes = ones
        if min_object_size is not None:
            mo = [float(v) for v in min_object_size]
            active_size = (hw[..., 0] >= mo[0]) & (hw[..., 1] >= mo[1])
        else:
            active_size = ones
    active_area = fraction_areas >= min_fraction_area_thresh
    return active_classes & active_size & active_area


def pad_to_common_size(*inputs, fill_value: float):
    """Pad all inputs to their element-wise maximum shape (host, numpy).
    Parity: ``point_ops.py:140``."""
    inputs = [np.asarray(inp) for inp in inputs]
    max_shape = np.stack([np.array(inp.shape) for inp in inputs], axis=0).max(axis=0)
    return tuple(
        np.pad(inp, [(0, int(max_shape[d] - inp.shape[d])) for d in range(inp.ndim)],
               constant_values=fill_value)
        for inp in inputs
    )
