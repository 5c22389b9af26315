"""Point operators, batched (port of ``accvlab_tpu/pipeline/operators/point_ops.py``;
``pad_to_common_size`` is the host's numpy form).

Transforms are ``(..., 2, 3)`` (one per sample) and point sets ``(..., N, 2)``.
The 2x3 products are written out as multiply-adds in the order of a dot
product (no matrix-multiply library call, so no TF32 and no reordering).
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
