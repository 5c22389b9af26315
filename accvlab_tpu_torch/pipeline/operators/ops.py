"""Box operators used by the heatmap step, batched (port of the matching
functions of ``accvlab_tpu/pipeline/operators/ops.py``; the rest of that
module is later work).

Every function takes tensors with any number of leading batch dimensions:
``bboxes`` is ``(..., N, 4)``.
"""

from __future__ import annotations

import torch


def get_center_from_bboxes(bboxes: torch.Tensor) -> torch.Tensor:
    """Box centers from [x1, y1, x2, y2] boxes. Parity: ``ops.py:231``."""
    b = bboxes.to(torch.float32)
    return torch.stack(
        [(b[..., 0] + b[..., 2]) * 0.5, (b[..., 1] + b[..., 3]) * 0.5], dim=-1
    )


def get_radii_from_bboxes(bboxes, scaling_factor: float = 0.8, centers=None):
    """Gaussian radius per box: min distance from the center to any box edge,
    clamped at 0, times ``scaling_factor``. Parity: ``ops.py:238``."""
    b = bboxes.to(torch.float32)
    c = get_center_from_bboxes(b) if centers is None else centers.to(torch.float32)
    left = torch.minimum(b[..., 0], b[..., 2])
    right = torch.maximum(b[..., 0], b[..., 2])
    top = torch.minimum(b[..., 1], b[..., 3])
    bottom = torch.maximum(b[..., 1], b[..., 3])
    dists = torch.stack(
        [c[..., 0] - left, c[..., 1] - top, right - c[..., 0], bottom - c[..., 1]], dim=-1
    )
    return torch.clamp(dists.amin(dim=-1), min=0.0) * float(scaling_factor)
