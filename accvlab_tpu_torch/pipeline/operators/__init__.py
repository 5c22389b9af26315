"""Array operators used by the ported processing steps, batched (port of the
matching functions of ``accvlab_tpu.pipeline.operators``)."""

from .image_ops import invert_2x3, warp_affine
from .ops import get_center_from_bboxes, get_radii_from_bboxes
from .point_ops import (
    apply_clipping_and_get_with_clipping_info,
    get_is_active,
    transform_points,
)

__all__ = [
    "apply_clipping_and_get_with_clipping_info",
    "get_center_from_bboxes",
    "get_is_active",
    "get_radii_from_bboxes",
    "invert_2x3",
    "transform_points",
    "warp_affine",
]
