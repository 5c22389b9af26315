"""Array operators of the processing steps (port of
``accvlab_tpu.pipeline.operators``): numpy forms for host steps and torch
forms on batched tensors for device steps."""

from .image_ops import invert_2x3, warp_affine
from .ops import (
    apply_matrix,
    check_bbox_visibiity,
    check_bbox_visibility,
    check_minimum_bbox_size,
    check_points_in_box,
    crop_coordinates,
    ensure_range,
    get_center_from_bboxes,
    get_radii_from_bboxes,
    get_rot_mat_from_rot_vector,
    get_scaling_mat_from_vector,
    get_translation_mat_from_vector,
    pad_to_size,
    remove_inactive,
    replace_nans,
)
from .point_ops import (
    add_post_transform_to_projection_matrix,
    apply_clipping_and_get_with_clipping_info,
    apply_transform_to_points,
    get_is_active,
    pad_to_common_size,
    transform_points,
)

__all__ = [
    "add_post_transform_to_projection_matrix",
    "apply_clipping_and_get_with_clipping_info",
    "apply_matrix",
    "apply_transform_to_points",
    "check_bbox_visibiity",
    "check_bbox_visibility",
    "check_minimum_bbox_size",
    "check_points_in_box",
    "crop_coordinates",
    "ensure_range",
    "get_center_from_bboxes",
    "get_is_active",
    "get_radii_from_bboxes",
    "get_rot_mat_from_rot_vector",
    "get_scaling_mat_from_vector",
    "get_translation_mat_from_vector",
    "invert_2x3",
    "pad_to_common_size",
    "pad_to_size",
    "remove_inactive",
    "replace_nans",
    "transform_points",
    "warp_affine",
]
