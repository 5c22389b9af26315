"""Bounding-box -> CenterNet-style heatmap target generation, batched.

PyTorch port of
``accvlab_tpu/pipeline/processing_steps/bounding_box_to_heatmap_converter.py``.
Clipping/scaling, activity checks and radii are batched tensor ops; the
Gaussian rasterization runs on the CUDA kernel behind
:func:`accvlab_tpu_torch.heatmap.draw_gaussians` — ONE launch per batch for
all annotation groups of the sample (e.g. all cameras), whose targets are
concatenated along the batch dimension.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .pipeline_step_base import PipelineStepBase
from ..dtypes import DType
from ..operators import get_center_from_bboxes, get_radii_from_bboxes
from ..operators.point_ops import apply_clipping_and_get_with_clipping_info, get_is_active
from ..sample_data_group import SampleDataGroup
from ...heatmap.draw_gaussians import draw_gaussians

Name = Union[str, int]


class BoundingBoxToHeatmapConverter(PipelineStepBase):
    """Generate per-annotation Gaussian heatmaps (optionally classwise) plus
    optional center / offset / size / active-mask side outputs.

    ``implementation`` is handed to :func:`draw_gaussians` (``"auto"``: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    ``"torch"``: the plain version on either device).
    """

    placement = "device"

    def __init__(
        self,
        annotation_field_name: Name,
        bboxes_in_name: Name,
        heatmap_out_name: Name,
        heatmap_hw: Tuple[int, int],
        image_field_name: Optional[Name] = None,
        image_hw_field_name: Optional[Name] = None,
        categories_in_name: Optional[Name] = None,
        num_categories: Optional[int] = None,
        min_object_size: Optional[Sequence[float]] = None,
        per_category_min_object_sizes: Optional[Sequence[Sequence[float]]] = None,
        use_per_category_heatmap: bool = True,
        is_valid_opt_in_name: Optional[Name] = None,
        center_opt_in_name: Optional[Name] = None,
        is_active_opt_out_name: Optional[Name] = None,
        center_opt_out_name: Optional[Name] = None,
        center_offset_opt_out_name: Optional[Name] = None,
        height_width_bboxes_heatmap_opt_out_name: Optional[Name] = None,
        bboxes_heatmap_opt_out_name: Optional[Name] = None,
        min_fraction_area_clipping: float = 0.25,
        min_radius: float = 0.5,
        max_radius: float = 10.0,
        radius_scaling_factor: float = 0.8,
        radius_to_sigma_factor: float = 1.0 / 3.0,
        implementation: str = "auto",
    ):
        super().__init__()
        if (image_field_name is None) == (image_hw_field_name is None):
            raise ValueError(
                "Exactly one of 'image_field_name' or 'image_hw_field_name' must "
                "be set (single source of truth for image size)."
            )
        categories_required = (
            use_per_category_heatmap
            or num_categories is not None
            or per_category_min_object_sizes is not None
        )
        if categories_required:
            assert categories_in_name is not None, (
                "categories_in_name must be provided when categories are used."
            )
            assert num_categories and num_categories > 0, (
                "num_categories must be a positive integer (if used)."
            )
        assert not (
            min_object_size is not None and per_category_min_object_sizes is not None
        ), "min_object_size and per_category_min_object_sizes are mutually exclusive."
        if per_category_min_object_sizes is not None:
            assert len(per_category_min_object_sizes) == num_categories
        assert len(heatmap_hw) == 2 and heatmap_hw[0] > 0 and heatmap_hw[1] > 0

        self._annotation_field_name = annotation_field_name
        self._bboxes_name = bboxes_in_name
        self._heatmap_name = heatmap_out_name
        self._heatmap_hw = tuple(heatmap_hw)
        self._image_field_name = image_field_name
        self._image_hw_field_name = image_hw_field_name
        self._extract_size_from_image = image_field_name is not None
        self._categories_name = categories_in_name
        self._num_categories = num_categories
        self._min_object_size = min_object_size
        self._per_class_sizes = (
            np.asarray(per_category_min_object_sizes, np.float32)
            if per_category_min_object_sizes is not None
            else None
        )
        self._use_per_category_heatmap = use_per_category_heatmap
        self._is_valid_name = is_valid_opt_in_name
        self._center_in_name = center_opt_in_name
        self._is_active_name = is_active_opt_out_name
        self._center_out_name = center_opt_out_name
        self._center_offset_name = center_offset_opt_out_name
        self._hw_out_name = height_width_bboxes_heatmap_opt_out_name
        self._bboxes_out_name = bboxes_heatmap_opt_out_name
        self._min_fraction_area = min_fraction_area_clipping
        self._min_radius = min_radius
        self._max_radius = max_radius
        self._radius_scaling_factor = radius_scaling_factor
        self._radius_to_sigma_factor = radius_to_sigma_factor
        self._check_categories = num_categories is not None
        self._implementation = implementation

    # ------------------------------------------------------------------ #

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        groups = []
        for ap in data.find_all_occurrences(self._annotation_field_name):
            parent = data.get_parent_of_path(ap)
            annotation = parent[self._annotation_field_name]
            bboxes = annotation[self._bboxes_name]
            if self._extract_size_from_image:
                image = parent[self._image_field_name]
                hw = torch.tensor(image.shape[-3:-1], dtype=torch.float32, device=bboxes.device)
                image_hw = hw.expand(bboxes.shape[0], 2)
            else:
                image_hw = parent[self._image_hw_field_name].to(torch.float32)
            groups.append((annotation, self._prepare_targets(annotation, image_hw)))
        if not groups:
            return data

        num_slices = self._num_categories if self._use_per_category_heatmap else 1
        hh, hw = self._heatmap_hw
        counts = [g[1]["active"].shape[0] for g in groups]
        if len({g[1]["active"].shape[1] for g in groups}) == 1:
            # one launch for every annotation group of the batch
            def cat(key):
                return torch.cat([g[1][key] for g in groups], dim=0)

            heatmaps = self._draw(sum(counts), cat("active"), cat("slice_ids"),
                                  cat("center"), cat("radii"), num_slices)
            per_group = torch.split(heatmaps, counts, dim=0)
        else:  # groups with different target counts cannot share one launch
            per_group = [
                self._draw(n, p["active"], p["slice_ids"], p["center"], p["radii"], num_slices)
                for n, (_, p) in zip(counts, groups)
            ]
        for (annotations, p), heatmap in zip(groups, per_group):
            self._add_fields_to_annotations(annotations)
            annotations[self._heatmap_name] = heatmap
            if self._is_active_name is not None:
                annotations[self._is_active_name] = p["active"]
            if self._center_out_name is not None:
                annotations[self._center_out_name] = p["center"]
            if self._center_offset_name is not None:
                annotations[self._center_offset_name] = p["offset"]
            if self._hw_out_name is not None:
                annotations[self._hw_out_name] = p["hw"]
            if self._bboxes_out_name is not None:
                annotations[self._bboxes_out_name] = p["bboxes"]
        return data

    def _draw(self, n, active, slice_ids, centers, radii, num_slices):
        hh, hw = self._heatmap_hw
        heatmap = torch.zeros((n, num_slices, hh, hw), dtype=torch.float32, device=active.device)
        return draw_gaussians(
            heatmap, active, slice_ids, centers, radii,
            k_for_classes=[1.0] * num_slices,
            radius_to_sigma_factor=self._radius_to_sigma_factor,
            implementation=self._implementation,
        )

    def _prepare_targets(self, annotations: SampleDataGroup, image_hw: torch.Tensor) -> dict:
        """Per-target tensors of one annotation group, ``(B, T, ...)``."""
        hh, hw = self._heatmap_hw
        bboxes = annotations[self._bboxes_name]
        dev = bboxes.device
        categories = (
            annotations[self._categories_name] if self._categories_name is not None else None
        )
        if self._center_in_name is not None:
            center_in = annotations[self._center_in_name]
        else:
            center_in = get_center_from_bboxes(bboxes)

        # image -> heatmap scaling transform (B, 2, 3); tensor / tensor keeps
        # the division correctly rounded
        sx = torch.full_like(image_hw[:, 1], float(hw)) / image_hw[:, 1]
        sy = torch.full_like(image_hw[:, 0], float(hh)) / image_hw[:, 0]
        zero = torch.zeros_like(sx)
        trafo = torch.stack(
            [torch.stack([sx, zero, zero], -1), torch.stack([zero, sy, zero], -1)], -2
        )

        bboxes_clipped, centers_clipped, hw_clipped, fraction_areas = (
            apply_clipping_and_get_with_clipping_info(bboxes, center_in, trafo, self._heatmap_hw)
        )
        # full-pixel peak location (avoid sub-pixel maxima downstream)
        floor = torch.floor(centers_clipped)
        center_full_pixel = floor.to(torch.int32)
        center_offset = centers_clipped - floor

        use_classes_for_active = (
            self._use_per_category_heatmap or self._check_categories
            or self._per_class_sizes is not None
        )
        is_active = get_is_active(
            hw_clipped,
            categories if use_classes_for_active else None,
            fraction_areas,
            min_object_size=(
                self._min_object_size
                if (self._min_object_size is not None and not use_classes_for_active)
                else None
            ),
            per_class_min_object_sizes=self._per_class_sizes,
            num_classes=self._num_categories,
            min_fraction_area_thresh=self._min_fraction_area,
        )
        if self._is_valid_name is not None:
            is_active = is_active & annotations[self._is_valid_name].to(torch.bool)

        radii = get_radii_from_bboxes(
            bboxes_clipped, centers=centers_clipped, scaling_factor=self._radius_scaling_factor
        )
        radii = torch.clamp(radii, min=self._min_radius, max=self._max_radius)
        if self._use_per_category_heatmap:
            slice_ids = categories.to(torch.int32)
        else:
            slice_ids = torch.zeros(radii.shape, dtype=torch.int32, device=dev)
        return dict(active=is_active, slice_ids=slice_ids, center=center_full_pixel,
                    offset=center_offset, radii=radii, hw=hw_clipped, bboxes=bboxes_clipped)

    # ------------------------------------------------------------------ #

    def _add_fields_to_annotations(self, annotations: SampleDataGroup):
        def add(name, dtype):
            if name is None:
                return
            try:
                annotations.add_data_field(name, dtype)
            except AssertionError as e:
                raise KeyError(
                    f"The input annotation must not contain the field '{name}', "
                    "as it is added by this step."
                ) from e

        add(self._heatmap_name, DType.FLOAT)
        add(self._is_active_name, DType.BOOL)
        add(self._center_out_name, DType.INT32)
        add(self._center_offset_name, DType.FLOAT)
        add(self._hw_out_name, DType.FLOAT)
        add(self._bboxes_out_name, DType.FLOAT)

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        annotation_paths = data_empty.find_all_occurrences(self._annotation_field_name)
        if len(annotation_paths) == 0:
            raise KeyError(
                f"No occurrences of annotations found with name "
                f"'{self._annotation_field_name}'."
            )
        for ap in annotation_paths:
            parent = data_empty.get_parent_of_path(ap)
            if self._extract_size_from_image:
                if self._image_field_name not in parent.contained_top_level_field_names:
                    raise KeyError(
                        f"For annotation at '{ap}', no sibling image field "
                        f"'{self._image_field_name}' found."
                    )
            else:
                if self._image_hw_field_name not in parent.contained_top_level_field_names:
                    raise KeyError(
                        f"For annotation at '{ap}', no sibling image size field "
                        f"'{self._image_hw_field_name}' found."
                    )
            annotation = parent[self._annotation_field_name]
            if self._bboxes_name not in annotation.contained_top_level_field_names:
                raise KeyError(f"No '{self._bboxes_name}' field inside annotation at '{ap}'.")
            if (
                self._center_in_name is not None
                and self._center_in_name not in annotation.contained_top_level_field_names
            ):
                raise KeyError(f"No '{self._center_in_name}' field inside annotation at '{ap}'.")
            self._add_fields_to_annotations(annotation)
        return data_empty
