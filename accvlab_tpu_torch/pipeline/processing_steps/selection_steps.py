"""Object-selection steps: CoordinateCropper, PointsInRangeCheck,
VisibleBboxSelector, ConditionalElementRemover.

Port of ``accvlab_tpu/pipeline/processing_steps/selection_steps.py``.
``CoordinateCropper`` and ``PointsInRangeCheck`` are ``placement = "any"``:
the operators they call take a sample's numpy arrays on the host and the
batch's ``(B, N, D)`` tensors on the device (after ``PaddingToUniform`` made
them uniform), where they read nothing back. ``VisibleBboxSelector`` (a
sequential raster) and ``ConditionalElementRemover`` (data-dependent sizes)
are host steps.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

from .pipeline_step_base import PipelineStepBase
from ..dtypes import DType
from ..operators import (
    check_bbox_visibility,
    check_minimum_bbox_size,
    check_points_in_box,
    crop_coordinates,
    remove_inactive,
)
from ..sample_data_group import SampleDataGroup

Name = Union[str, int]


class CoordinateCropper(PipelineStepBase):
    """Clip point coordinates into a box, in place."""

    placement = "any"

    def __init__(
        self,
        points_fields_name: str,
        minimum_point: Sequence[float],
        maximum_point: Sequence[float],
    ):
        super().__init__()
        self._points_fields_name = points_fields_name
        self._minimum_point = list(minimum_point)
        self._maximum_point = list(maximum_point)

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        for path in data.find_all_occurrences(self._points_fields_name):
            parent = data.get_parent_of_path(path)
            points = parent[self._points_fields_name]
            parent[self._points_fields_name] = crop_coordinates(
                points, self._minimum_point, self._maximum_point
            )
        return data

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        if len(data_empty.find_all_occurrences(self._points_fields_name)) == 0:
            raise KeyError(
                f"No fields containing points found with name '{self._points_fields_name}'."
            )
        return data_empty


class PointsInRangeCheck(PipelineStepBase):
    """Add a bool sibling field flagging points inside a box."""

    placement = "any"

    def __init__(
        self,
        points_fields_name: str,
        is_inside_field_name: str,
        minimum_point: Sequence[float],
        maximum_point: Sequence[float],
    ):
        super().__init__()
        self._points_fields_name = points_fields_name
        self._is_inside_field_name = is_inside_field_name
        self._minimum_point = list(minimum_point)
        self._maximum_point = list(maximum_point)

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        for path in data.find_all_occurrences(self._points_fields_name):
            parent = data.get_parent_of_path(path)
            mask = check_points_in_box(
                parent[self._points_fields_name], self._minimum_point, self._maximum_point
            )
            parent.add_data_field(self._is_inside_field_name, DType.BOOL)
            parent[self._is_inside_field_name] = mask
        return data

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        paths = data_empty.find_all_occurrences(self._points_fields_name)
        if len(paths) == 0:
            raise ValueError(
                f"No fields containing points to check found (searched under "
                f"name '{self._points_fields_name}')."
            )
        for path in paths:
            parent = data_empty.get_parent_of_path(path)
            if parent.has_child(self._is_inside_field_name):
                raise ValueError(
                    f"Cannot add is_inside flag '{self._is_inside_field_name}': "
                    f"a sibling with that name already exists at `{path}`."
                )
            parent.add_data_field(self._is_inside_field_name, DType.BOOL)
        return data_empty


class VisibleBboxSelector(PipelineStepBase):
    """Occlusion/size-based bbox visibility mask.

    Host-placed: the occlusion check is a sequential painter's-algorithm
    raster.
    """

    placement = "host"

    def __init__(
        self,
        bboxes_field_name: Name,
        resulting_mask_field_path: Union[Name, Tuple[Name, ...]],
        image_field_name: Optional[Name] = None,
        image_hw_field_name: Optional[Name] = None,
        image_hw: Optional[Sequence[int]] = None,
        check_for_bbox_occlusion: bool = True,
        check_for_minimum_size: bool = True,
        depths_field_name: Optional[Name] = None,
        minimum_bbox_size: Optional[float] = None,
    ):
        super().__init__()
        num_set = sum(
            [image_field_name is not None, image_hw_field_name is not None, image_hw is not None]
        )
        assert num_set == 1, (
            "Exactly one of 'image_field_name', 'image_hw_field_name', or "
            "'image_hw' must be set (single source of truth)"
        )
        assert check_for_bbox_occlusion or check_for_minimum_size
        assert not check_for_minimum_size or minimum_bbox_size is not None
        assert not check_for_bbox_occlusion or depths_field_name is not None
        self._bboxes_field_name = bboxes_field_name
        self._depths_field_name = depths_field_name
        self._image_field_name = image_field_name
        self._image_hw_field_name = image_hw_field_name
        self._image_hw = image_hw
        self._resulting_mask_field_path = resulting_mask_field_path
        self._check_occlusion = check_for_bbox_occlusion
        self._check_min_size = check_for_minimum_size
        self._minimum_bbox_size = minimum_bbox_size

    def _get_image_hw(self, data: SampleDataGroup):
        if self._image_hw is not None:
            return np.asarray(self._image_hw, np.int32)
        if self._image_field_name is not None:
            image = data.get_item_in_path(
                data.find_all_occurrences(self._image_field_name)[0]
            )
            return np.asarray(image.shape[-3:-1], np.int32)
        return np.asarray(
            data.get_item_in_path(
                data.find_all_occurrences(self._image_hw_field_name)[0]
            ),
            np.int32,
        )

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        image_hw = self._get_image_hw(data)
        bboxes = data.get_item_in_path(data.find_all_occurrences(self._bboxes_field_name)[0])
        if self._check_occlusion:
            depths = data.get_item_in_path(
                data.find_all_occurrences(self._depths_field_name)[0]
            )
            mask = check_bbox_visibility(bboxes, depths, image_hw)
            if self._check_min_size:
                mask = mask & np.asarray(
                    check_minimum_bbox_size(bboxes, self._minimum_bbox_size, image_hw)
                )
        else:
            mask = np.asarray(
                check_minimum_bbox_size(bboxes, self._minimum_bbox_size, image_hw)
            )
        if data.path_is_single_name(self._resulting_mask_field_path):
            data.add_data_field(self._resulting_mask_field_path, DType.BOOL)
            data[self._resulting_mask_field_path] = mask
        else:
            parent = data.get_parent_of_path(self._resulting_mask_field_path)
            parent.add_data_field(self._resulting_mask_field_path[-1], DType.BOOL)
            parent[self._resulting_mask_field_path[-1]] = mask
        return data

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        def require_unique(name, what):
            n = len(data_empty.find_all_occurrences(name))
            if n == 0:
                raise KeyError(f"No occurrence of {what} field '{name}' found.")
            if n > 1:
                raise ValueError(
                    f"More than one occurrence of {what} field '{name}'. "
                    "Field needs a unique name."
                )

        require_unique(self._bboxes_field_name, "bboxes")
        if self._image_field_name is not None:
            if len(data_empty.find_all_occurrences(self._image_field_name)) == 0:
                raise KeyError(f"No image field '{self._image_field_name}' found.")
        if self._image_hw_field_name is not None:
            require_unique(self._image_hw_field_name, "image_hw")
        if self._check_occlusion:
            require_unique(self._depths_field_name, "depths")
        if data_empty.path_is_single_name(self._resulting_mask_field_path):
            if data_empty.has_child(self._resulting_mask_field_path):
                raise ValueError(
                    f"Field '{self._resulting_mask_field_path}' already exists."
                )
            data_empty.add_data_field(self._resulting_mask_field_path, DType.BOOL)
        else:
            parent = data_empty.get_parent_of_path(self._resulting_mask_field_path)
            name = self._resulting_mask_field_path[-1]
            if parent.has_child(name):
                raise ValueError(f"Field '{name}' already exists at the target path.")
            parent.add_data_field(name, DType.BOOL)
        return data_empty


class ConditionalElementRemover(PipelineStepBase):
    """Remove per-object entries flagged inactive by a bool mask field.

    Host-placed: output sizes are data dependent; follow with
    :class:`PaddingToUniform` before the device boundary.
    """

    placement = "host"

    def __init__(
        self,
        annotation_field_name: Name,
        mask_field_name: Name,
        field_names_to_process: Sequence[Name],
        field_dims_to_process: Sequence[int],
        fields_to_process_num_dims: Sequence[int] = None,
        remove_mask_field: bool = False,
    ):
        super().__init__()
        assert len(field_names_to_process) == len(field_dims_to_process)
        self._annotation_field_name = annotation_field_name
        self._mask_field_name = mask_field_name
        self._field_names = list(field_names_to_process)
        self._field_dims = list(field_dims_to_process)
        self._do_remove_mask = remove_mask_field
        del fields_to_process_num_dims  # implied by the arrays themselves

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        for ap in data.find_all_occurrences(self._annotation_field_name):
            annotations = data.get_item_in_path(ap)
            is_active = np.asarray(annotations[self._mask_field_name]).astype(bool)
            for name, dim in zip(self._field_names, self._field_dims):
                annotations[name] = remove_inactive(annotations[name], is_active, dim)
        if self._do_remove_mask:
            self._remove_mask(data)
        return data

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        paths = data_empty.find_all_occurrences(self._annotation_field_name)
        if len(paths) == 0:
            raise KeyError(
                f"No occurrences of annotations found with name "
                f"'{self._annotation_field_name}'."
            )
        for ap in paths:
            annotation = data_empty.get_item_in_path(ap)
            for field in self._field_names:
                if field not in annotation.contained_top_level_field_names:
                    raise KeyError(f"No field to process '{field}' in annotation at '{ap}'")
            if self._mask_field_name not in annotation.contained_top_level_field_names:
                raise KeyError(f"No mask field '{self._mask_field_name}' in annotation at `{ap}`")
        if self._do_remove_mask:
            self._remove_mask(data_empty)
        return data_empty

    def _remove_mask(self, data_inout: SampleDataGroup):
        for ap in data_inout.find_all_occurrences(self._annotation_field_name):
            data_inout.get_item_in_path(ap).remove_field(self._mask_field_name)
