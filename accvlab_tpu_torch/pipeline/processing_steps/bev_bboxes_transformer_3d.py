"""BEV (world-coordinate) 3-D box augmentation, batched.

PyTorch port of ``accvlab_tpu/pipeline/processing_steps/bev_bboxes_transformer_3d.py``:
a random rotation, scaling and translation of box centres, velocities,
sizes and orientations, with consistent updates of ego<->world and
projection/extrinsic matrices, in the JAX step's from-right / inverse /
transpose pattern per field kind (the three tables below).

A device step on the whole batch: one draw set per sample, each draw a
``(B,)`` tensor, applied to every matching field. The draw order (what a
``ScriptedRandomContext`` scripts, the same as the JAX step's per-sample
order): the rotation angle, then the scale, then the translation's x, y
and z; a range with ``lo == hi`` draws nothing and gives ``lo``. Every draw
goes through the device random context, so ``export_device_program``
records it in the draw schedule and the exported stage replays it.

Each sample's 4x4 matrix is applied to its own fields: the matrices are
``(B, 4, 4)`` and broadcast over a field's further leading dimensions (the
cameras of a ``(B, cams, 4, 4)`` projection field).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ._common import batch_tensor
from .pipeline_step_base import PipelineStepBase
from ..operators import (
    apply_matrix,
    ensure_range,
    get_rot_mat_from_rot_vector,
    get_scaling_mat_from_vector,
    get_translation_mat_from_vector,
)
from ..sample_data_group import SampleDataGroup

Name = Union[str, int]
Names = Optional[Union[Name, Sequence[Name]]]


def _to_list(data: Names):
    if data is None:
        return []
    if isinstance(data, (str, int)):
        return [data]
    return list(data)


def _per_sample(value: torch.Tensor, ndim: int, tail: int) -> torch.Tensor:
    """``value`` of leading dim B, viewed to broadcast over a field of
    ``ndim`` dims: singleton dims between the batch and the ``tail`` dims."""
    return value.reshape(value.shape[0], *([1] * (ndim - 1 - tail)), *value.shape[1:])


class BEVBBoxesTransformer3D(PipelineStepBase):
    """World-coordinate 3-D augmentation with consistent matrix updates."""

    placement = "device"

    # per-transform application tables, as the JAX step's
    _ROTATION_TABLE = [
        # (field kind, from_right, invert, data_transposed, make_homog)
        ("points", False, False, True, True),
        ("velocities", False, False, True, True),
        ("ego_to_world", True, True, False, False),
        ("world_to_ego", False, False, False, False),
        ("proj_matrices_and_extrinsics", True, True, False, False),
    ]
    _SCALING_TABLE = [
        ("points", False, False, True, True),
        ("velocities", False, False, True, True),
        ("sizes", False, False, True, True),
        ("ego_to_world", True, True, False, False),
        ("world_to_ego", False, False, False, False),
        ("proj_matrices_and_extrinsics", True, True, False, False),
    ]
    _TRANSLATION_TABLE = [
        ("points", False, False, True, True),
        ("ego_to_world", True, True, False, False),
        ("world_to_ego", False, False, False, False),
        ("proj_matrices_and_extrinsics", True, True, False, False),
    ]

    def __init__(
        self,
        data_field_names_points: Names,
        data_field_names_velocities: Names,
        data_field_names_sizes: Names,
        data_field_names_orientation: Names,
        data_field_names_proj_matrices_and_extrinsics: Names,
        data_field_names_ego_to_world: Names,
        data_field_names_world_to_ego: Names,
        rotation_range: Optional[Tuple[float, float]],
        rotation_axis: Optional[int],
        scaling_range: Optional[Tuple[float, float]],
        translation_max_abs: Optional[Tuple[float, float, float]],
    ):
        super().__init__()
        self._do_rotate = rotation_range is not None
        self._do_scale = scaling_range is not None
        self._do_translate = translation_max_abs is not None
        if self._do_rotate:
            assert rotation_axis is not None, (
                "If `rotation_range` is set, `rotation_axis` needs to be set too"
            )
            assert len(rotation_range) == 2
            self._rotation_range = tuple(float(r) for r in rotation_range)
            self._rotation_axis = int(rotation_axis)
        if self._do_scale:
            assert len(scaling_range) == 2
            self._scaling_range = tuple(float(s) for s in scaling_range)
        if self._do_translate:
            assert len(translation_max_abs) == 3, (
                "If `translation_max_abs` is set, it must have 3 elements."
            )
            self._translation_max_abs = tuple(float(t) for t in translation_max_abs)

        self._fields = {
            "points": _to_list(data_field_names_points),
            "velocities": _to_list(data_field_names_velocities),
            "sizes": _to_list(data_field_names_sizes),
            "orientation": _to_list(data_field_names_orientation),
            "proj_matrices_and_extrinsics": _to_list(
                data_field_names_proj_matrices_and_extrinsics
            ),
            "ego_to_world": _to_list(data_field_names_ego_to_world),
            "world_to_ego": _to_list(data_field_names_world_to_ego),
        }
        assert any(self._fields.values()), "At least one data field name must be set."

    def _rand_in_range(self, lo: float, hi: float, bsz: int, device) -> torch.Tensor:
        if lo == hi:
            return torch.full((bsz,), float(np.float32(lo)), dtype=torch.float32, device=device)
        return batch_tensor(self.random.uniform(lo, hi, (bsz,)), device).to(torch.float32)

    def _apply_table(self, data: SampleDataGroup, table, matrix: torch.Tensor,
                     use_transpose_for_inverse: bool):
        for kind, from_right, invert, transposed, make_homog in table:
            for name in self._fields[kind]:
                for path in data.find_all_occurrences(name):
                    parent = data.get_parent_of_path(path)
                    value = parent[name]
                    parent[name] = apply_matrix(
                        value,
                        _per_sample(matrix, value.ndim, 2),
                        make_apply_to_homog=make_homog,
                        to_apply_to_is_transposed=transposed,
                        matrix_is_transposed=invert if use_transpose_for_inverse else False,
                        matrix_is_inverted=invert if not use_transpose_for_inverse else False,
                        multiply_matrix_from_right=from_right,
                    )

    def _first_leaf(self, data: SampleDataGroup) -> torch.Tensor:
        for names in self._fields.values():
            for name in names:
                paths = data.find_all_occurrences(name)
                if paths:
                    return data.get_item_in_path(paths[0])
        raise KeyError("none of the step's fields is in the data")

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        first = self._first_leaf(data)
        bsz, dev = first.shape[0], first.device
        if self._do_rotate:
            angle = self._rand_in_range(*self._rotation_range, bsz, dev)
            # the unit axis times the angle, as the JAX step's product (0 * angle
            # off the axis), made without a host-to-device copy
            rot_vec = torch.stack([angle if i == self._rotation_axis else angle * 0.0
                                   for i in range(3)], -1)
            rotation_matrix = get_rot_mat_from_rot_vector(rot_vec, as_homog=True)
            # a rotation's inverse is its transpose
            self._apply_table(data, self._ROTATION_TABLE, rotation_matrix, True)
            for name in self._fields["orientation"]:
                for path in data.find_all_occurrences(name):
                    parent = data.get_parent_of_path(path)
                    value = parent[name]
                    orientation = value + _per_sample(angle, value.ndim, 0)
                    parent[name] = ensure_range(orientation, -np.pi, np.pi, 2.0 * np.pi)
        if self._do_scale:
            s = self._rand_in_range(*self._scaling_range, bsz, dev)
            scaling_matrix = get_scaling_mat_from_vector(torch.stack([s, s, s], -1),
                                                         as_homog=True)
            self._apply_table(data, self._SCALING_TABLE, scaling_matrix, False)
        if self._do_translate:
            t = torch.stack([self._rand_in_range(-m, m, bsz, dev)
                             for m in self._translation_max_abs], -1)
            translation_matrix = get_translation_mat_from_vector(t)
            self._apply_table(data, self._TRANSLATION_TABLE, translation_matrix, False)
        return data

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        for kind, names in self._fields.items():
            for name in names:
                if len(data_empty.find_all_occurrences(name)) == 0:
                    raise KeyError(
                        f"No occurrences of {kind} field '{name}' found."
                    )
        return data_empty
