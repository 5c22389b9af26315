"""Field-utility steps: AxesLayoutSetter, UnneededFieldRemover,
TensorSizeAdder (port of
``accvlab_tpu/pipeline/processing_steps/field_utils.py``).

All three are ``placement = "any"``: on the host side of the boundary they
take one sample's numpy leaves, on the device side the batch's tensors
(leading batch dimension), chosen per value.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ._common import as_name_list
from .pipeline_step_base import PipelineStepBase
from ..dtypes import DType, numpy_dtype_for, torch_dtype_for
from ..sample_data_group import SampleDataGroup

Name = Union[str, int]


class AxesLayoutSetter(PipelineStepBase):
    """Set the axis layout of matching fields (e.g. HWC -> CHW) by permuting
    the axes from ``current_layout`` to ``layout_to_set``. On the device the
    permutation applies to the trailing axes, after the batch axis."""

    placement = "any"

    def __init__(
        self,
        names_fields_to_set: Union[Name, Sequence[Name]],
        layout_to_set: str,
        current_layout: str = "HWC",
    ):
        super().__init__()
        self._names = as_name_list(names_fields_to_set)
        assert sorted(layout_to_set) == sorted(current_layout), (
            f"Layouts must be permutations of each other: {current_layout} -> {layout_to_set}"
        )
        self._perm = tuple(current_layout.index(ax) for ax in layout_to_set)
        self._identity = self._perm == tuple(range(len(self._perm)))

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        if self._identity:
            return data
        for field_name in self._names:
            for fp in data.find_all_occurrences(field_name):
                field = data.get_item_in_path(fp)
                if isinstance(field, torch.Tensor):
                    lead = field.ndim - len(self._perm)
                    perm = tuple(range(lead)) + tuple(lead + p for p in self._perm)
                    data.set_item_in_path(fp, field.permute(perm))
                else:
                    data.set_item_in_path(fp, np.transpose(np.asarray(field), self._perm))
        return data

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        for field_name in self._names:
            if len(data_empty.find_all_occurrences(field_name)) == 0:
                raise KeyError(f"No occurrences of field '{field_name}' found.")
        return data_empty


class UnneededFieldRemover(PipelineStepBase):
    """Remove all occurrences of the given field names from the structure
    (before the boundary it saves transfer bytes)."""

    placement = "any"

    def __init__(
        self,
        unneeded_field_names: Union[Name, Sequence[Name], None] = None,
        *,
        field_names: Union[Name, Sequence[Name], None] = None,
    ):
        """``unneeded_field_names`` is the reference's parameter name;
        ``field_names`` is its keyword alias, as in the JAX package."""
        super().__init__()
        if unneeded_field_names is None:
            unneeded_field_names = field_names
        assert unneeded_field_names is not None, "unneeded_field_names is required"
        self._field_names = as_name_list(unneeded_field_names)

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        for name in self._field_names:
            data.remove_all_occurrences(name)
        return data

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        for name in self._field_names:
            data_empty.remove_all_occurrences(name)
        return data_empty


class TensorSizeAdder(PipelineStepBase):
    """Store each matching tensor's (H, W) size (dims -3 and -2) as a new
    sibling field named ``tensor_name + size_postfix``. On the device it is
    a ``(B, 2)`` tensor made there (nothing is copied from host memory)."""

    placement = "any"

    def __init__(
        self,
        tensor_name: str,
        size_postfix: str,
        store_size_as_type: DType = DType.INT32,
    ):
        super().__init__()
        self._tensor_name = tensor_name
        self._size_postfix = size_postfix
        self._store_type = store_size_as_type

    @property
    def _size_name(self) -> str:
        return f"{self._tensor_name}{self._size_postfix}"

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        for tp in data.find_all_occurrences(self._tensor_name):
            tensor = data.get_item_in_path(tp)
            parent = data.get_parent_of_path(tp)
            h, w = tensor.shape[-3:-1]
            if isinstance(tensor, torch.Tensor):
                size = torch.full((tensor.shape[0], 2), h, dtype=torch_dtype_for(self._store_type),
                                  device=tensor.device)
                size[:, 1] = w
            else:
                size = np.asarray((h, w), dtype=numpy_dtype_for(self._store_type))
            parent.add_data_field(self._size_name, self._store_type)
            parent[self._size_name] = size
        return data

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        paths = data_empty.find_all_occurrences(self._tensor_name)
        if len(paths) == 0:
            raise KeyError(f"No occurrences of field '{self._tensor_name}' found.")
        for tp in paths:
            data_empty.get_parent_of_path(tp).add_data_field(self._size_name, self._store_type)
        return data_empty
