"""Access-modifier wrapper steps: apply a wrapped step independently to
selected sub-trees (the consistent-vs-independent randomization mechanism;
see the rationale at reference ``pipeline_step_base.py:44-84``).

Port of ``accvlab_tpu/pipeline/processing_steps/applied_steps.py``.
Because the wrapped step is invoked once per selected sub-tree and draws
fresh values from the injected RandomContext each time, each sub-tree gets
independent randomization, while fields inside one sub-tree are processed
consistently. A wrapper takes the wrapped step's ``placement`` and hands it
the context of the calling thread (``set_random_context``); on the device
the sub-trees hold the batch's tensors and the wrapped step draws per
sample, as it does unwrapped.
"""

from __future__ import annotations

from abc import abstractmethod
from typing import Sequence, Tuple, Union

from .pipeline_step_base import PipelineStepBase
from ..sample_data_group import SampleDataGroup

Name = Union[str, int]
PathT = Union[Name, Tuple[Name, ...]]


class GroupToApplyToSelectedStepBase(PipelineStepBase):
    """Apply the wrapped step to each selected sub-tree independently."""

    def __init__(self, processing_step_to_apply: PipelineStepBase):
        super().__init__()
        self._processing_step_to_apply = processing_step_to_apply
        self.placement = processing_step_to_apply.placement

    def set_random_context(self, ctx):
        """Set ``ctx`` for this thread on the wrapper and on the wrapped step
        (the per-thread map of ``pipeline_step_base``)."""
        super().set_random_context(ctx)
        self._processing_step_to_apply.set_random_context(ctx)

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        for path in self._check_and_get_paths_to_apply_to(data):
            sub = data.get_item_in_path(list(path))
            applied = self._processing_step_to_apply(sub)
            data.change_type_of_data_and_remove_data(tuple(path), applied)
            data.set_item_in_path(list(path), applied)
        return data

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        for path in self._check_and_get_paths_to_apply_to(data_empty):
            sub = data_empty.get_item_in_path(list(path))
            applied = (
                self._processing_step_to_apply.check_input_data_format_and_set_output_data_format(
                    sub
                )
            )
            data_empty.change_type_of_data_and_remove_data(tuple(path), applied)
            data_empty.set_item_in_path(list(path), applied)
        return data_empty

    @abstractmethod
    def _check_and_get_paths_to_apply_to(
        self, data: SampleDataGroup
    ) -> Sequence[Tuple[Name, ...]]:
        """Return the sub-tree paths to apply the wrapped step to."""


class DataGroupInPathAppliedStep(GroupToApplyToSelectedStepBase):
    """Apply to the single group at a fixed path."""

    def __init__(self, processing_step_to_apply: PipelineStepBase, path_to_apply_to: PathT):
        super().__init__(processing_step_to_apply)
        self._path_to_apply_to = path_to_apply_to

    def _check_and_get_paths_to_apply_to(self, data: SampleDataGroup):
        if not data.path_exists_and_is_data_group_field(self._path_to_apply_to):
            raise ValueError(
                f"DataGroupInPathAppliedStep: Path `{self._path_to_apply_to}` does "
                "not exist or is not a data group field."
            )
        if data.path_is_single_name(self._path_to_apply_to):
            return ((self._path_to_apply_to,),)
        return (tuple(self._path_to_apply_to),)


class DataGroupsWithNameAppliedStep(GroupToApplyToSelectedStepBase):
    """Apply to every group with one of the given names, anywhere in the tree."""

    def __init__(
        self,
        processing_step_to_apply: PipelineStepBase,
        names_of_groups_to_apply_to: Union[Name, Sequence[Name]],
        check_minimum_one_name_match: bool = True,
    ):
        super().__init__(processing_step_to_apply)
        if isinstance(names_of_groups_to_apply_to, (str, int)):
            names_of_groups_to_apply_to = [names_of_groups_to_apply_to]
        self._names = list(names_of_groups_to_apply_to)
        self._check_min_one = check_minimum_one_name_match

    def _check_and_get_paths_to_apply_to(self, data: SampleDataGroup):
        paths = []
        for name in self._names:
            found = data.find_all_occurrences(name)
            if self._check_min_one and len(found) == 0:
                raise ValueError(
                    f"DataGroupsWithNameAppliedStep: No fields with name `{name}` found."
                )
            for path in found:
                if not data.path_exists_and_is_data_group_field(path):
                    raise ValueError(
                        f"DataGroupsWithNameAppliedStep: Field in path `{path}` is "
                        "not a data group field."
                    )
            paths += list(found)
        return paths


class DataGroupArrayInPathElementsAppliedStep(DataGroupInPathAppliedStep):
    """Apply to every element of the group array at a fixed path."""

    def __init__(self, processing_step_to_apply: PipelineStepBase, path_to_array_to_apply_to: PathT):
        super().__init__(processing_step_to_apply, path_to_array_to_apply_to)

    def _check_and_get_paths_to_apply_to(self, data: SampleDataGroup):
        element_paths = []
        for ap in DataGroupInPathAppliedStep._check_and_get_paths_to_apply_to(self, data):
            array_field = data.get_item_in_path(list(ap))
            if not array_field.is_data_group_field_array():
                raise ValueError(
                    f"DataGroupArrayInPathElementsAppliedStep: item in path `{ap}` "
                    "is not a data group field array."
                )
            for i in range(len(array_field)):
                element_paths.append(tuple(ap) + (i,))
        return element_paths


class DataGroupArrayWithNameElementsAppliedStep(DataGroupsWithNameAppliedStep):
    """Apply to every element of every group array with the given name."""

    def __init__(
        self,
        processing_step_to_apply: PipelineStepBase,
        name_of_arrays_to_apply_to: Name,
        check_minimum_one_name_match: bool = True,
    ):
        assert isinstance(name_of_arrays_to_apply_to, (str, int)), (
            "Parameter `name_of_arrays_to_apply_to` has to be of type `str` or `int`."
        )
        super().__init__(
            processing_step_to_apply, name_of_arrays_to_apply_to, check_minimum_one_name_match
        )

    def _check_and_get_paths_to_apply_to(self, data: SampleDataGroup):
        element_paths = []
        for ap in DataGroupsWithNameAppliedStep._check_and_get_paths_to_apply_to(self, data):
            array_field = data.get_item_in_path(list(ap))
            if not array_field.is_data_group_field_array():
                raise ValueError(
                    f"DataGroupArrayWithNameElementsAppliedStep: item in path `{ap}` "
                    "is not a data group field array."
                )
            for i in range(len(array_field)):
                element_paths.append(tuple(ap) + (i,))
        return element_paths
