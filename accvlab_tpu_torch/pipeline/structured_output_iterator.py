"""Structured pipeline-output iterator, a drop-in DataLoader replacement
(port of ``accvlab_tpu/pipeline/structured_output_iterator.py``).

The reference's ``DALIStructuredOutputIterator`` with the ``SimpleIterator``
reset semantics and ``CreateAsDataLoaderObject``. The generic-iterator
layer is the :class:`TorchPipeline` itself (it yields
``[{flat_name: batched_tensor}]``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

from .pipeline import TorchPipeline
from .sample_data_group import SampleDataGroup


class StructuredOutputIterator:
    """Structured access to pipeline output as nested dicts or
    :class:`SampleDataGroup`; optional lightweight post-processing."""

    class SimpleIterator:
        """Single-use iterator view; all views share the parent's state
        (parity with the reference's ``SimpleIterator``)."""

        def __init__(self, obj: "StructuredOutputIterator"):
            self._obj = obj
            # construction-time reset goes through the iterator-front path:
            # it is the ONE reset that must be a no-op right after a
            # set_state resume (the restored position would otherwise be
            # discarded before the first resumed batch was consumed)
            obj._pipeline._reset_from_iterator_front()

        def __next__(self):
            return self._obj._next()

        def __iter__(self):
            return self

        def reset(self):
            self._obj.reset()

        def __len__(self):
            return len(self._obj)

    def __init__(
        self,
        num_batches_in_epoch: int,
        pipeline: TorchPipeline,
        sample_data_structure_blueprint: SampleDataGroup,
        contained_dataset: Optional[Any] = None,
        dali_generic_iterator_class: Optional[Any] = None,
        convert_sample_data_group_to_dict: bool = True,
        post_process_func: Optional[Callable] = None,
    ):
        """Args mirror the reference; ``num_batches_in_epoch`` is only
        reported by ``len()`` (DataLoader compatibility).
        ``dali_generic_iterator_class`` is accepted for source compatibility
        and ignored: the executor yields torch tensors directly."""
        del dali_generic_iterator_class
        self._num_batches_in_epoch = num_batches_in_epoch
        self._pipeline = pipeline
        self._blueprint = sample_data_structure_blueprint.get_empty_like_self()
        self._contained_dataset = contained_dataset
        self._convert = convert_sample_data_group_to_dict
        self._post_process_func = post_process_func

    def __iter__(self) -> "StructuredOutputIterator.SimpleIterator":
        return self.SimpleIterator(self)

    def _next(self) -> Union[SampleDataGroup, dict]:
        data = next(self._pipeline)
        structured = self._blueprint.get_empty_like_self()
        structured.set_data_from_iterator_output(data, 0)
        if self._convert:
            structured = structured.to_dictionary()
        if self._post_process_func is not None:
            structured = self._post_process_func(structured)
        return structured

    def reset(self):
        self._pipeline.reset()

    def get_state(self) -> dict:
        """Checkpoint/resume passthrough to :meth:`TorchPipeline.get_state`."""
        return self._pipeline.get_state()

    def set_state(self, state: dict):
        """Checkpoint/resume passthrough to :meth:`TorchPipeline.set_state`."""
        self._pipeline.set_state(state)

    @property
    def sample_data_structure_blueprint(self) -> SampleDataGroup:
        return self._blueprint.get_empty_like_self()

    @property
    def internal_iterator(self) -> TorchPipeline:
        return self._pipeline

    @property
    def dataset(self) -> Any:
        """DataLoader-compatibility property."""
        return self if self._contained_dataset is None else self._contained_dataset

    def __len__(self):
        return self._num_batches_in_epoch

    @classmethod
    def CreateAsDataLoaderObject(cls, *args, **kwargs):
        """Create an instance that also isinstance-checks as
        ``torch.utils.data.DataLoader``, for frameworks that type-check their
        loader. The class replaces DataLoader's ``__init__`` (whose attribute
        guard is never armed), so it behaves as this iterator: ``len()``,
        ``iter()`` and ``.dataset`` are its own."""
        from torch.utils.data import DataLoader

        masked = type(
            cls.__name__,
            (cls, DataLoader),
            {"__init__": cls.__init__},
        )
        return masked(*args, **kwargs)


# API-compat alias for call sites written against the reference naming.
DALIStructuredOutputIterator = StructuredOutputIterator
