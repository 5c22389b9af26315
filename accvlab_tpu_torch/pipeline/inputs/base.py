"""Abstract input interfaces (parity: reference ``inputs/callable_base.py:24``,
``iterable_base.py:21``, ``data_provider.py:20``, ``sampler_base.py:19``)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..sample_data_group import SampleDataGroup


@dataclass(frozen=True)
class SampleInfo:
    """Identifies one sample request (equivalent of DALI's
    ``types.SampleInfo``)."""

    idx_in_epoch: int  # flat sample index within the current epoch
    idx_in_batch: int  # position within the batch
    iteration: int  # batch index within the current epoch
    epoch_idx: int  # epoch counter


class CallableBase(ABC):
    """Per-sample input callable: ``__call__(SampleInfo) -> flat value tuple``.

    The executor invokes it from parallel workers; implementations must be
    safe to call concurrently for different samples (or picklable for process
    workers). Raise ``StopIteration`` to signal the epoch end.
    """

    @property
    @abstractmethod
    def used_sample_data_structure(self) -> SampleDataGroup:
        """Blueprint of one sample's data format."""

    @abstractmethod
    def __call__(self, sample_info: SampleInfo) -> Tuple:
        """Produce the flat data tuple for the requested sample
        (``SampleDataGroup.get_data()`` order)."""

    @property
    def length(self) -> Optional[int]:
        """Batches per epoch, or ``None`` if not epoch-based."""
        return None


class IterableBase(ABC):
    """Per-batch input iterable: ``__next__() -> tuple of per-field batches``.

    Each element of the returned tuple is a list of per-sample arrays for one
    flat field (DALI external-source batch convention).
    """

    @property
    @abstractmethod
    def used_sample_data_structure(self) -> SampleDataGroup:
        """Blueprint of one sample's data format."""

    def __iter__(self) -> "IterableBase":
        return self

    @abstractmethod
    def __next__(self) -> tuple:
        """Next batch as a tuple of per-field lists of per-sample arrays."""

    @property
    def length(self) -> Optional[int]:
        return None

    def get_state(self) -> dict:
        """Cheap, JSON-serializable snapshot of the iterable position (see
        :meth:`SamplerBase.get_state`). Optional: iterables that do not
        implement it make the owning pipeline's ``get_state`` record ``None``
        for the input and resume is counter-only (exact for stateless
        inputs, unsupported for stateful ones)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the checkpoint/resume "
            "protocol (get_state/set_state)."
        )

    def set_state(self, state: dict) -> None:
        """Restore a position captured by :meth:`get_state`."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the checkpoint/resume "
            "protocol (get_state/set_state)."
        )


class DataProvider(ABC):
    """Random-access dataset adapter: index -> SampleDataGroup."""

    @abstractmethod
    def get_data(self, sample_index: int) -> SampleDataGroup:
        """Load sample ``sample_index`` as a filled SampleDataGroup."""

    @abstractmethod
    def get_number_of_samples(self) -> int:
        """Dataset size."""

    @property
    @abstractmethod
    def sample_data_structure(self) -> SampleDataGroup:
        """Blueprint of one sample's data format."""


class SamplerBase(ABC):
    """Batch-index sampler."""

    @abstractmethod
    def get_next_batch_indices(self) -> List[int]:
        """Sample indices for the next batch; raise ``StopIteration`` at the
        epoch end (epoch-based samplers only)."""

    @property
    @abstractmethod
    def is_epoch_based(self) -> bool:
        """Whether the sampler has epoch boundaries."""

    @abstractmethod
    def reset(self):
        """Start a new epoch (epoch-based samplers only)."""

    @property
    def length(self) -> Optional[int]:
        """Batches per epoch, or ``None``."""
        return None

    # -- checkpoint/resume protocol (beyond reference parity: the reference
    # has no mid-run resume API anywhere, SURVEY §5.4; on preemptible
    # fleets the input pipeline must resume exactly or data is silently
    # repeated/skipped after every preemption) ------------------------------

    def get_state(self) -> dict:
        """Cheap, JSON-serializable snapshot of the sampler position.

        Restoring via :meth:`set_state` on a freshly constructed sampler with
        the same constructor arguments must reproduce the draw stream exactly
        (``get_next_batch_indices`` returns the same batches in the same
        order as an uninterrupted run would have).
        """
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the checkpoint/resume "
            "protocol (get_state/set_state)."
        )

    def set_state(self, state: dict) -> None:
        """Restore a position captured by :meth:`get_state`."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the checkpoint/resume "
            "protocol (get_state/set_state)."
        )
