"""Sampler-driven input iterable (parity: reference
``inputs/sampler_input_iterable.py:30-140``).

Unlike :class:`SamplerInputCallable`, the sampler state advances lazily with
iteration (no precomputed lookup table) — but the iterable runs in the main
process, so sample loading is not parallelized across workers.

The port's own copy of ``accvlab_tpu/pipeline/inputs/sampler_input_iterable.py``."""

from __future__ import annotations

from typing import Optional

from .base import DataProvider, IterableBase, SamplerBase
from ..sample_data_group import SampleDataGroup


class SamplerInputIterable(IterableBase):
    """Per-batch iterable over a :class:`SamplerBase`."""

    def __init__(
        self,
        data_provider: DataProvider,
        sampler: SamplerBase,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        self._data_provider = data_provider
        self._sampler = sampler
        self._shard_id = shard_id
        self._num_shards = num_shards

    @property
    def used_sample_data_structure(self) -> SampleDataGroup:
        res = self._data_provider.sample_data_structure
        res.set_apply_mapping(False)
        return res

    def __iter__(self) -> "SamplerInputIterable":
        if self._sampler.is_epoch_based:
            self._sampler.reset()
        return self

    def __next__(self) -> tuple:
        indices = self._sampler.get_next_batch_indices()  # may raise StopIteration
        local_bs = len(indices) // self._num_shards
        assert local_bs * self._num_shards == len(indices), (
            "Total batch size not divisible by number of shards"
        )
        shard_indices = indices[self._shard_id * local_bs : (self._shard_id + 1) * local_bs]
        per_sample = [self._data_provider.get_data(int(i)).get_data() for i in shard_indices]
        # transpose: per-sample tuples -> per-field lists (batch convention)
        num_fields = len(per_sample[0])
        return tuple([s[f] for s in per_sample] for f in range(num_fields))

    @property
    def length(self) -> Optional[int]:
        return self._sampler.length

    def get_state(self) -> dict:
        """Resume snapshot: the wrapped sampler's state (the data provider is
        stateless random access, so the sampler position IS the iterable
        position)."""
        return {"sampler": self._sampler.get_state()}

    def set_state(self, state: dict) -> None:
        self._sampler.set_state(state["sampler"])
