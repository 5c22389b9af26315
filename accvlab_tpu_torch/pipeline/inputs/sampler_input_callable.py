"""Sampler-driven input callable (parity: reference
``inputs/sampler_input_callable.py:31-150``).

Pre-computes the sampler's batch-index lookup table so the per-sample calls
are pure random access — required for parallel worker execution (the workers
cannot share the sampler's mutable state).

The port's own copy of ``accvlab_tpu/pipeline/inputs/sampler_input_callable.py``."""

from __future__ import annotations

from typing import Optional

from .base import CallableBase, DataProvider, SampleInfo, SamplerBase
from ..sample_data_group import SampleDataGroup


class SamplerInputCallable(CallableBase):
    """Turns any :class:`SamplerBase` into a parallel-safe input callable."""

    def __init__(
        self,
        data_provider: DataProvider,
        sampler: SamplerBase,
        max_num_iterations: int,
        pre_fetch_queue_length: int,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        """The lookup table covers ``max_num_iterations +
        pre_fetch_queue_length`` batches (the prefetcher reads ahead)."""
        self._data_provider = data_provider
        self._shard_id = shard_id
        self._num_shards = num_shards
        self._max_num_iterations = max_num_iterations
        self._pre_fetch_queue_length = pre_fetch_queue_length
        max_total = max_num_iterations + pre_fetch_queue_length

        self._look_up_table = []
        current_epoch = []
        i = 0
        while i < max_total:
            try:
                current_epoch.append(sampler.get_next_batch_indices())
                i += 1
            except StopIteration:
                self._look_up_table.append(current_epoch)
                current_epoch = []
                sampler.reset()
        self._look_up_table.append(current_epoch)

        self._total_batch_size = len(self._look_up_table[0][0])
        self._local_batch_size = self._total_batch_size // num_shards
        assert self._local_batch_size * num_shards == self._total_batch_size, (
            f"Total batch size ({self._total_batch_size}) not divisible by "
            f"number of shards ({num_shards})."
        )

    @property
    def used_sample_data_structure(self) -> SampleDataGroup:
        res = self._data_provider.sample_data_structure
        res.set_apply_mapping(False)
        return res

    def __call__(self, sample_info: SampleInfo) -> tuple:
        epoch_idx = sample_info.epoch_idx
        batch_idx = sample_info.idx_in_epoch // self._local_batch_size
        if epoch_idx >= len(self._look_up_table):
            raise RuntimeError(
                "Maximum iteration count or prefetch depth exceeded: "
                f"SamplerInputCallable was built for {self._max_num_iterations} "
                f"iterations + {self._pre_fetch_queue_length} prefetched batches."
            )
        epoch_table = self._look_up_table[epoch_idx]
        if batch_idx >= len(epoch_table):
            raise StopIteration
        idx_in_full_batch = (
            sample_info.idx_in_batch + self._shard_id * self._local_batch_size
        )
        index_to_use = int(epoch_table[batch_idx][idx_in_full_batch])
        return self._data_provider.get_data(index_to_use).get_data()

    @property
    def length(self) -> Optional[int]:
        return len(self._look_up_table[0])
