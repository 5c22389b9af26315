"""Shuffled + sharded random-access input callable
(parity: reference ``inputs/sfuffled_sharded_input_callable.py:32-126``).

This is the data-parallel input sharding contract: every process builds the
same per-epoch permutation from the same seed, then reads only its shard's
contiguous slice — under ``torch.distributed``, pass
``shard_id=rank, num_shards=world_size``. Copy of the JAX package's module.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .base import CallableBase, DataProvider, SampleInfo
from ..sample_data_group import SampleDataGroup


class ShuffledShardedInputCallable(CallableBase):
    """Per-epoch reshuffled, rank-sharded sample loading."""

    def __init__(
        self,
        data_provider: DataProvider,
        batch_size: int,
        shard_id: int = 0,
        num_shards: int = 1,
        shuffle: bool = False,
        seed: int = 21,
    ):
        """Identical contract to the reference: all shards must use the same
        ``seed`` so their permutations agree (no duplicated/skipped samples)."""
        self._data_provider = data_provider
        self._batch_size = batch_size
        self._shard_id = shard_id
        self._num_shards = num_shards
        self._shuffle = shuffle
        self._seed = seed

        self._data_len = data_provider.get_number_of_samples()
        self._shard_size = self._data_len // num_shards
        self._shard_offset = self._shard_size * shard_id
        self._full_iterations = self._shard_size // batch_size

        self._permutation = None
        self._last_seen_epoch = -1

    @property
    def used_sample_data_structure(self) -> SampleDataGroup:
        res = self._data_provider.sample_data_structure
        res.set_apply_mapping(False)
        return res

    def _setup_permutation(self, epoch_idx: int) -> np.ndarray:
        if self._shuffle:
            return np.random.default_rng(seed=self._seed + epoch_idx).permutation(
                self._data_len
            )
        return np.arange(self._data_len)

    def __call__(self, sample_info: SampleInfo) -> tuple:
        if sample_info.idx_in_epoch >= self._shard_size:
            raise StopIteration
        if self._last_seen_epoch != sample_info.epoch_idx:
            self._permutation = self._setup_permutation(sample_info.epoch_idx)
            self._last_seen_epoch = sample_info.epoch_idx
        index_in_shard = self._shard_offset + sample_info.idx_in_epoch % self._shard_size
        index_to_use = int(self._permutation[index_in_shard])
        return self._data_provider.get_data(index_to_use).get_data()

    @property
    def length(self) -> Optional[int]:
        return self._full_iterations
