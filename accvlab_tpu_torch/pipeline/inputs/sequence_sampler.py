"""Sequence sampler for video-style consecutive-frame batches
(parity: reference ``inputs/sequence_sampler.py:27-184``).

The port's own copy of ``accvlab_tpu/pipeline/inputs/sequence_sampler.py``
(numpy only): the same index stream and resume state for the same
arguments."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .base import SamplerBase


class SequenceSampler(SamplerBase):
    """Sample consecutive frames from a multi-sequence dataset.

    Each batch slot is assigned a subset of sequences and walks each assigned
    sequence frame by frame; when a slot exhausts its sequences, a new
    (seeded) shuffled assignment cycle begins. Slot ``i``'s batch position
    therefore always advances temporally within one sequence — the access
    pattern that lets a stream decoder decode forward without re-seeking.
    """

    def __init__(
        self,
        total_batch_size: int,
        sequence_lengths: Sequence[int] = None,
        seed: int = None,
        randomize: bool = True,
        *,
        sequence_lenghts: Sequence[int] = None,
    ):
        """Args mirror the reference: ``sequence_lengths[s]`` is the number of
        consecutive dataset indices belonging to sequence ``s`` (sequences are
        laid out back to back in the dataset index space). The reference
        spells the parameter ``sequence_lenghts`` (sequence_sampler.py:60);
        both spellings are accepted."""
        if sequence_lengths is None:
            sequence_lengths = sequence_lenghts
        assert sequence_lengths is not None, "sequence_lengths is required"
        assert seed is not None, "seed is required"
        assert len(sequence_lengths) >= total_batch_size, (
            "The number of sequences must be at least the total batch size."
        )
        self._total_batch_size = total_batch_size
        self._sequence_lengths = list(sequence_lengths)
        starts = np.concatenate([[0], np.cumsum(self._sequence_lengths)[:-1]])
        self._sequence_starts = [int(s) for s in starts]
        self._seed = seed
        self._randomize = randomize
        # Generators are created lazily so the sampler can be pickled into
        # worker processes before first use (same constraint as the reference).
        self._slot_generators = None
        self._draws = 0  # batches drawn since construction (resume protocol)

    @property
    def length(self):
        return None  # no epoch boundaries

    @property
    def is_epoch_based(self) -> bool:
        return False

    def reset(self):
        raise RuntimeError(
            "SequenceSampler is not epoch-based; `reset()` should not be called."
        )

    def _slot_generator(self, slot_idx: int):
        rand = np.random.default_rng(seed=self._seed)
        num_sequences = len(self._sequence_lengths)
        while True:
            if self._randomize:
                order = rand.permutation(num_sequences)
            else:
                order = np.arange(num_sequences)
            assigned = order[slot_idx :: self._total_batch_size]
            assert len(assigned) > 0
            for seq_id in assigned:
                start = self._sequence_starts[seq_id]
                for offset in range(self._sequence_lengths[seq_id]):
                    yield start + offset

    def get_next_batch_indices(self) -> List[int]:
        if self._slot_generators is None:
            self._slot_generators = [
                self._slot_generator(i) for i in range(self._total_batch_size)
            ]
        self._draws += 1
        return [next(g) for g in self._slot_generators]

    def get_state(self) -> dict:
        """Resume snapshot: the number of batches drawn. O(1) to capture."""
        return {"draws": self._draws}

    def set_state(self, state: dict) -> None:
        """Fast-forward a fresh (or in-use) sampler to ``state``.

        The draw stream is a pure function of the constructor arguments, so
        replaying ``draws`` batches of index arithmetic (no data access,
        ~100 ns per slot per draw) reproduces the generator positions
        exactly; the next ``get_next_batch_indices`` returns what the
        uninterrupted run would have returned.
        """
        draws = int(state["draws"])
        if self._slot_generators is not None and draws < self._draws:
            # generators cannot rewind: restart the deterministic stream
            self._slot_generators = None
            self._draws = 0
        for _ in range(draws - self._draws):
            self.get_next_batch_indices()
