"""Ragged batches (minimal port: see :mod:`.ragged_batch`)."""

from .ragged_batch import RaggedBatch

__all__ = ["RaggedBatch"]
