"""Non-uniform (ragged) batching: PyTorch port of ``accvlab_tpu.ragged``.

Same public API, except auction matching (``matching.py``), which is not
ported yet.
"""

from .ragged_batch import RaggedBatch, SIZE_DTYPE
from .indexing_ops import (
    batched_indexing_access,
    batched_inverse_indexing_access,
    batched_indexing_write,
    batched_index_mapping,
    get_mask_from_indices,
    ragged_gather,
    ragged_scatter_new,
    ragged_scatter_insert,
)
from .bool_indexing import (
    batched_bool_indexing,
    batched_bool_indexing_write,
    compact_by_mask,
)
from .processing import (
    average_over_targets,
    sum_over_targets,
    apply_mask_to_tensor,
    squeeze_except_batch_and_sample,
    get_compact_from_named_tuple,
    get_compact_lists,
    combine_data,
    get_indices_from_mask,
)

__all__ = [
    "RaggedBatch",
    "SIZE_DTYPE",
    "apply_mask_to_tensor",
    "average_over_targets",
    "batched_bool_indexing",
    "batched_bool_indexing_write",
    "batched_index_mapping",
    "batched_indexing_access",
    "batched_indexing_write",
    "batched_inverse_indexing_access",
    "combine_data",
    "compact_by_mask",
    "get_compact_from_named_tuple",
    "get_compact_lists",
    "get_indices_from_mask",
    "get_mask_from_indices",
    "ragged_gather",
    "ragged_scatter_insert",
    "ragged_scatter_new",
    "squeeze_except_batch_and_sample",
    "sum_over_targets",
]
