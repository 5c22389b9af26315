"""Batched boolean indexing over ragged batches.

PyTorch port of ``accvlab_tpu/ragged/bool_indexing.py``. The row-major
pairing of masked entries comes from a stable argsort of the inverted mask
(valid positions first, in their original order), sorted as an integer key
because a stable sort is what fixes the order; then a gather or scatter.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .indexing_ops import _expand_for_data
from .ragged_batch import SIZE_DTYPE, RaggedBatch

Tensor = torch.Tensor


def _compare_indexed_data_and_mask(data, mask):
    """Shape compatibility checks."""
    is_data_ragged = isinstance(data, RaggedBatch)
    is_mask_ragged = isinstance(mask, RaggedBatch)

    if is_data_ragged and is_mask_ragged:
        assert data.num_batch_dims == mask.num_batch_dims, (
            "Data and mask must have the same number of batch dimensions"
        )
        assert data.batch_shape == mask.batch_shape, "Data and mask must have the same batch shape"
        assert data.max_sample_size == mask.max_sample_size, (
            "Data and mask must have the same maximum sample size"
        )
    elif is_data_ragged:
        assert data.num_batch_dims == 1, (
            "Data must have exactly one batch dimension if mask is a tensor"
        )
        assert data.batch_shape[0] == mask.shape[0], (
            "Data and mask must have the same number of samples"
        )
        assert data.max_sample_size == mask.shape[1], (
            "Maximum sample size of data must correspond to `input_mask.shape[1]`"
        )
    elif is_mask_ragged:
        assert mask.num_batch_dims == 1, (
            "Mask must have exactly one batch dimension if data is a tensor"
        )
        assert mask.batch_shape[0] == data.shape[0], (
            "Mask and data must have the same number of samples"
        )
        assert mask.max_sample_size == data.shape[1], (
            "Maximum sample size of mask must correspond to `input_data.shape[1]`"
        )
    else:
        assert data.shape[0] == mask.shape[0], "Data and mask must have the same number of samples"
        assert data.shape[1] == mask.shape[1], (
            "Data and mask must have the same maximum sample size"
        )


def _mask_the_mask(mask, data) -> Tensor:
    """Force filler elements to False."""
    if isinstance(mask, RaggedBatch):
        return mask.with_padded_set_to(False).tensor.to(torch.bool)
    if isinstance(data, RaggedBatch):
        return mask.to(torch.bool) & data.mask
    return mask.to(torch.bool)


def stable_active_first(mask: Tensor) -> Tensor:
    """Per-row order that puts the True entries of ``mask (B, N)`` first,
    each group in its original order (int64 ``(B, N)``)."""
    return torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)


def compact_by_mask(data: Tensor, mask: Tensor, max_out: int, fill_value=0.0):
    """Compact the selected rows of ``data (B, N, *D)`` to the front.

    Returns ``(out (B, max_out, *D), counts (B,))`` where
    ``out[b, j] = data[b, p_j]`` with ``p_j`` the j-th True position of
    ``mask[b]``; remaining entries are ``fill_value``.
    """
    counts = mask.sum(dim=1, dtype=SIZE_DTYPE)
    pos = stable_active_first(mask)[:, :max_out]
    valid = torch.arange(max_out, dtype=SIZE_DTYPE, device=mask.device) < counts[:, None]
    if data.shape[1] == 0:
        gathered = data.new_zeros((data.shape[0], max_out, *data.shape[2:]))
    else:
        gathered = torch.gather(data, 1, _expand_for_data(pos, data))
    return gathered.masked_fill(~_expand_for_data(valid, gathered), fill_value), counts


def batched_bool_indexing(
    input_data: Union[RaggedBatch, Tensor],
    input_mask: Union[RaggedBatch, Tensor],
    max_output_size: Optional[int] = None,
) -> RaggedBatch:
    """Batched boolean gather: per sample, compact the True-masked entries.

    The output's max sample size is data dependent: without
    ``max_output_size`` it is read back from the device (one
    synchronisation). With a bound that is at least the true maximum the
    result is the same and nothing is read back.
    """
    _compare_indexed_data_and_mask(input_data, input_mask)

    is_data_ragged = isinstance(input_data, RaggedBatch)
    mask2d = _mask_the_mask(input_mask, input_data)

    if is_data_ragged:
        orig_nud = input_data.non_uniform_dim
        batch_shape = input_data.batch_shape
        multi_batch = input_data.num_batch_dims > 1
        rb = input_data
        if multi_batch:
            rb = rb.flatten_batch_dims()
            mask2d = mask2d.reshape((-1, mask2d.shape[-1]))
        rb = rb.get_non_uniform_dimension_transposed_to(1)
        data2d = rb.tensor
    else:
        data2d = input_data
        multi_batch = False

    if max_output_size is None:
        counts = mask2d.sum(dim=1, dtype=SIZE_DTYPE)
        max_output_size = int(counts.max().item()) if counts.numel() else 0

    out, counts = compact_by_mask(data2d, mask2d, max_output_size)
    res = RaggedBatch(out, sample_sizes=counts, non_uniform_dim=1)

    if is_data_ragged:
        if multi_batch:
            res = res.reshape_batch_dims(batch_shape)
        res = res.get_non_uniform_dimension_transposed_to(orig_nud)
    return res


def batched_bool_indexing_write(
    to_write: RaggedBatch,
    output_mask: Union[RaggedBatch, Tensor],
    to_write_into: Union[RaggedBatch, Tensor],
) -> Union[RaggedBatch, Tensor]:
    """Inverse of :func:`batched_bool_indexing`: write the valid entries of
    ``to_write`` to the True positions of ``output_mask`` in ``to_write_into``.

    Contract: per sample, the number of True entries in ``output_mask``
    equals ``to_write.sample_sizes``.
    """
    assert isinstance(to_write, RaggedBatch), "to_write must be a RaggedBatch"
    _compare_indexed_data_and_mask(to_write_into, output_mask)

    is_out_ragged = isinstance(to_write_into, RaggedBatch)
    mask2d = _mask_the_mask(output_mask, to_write_into)

    batch_shape = to_write.batch_shape
    multi_batch = to_write.num_batch_dims > 1
    assert to_write.dim() == to_write_into.dim(), (
        "to_write and to_write_into must have the same number of dimensions"
    )

    tw = to_write
    if multi_batch:
        tw = tw.flatten_batch_dims()
        mask2d = mask2d.reshape((-1, mask2d.shape[-1]))
    tw = tw.get_non_uniform_dimension_transposed_to(1)

    if is_out_ragged:
        orig_out_nud = to_write_into.non_uniform_dim
        out_rb = to_write_into
        if multi_batch:
            out_rb = out_rb.flatten_batch_dims()
        out_rb = out_rb.get_non_uniform_dimension_transposed_to(1)
        out2d = out_rb.tensor
    else:
        out2d = to_write_into

    num_write = tw.tensor.shape[1]
    n = out2d.shape[1]
    pos = stable_active_first(mask2d)[:, :num_write]
    valid = torch.arange(num_write, dtype=SIZE_DTYPE, device=pos.device) < tw.sample_sizes[:, None]
    safe_pos = torch.where(valid, pos, n)  # invalid slots go to the extra row

    pad = out2d.new_zeros((out2d.shape[0], 1, *out2d.shape[2:]))
    ext = torch.cat([out2d, pad], dim=1)
    res2d = ext.scatter(1, _expand_for_data(safe_pos, tw.tensor), tw.tensor)[:, :n]

    if is_out_ragged:
        res = out_rb.create_with_sample_sizes_like_self(res2d, 1)
        if multi_batch:
            res = res.reshape_batch_dims(batch_shape)
        return res.get_non_uniform_dimension_transposed_to(orig_out_nud)
    return res2d
