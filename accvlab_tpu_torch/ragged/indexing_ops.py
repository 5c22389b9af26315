"""Differentiable ragged gather/scatter ops.

PyTorch port of ``accvlab_tpu/ragged/indexing_ops.py``:

* The gather is ``torch.gather`` on indices made safe exactly as in the JAX
  package: negative indices wrap once, then clip into range, and the
  padding slots read index 0; their outputs are then set to the filler.
* Scatters drop out-of-range and padding slots as JAX's ``mode="drop"``
  does: they are redirected to one extra row of the output, which is cut
  off afterwards (``torch.scatter`` would raise on them). Their negative
  indices wrap twice, as the JAX package's do.
* The gather's adjoint is a deterministic scatter-add: duplicate indices
  are summed in ascending slot order (one collision-free ``scatter_add_``
  per slot), so the gradient is the same bits run to run and on the CPU
  and the card. Autograd through ``torch.gather`` would accumulate with
  atomics in no fixed order on the card.

All functions work on tensors with a leading batch dimension and read
nothing back to the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .ragged_batch import SIZE_DTYPE, RaggedBatch

Tensor = torch.Tensor


# ---------------------------------------------------------------------- #
# Flat-batch primitives (single batch dim, indexed dim at axis 1)        #
# ---------------------------------------------------------------------- #


def _valid_mask(num_indices: int, nums: Tensor) -> Tensor:
    iota = torch.arange(num_indices, dtype=SIZE_DTYPE, device=nums.device)
    return iota < nums.to(SIZE_DTYPE)[:, None]


def _wrap_negative(idx: Tensor, size: int) -> Tensor:
    return torch.where(idx < 0, idx + size, idx)


def _expand_for_data(x: Tensor, data: Tensor) -> Tensor:
    """``x`` of shape ``(B, I)`` viewed as ``(B, I, *data.shape[2:])``."""
    extra = data.shape[2:]
    return x.reshape(x.shape + (1,) * len(extra)).expand(*x.shape, *extra)


class _OrderedGather(torch.autograd.Function):
    """``torch.gather(data, 1, idx)`` whose backward sums duplicate indices
    in ascending slot order."""

    @staticmethod
    def forward(ctx, data: Tensor, idx: Tensor) -> Tensor:
        ctx.save_for_backward(idx)
        ctx.data_shape = data.shape
        return torch.gather(data, 1, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad: Tensor):
        (idx,) = ctx.saved_tensors
        out = grad.new_zeros(ctx.data_shape)
        for j in range(idx.shape[1]):
            out.scatter_add_(1, idx[:, j : j + 1], grad[:, j : j + 1])
        return out, None


def ragged_gather(data: Tensor, indices: Tensor, nums: Tensor, fill_value=0.0) -> Tensor:
    """``out[b, j] = data[b, indices[b, j]]`` for ``j < nums[b]``, else ``fill_value``.

    Shapes: ``data (B, N, *D)``, ``indices (B, I)``, ``nums (B,)`` ->
    ``out (B, I, *D)``. Negative indices wrap; indices still out of range
    are clipped into it.
    """
    n = data.shape[1]
    num_indices = indices.shape[1]
    valid = _valid_mask(num_indices, nums)
    if n == 0:
        out = data.new_zeros((data.shape[0], num_indices, *data.shape[2:]))
    else:
        idx = _wrap_negative(indices.to(torch.int64), n)
        safe = torch.where(valid, idx.clamp(0, n - 1), 0)
        out = _OrderedGather.apply(data, _expand_for_data(safe, data))
    return out.masked_fill(~_expand_for_data(valid, out), fill_value)


def _safe_scatter_indices(indices: Tensor, nums: Tensor, num_targets: int) -> Tensor:
    """Scatter rows for ``indices``: padding slots and indices still out of
    range go to row ``num_targets``, the extra row. Negative indices wrap
    twice, as in the JAX package, whose ``.at[]`` scatter wraps the already
    wrapped index once more."""
    idx = _wrap_negative(_wrap_negative(indices.to(torch.int64), num_targets), num_targets)
    valid = _valid_mask(indices.shape[1], nums) & (idx >= 0) & (idx < num_targets)
    return torch.where(valid, idx, num_targets)


def _scatter_rows(out: Tensor, safe_idx: Tensor, values: Tensor, accumulate: bool) -> Tensor:
    """Scatter ``values (B, I, *D)`` into ``out (B, T, *D)`` at ``safe_idx
    (B, I)``; rows ``>= T`` are dropped. Accumulation sums duplicates in
    ascending slot order."""
    t = out.shape[1]
    pad = out.new_zeros((out.shape[0], 1, *out.shape[2:]))
    ext = torch.cat([out, pad], dim=1)
    idx = _expand_for_data(safe_idx, values)
    if accumulate:
        for j in range(idx.shape[1]):
            ext = ext.scatter_add(1, idx[:, j : j + 1], values[:, j : j + 1])
    else:
        ext = ext.scatter(1, idx, values)
    return ext[:, :t]


def ragged_scatter_new(
    values: Tensor,
    indices: Tensor,
    nums: Tensor,
    num_targets: int,
    fill_value=0.0,
    accumulate: bool = False,
) -> Tensor:
    """``out[b, indices[b, j]] = values[b, j]`` for ``j < nums[b]``, over a
    fresh ``fill_value``-initialized output of size ``num_targets`` along axis 1."""
    out = values.new_full((values.shape[0], num_targets, *values.shape[2:]), fill_value)
    safe = _safe_scatter_indices(indices, nums, num_targets)
    return _scatter_rows(out, safe, values, accumulate)


def ragged_scatter_insert(values: Tensor, indices: Tensor, nums: Tensor, into: Tensor) -> Tensor:
    """Like :func:`ragged_scatter_new` but writing into an existing tensor."""
    safe = _safe_scatter_indices(indices, nums, into.shape[1])
    return _scatter_rows(into, safe, values, accumulate=False)


# ---------------------------------------------------------------------- #
# Layout normalization shared by the public wrappers                     #
# ---------------------------------------------------------------------- #


def _normalize(data: Tensor, indices: RaggedBatch, dim_to_index_in: Optional[int]):
    """Flatten batch dims of ``data``/``indices`` and move the indexed dim of
    ``data`` to axis 1. Returns (data2d, idx2d, nums1d, restore_fn, dim)."""
    nbd = indices.num_batch_dims
    if dim_to_index_in is None:
        dim_to_index_in = indices.non_uniform_dim
    assert dim_to_index_in >= nbd, "Cannot index in a batch dimension of the indices"

    batch_shape = indices.batch_shape
    assert tuple(data.shape[:nbd]) == batch_shape, (
        f"Batch shape of data {tuple(data.shape[:nbd])} does not match indices batch "
        f"shape {batch_shape}"
    )

    transposed = dim_to_index_in != nbd
    if transposed:
        data = data.transpose(nbd, dim_to_index_in)

    flat_b = 1
    for s in batch_shape:
        flat_b *= s
    data_flat = data.reshape((flat_b,) + tuple(data.shape[nbd:]))
    idx_flat = indices.tensor.reshape((flat_b, indices.tensor.shape[nbd]))
    nums_flat = indices.sample_sizes.reshape((flat_b,))

    def restore(res: Tensor, out_dim1_size: int) -> Tensor:
        res = res.reshape(batch_shape + (out_dim1_size,) + tuple(res.shape[2:]))
        if transposed:
            res = res.transpose(nbd, dim_to_index_in)
        return res

    return data_flat, idx_flat, nums_flat, restore, dim_to_index_in


# ---------------------------------------------------------------------- #
# Public API                                                             #
# ---------------------------------------------------------------------- #


def batched_indexing_access(
    input_data: Union[RaggedBatch, Tensor],
    input_indices: RaggedBatch,
    filler_value: float = 0.0,
    dim_to_index_in: Optional[int] = None,
) -> RaggedBatch:
    """Batched gather with non-uniform indices.

    For sample ``i`` and valid index ``j < input_indices.sample_sizes[i]``
    (with ``dim_to_index_in == 1``): ``out[i, j] == input_data[i,
    input_indices[i, j]]``; other entries are ``filler_value``. The adjoint
    is a deterministic scatter-add (duplicate indices accumulate).
    """
    if isinstance(input_data, RaggedBatch):
        input_data = input_data.tensor
    data_flat, idx_flat, nums_flat, restore, dim = _normalize(
        input_data, input_indices, dim_to_index_in
    )
    res = ragged_gather(data_flat, idx_flat, nums_flat, filler_value)
    res = restore(res, idx_flat.shape[1])
    return input_indices.create_with_sample_sizes_like_self(res, dim)


def batched_inverse_indexing_access(
    input_data: Union[RaggedBatch, Tensor],
    output_indices: RaggedBatch,
    output_num_targets: int,
    filler_value: float = 0.0,
    dim_to_index_in: Optional[int] = None,
) -> Tensor:
    """Batched scatter into a fresh ``filler_value`` tensor.

    For sample ``i`` and valid ``j``: ``out[i, output_indices[i, j]] ==
    input_data[i, j]``. Duplicate valid indices are undefined.
    """
    if isinstance(input_data, RaggedBatch):
        input_data = input_data.tensor
    data_flat, idx_flat, nums_flat, restore, _ = _normalize(
        input_data, output_indices, dim_to_index_in
    )
    res = ragged_scatter_new(data_flat, idx_flat, nums_flat, output_num_targets, filler_value)
    return restore(res, output_num_targets)


def batched_indexing_write(
    to_write: Union[RaggedBatch, Tensor],
    output_indices: RaggedBatch,
    to_write_into: Union[RaggedBatch, Tensor],
    dim_to_index_in: Optional[int] = None,
) -> Union[RaggedBatch, Tensor]:
    """Batched scatter into an existing tensor (out of place).

    Returns ``to_write_into`` with ``to_write`` values inserted at the given
    indices. Gradients: the ``to_write_into`` adjoint has the written
    positions zeroed, the ``to_write`` adjoint is a gather.
    """
    is_out_ragged = isinstance(to_write_into, RaggedBatch)
    if isinstance(to_write, RaggedBatch):
        to_write = to_write.tensor
    into_data = to_write_into.tensor if is_out_ragged else to_write_into

    nbd = output_indices.num_batch_dims
    if dim_to_index_in is None:
        dim_to_index_in = output_indices.non_uniform_dim
    assert dim_to_index_in >= nbd, "Cannot index in a batch dimension of the output indices"

    data_flat, idx_flat, nums_flat, restore, _ = _normalize(
        to_write, output_indices, dim_to_index_in
    )
    if dim_to_index_in != nbd:
        into_data = into_data.transpose(nbd, dim_to_index_in)
    num_targets = into_data.shape[nbd]
    into_flat = into_data.reshape(
        (data_flat.shape[0], num_targets) + tuple(into_data.shape[nbd + 1 :])
    )

    res = ragged_scatter_insert(data_flat, idx_flat, nums_flat, into_flat)
    res = restore(res, num_targets)
    if is_out_ragged:
        return to_write_into.create_with_sample_sizes_like_self(res)
    return res


def batched_index_mapping(
    source_data: Union[RaggedBatch, Tensor],
    source_indices: RaggedBatch,
    target_indices: RaggedBatch,
    target_data: Union[RaggedBatch, Tensor],
) -> Union[RaggedBatch, Tensor]:
    """Map values between tensors via index pairs:
    ``target_data[i, target_indices[i, j]] = source_data[i, source_indices[i, j]]``
    for valid ``j``.

    Contracts: ``source_indices.sample_sizes == target_indices.sample_sizes``;
    no duplicate valid target indices.
    """
    nbd = source_indices.num_batch_dims
    assert target_indices.num_batch_dims == nbd
    assert (
        source_indices.tensor.ndim == nbd + 1 and target_indices.tensor.ndim == nbd + 1
    ), "Indices must have exactly one dimension in addition to the batch dimensions"
    assert source_indices.batch_shape == target_indices.batch_shape, "Batch shape mismatch"
    assert (
        source_indices.shape[nbd] == target_indices.shape[nbd]
    ), "Maximum number of indices mismatch"

    is_target_ragged = isinstance(target_data, RaggedBatch)
    if is_target_ragged:
        target_nud = target_data.non_uniform_dim
        target_rb = target_data.get_non_uniform_dimension_transposed_to(nbd)
        target_tensor = target_rb.tensor
    else:
        target_tensor = target_data
    if isinstance(source_data, RaggedBatch):
        source_data = source_data.get_non_uniform_dimension_transposed_to(nbd).tensor

    gathered = batched_indexing_access(source_data, source_indices, 0.0, nbd)
    res = batched_indexing_write(gathered.tensor, target_indices, target_tensor, nbd)

    if is_target_ragged:
        res_rb = target_rb.create_with_sample_sizes_like_self(res, nbd)
        return res_rb.get_non_uniform_dimension_transposed_to(target_nud)
    return res


def get_mask_from_indices(mask_num_targets: int, indices: RaggedBatch) -> Tensor:
    """Boolean mask with ``True`` at the (valid) given indices per sample."""
    nbd = indices.num_batch_dims
    idx = indices.tensor.reshape((-1, indices.tensor.shape[nbd]))
    nums = indices.sample_sizes.reshape((-1,))
    safe = _safe_scatter_indices(idx, nums, mask_num_targets)
    out = torch.zeros((idx.shape[0], mask_num_targets + 1), dtype=torch.bool, device=idx.device)
    out = out.scatter(1, safe, True)[:, :mask_num_targets]
    return out.reshape(indices.batch_shape + (mask_num_targets,))
