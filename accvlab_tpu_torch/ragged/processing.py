"""Masked reductions and batch assembly helpers.

PyTorch port of ``accvlab_tpu/ragged/processing.py``. The reductions are
plain tensor ops; ``combine_data`` pads per-sample arrays on the host with
numpy and moves the result to the device once.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from .._device import resolve_device
from .bool_indexing import batched_bool_indexing, compact_by_mask
from .ragged_batch import SIZE_DTYPE, RaggedBatch, _as_tensor

Tensor = torch.Tensor


def average_over_targets(data: RaggedBatch, nans_to_zero: bool = True) -> Tensor:
    """Mean along the non-uniform dimension over valid entries only; empty
    samples give 0 (NaN and infinities are replaced by 0)."""
    masked = data.with_padded_set_to(0.0)
    summed = masked.tensor.sum(dim=data.non_uniform_dim)
    sizes = data.sample_sizes.to(summed.dtype)
    # after the reduction the batch dims still lead; broadcast the sizes
    # against any remaining data dims
    sizes = sizes.reshape(sizes.shape + (1,) * (summed.ndim - sizes.ndim))
    res = summed / sizes
    if nans_to_zero:
        res = torch.nan_to_num(res, nan=0.0, posinf=0.0, neginf=0.0)
    return res


def sum_over_targets(data: RaggedBatch) -> Tensor:
    """Sum along the non-uniform dimension over valid entries only."""
    return data.with_padded_set_to(0.0).tensor.sum(dim=data.non_uniform_dim)


def apply_mask_to_tensor(data: Tensor, mask: Tensor, value_to_set: float = 0.0) -> Tensor:
    """Set entries where ``mask`` is False to ``value_to_set``; the mask may
    have fewer (leading-aligned) dims than the data."""
    num_extra = data.ndim - mask.ndim
    if num_extra > 0:
        mask = mask.reshape(mask.shape + (1,) * num_extra)
    if mask.numel() == 0:
        return data
    return data.masked_fill(~mask.to(torch.bool), value_to_set)


def squeeze_except_batch_and_sample(
    data: Union[Tensor, RaggedBatch],
) -> Union[Tensor, RaggedBatch]:
    """Squeeze all size-1 dims except batch dims and the non-uniform dim
    (whose index is adjusted for dims squeezed away before it)."""
    if isinstance(data, RaggedBatch):
        nbd, nud = data.num_batch_dims, data.non_uniform_dim
        shape = data.shape
        dims_to_squeeze = tuple(
            d
            for d in list(range(nbd, nud)) + list(range(nud + 1, len(shape)))
            if shape[d] == 1
        )
        if not dims_to_squeeze:
            return data
        squeezed = data.tensor.squeeze(dims_to_squeeze)
        num_before = sum(1 for d in dims_to_squeeze if d < nud)
        return data.create_with_sample_sizes_like_self(squeezed, nud - num_before)
    dims = tuple(d for d in range(2, data.ndim) if data.shape[d] == 1)
    return data.squeeze(dims) if dims else data


def get_compact_lists(
    mask: Tensor,
    data: Sequence[Union[Tensor, Any]],
    max_num_vals: Optional[int] = None,
) -> List[Union[RaggedBatch, Any]]:
    """Compact each tensor in ``data`` along ``dim==1`` per the 2-D ``mask``.

    Non-tensor elements pass through unchanged; tensor outputs are
    :class:`RaggedBatch` instances sharing one mask / sample-sizes pair.
    Without ``max_num_vals`` the largest count is read back from the device.
    """
    mask = _as_tensor(mask).to(torch.bool)
    assert mask.ndim == 2, "Only 2D masks (batch_size, num_elements) are supported"
    num_vals = mask.sum(dim=1, dtype=SIZE_DTYPE)
    if max_num_vals is None:
        max_num_vals = int(num_vals.max().item()) if num_vals.numel() else 0

    out_mask = torch.arange(max_num_vals, dtype=SIZE_DTYPE, device=mask.device) < num_vals[:, None]
    res: List[Any] = []
    for el in data:
        if _is_arraylike(el) and np.ndim(el) > 0:
            el = _as_tensor(el, mask.device)
            if el.ndim < 2:
                el = el[:, None]
            compacted, _ = compact_by_mask(el, mask, max_num_vals)
            res.append(RaggedBatch(compacted, out_mask, num_vals))
        else:
            res.append(el)
    return res


def get_compact_from_named_tuple(
    mask: Tensor, data: NamedTuple, max_num_vals: Optional[int] = None
) -> NamedTuple:
    """:func:`get_compact_lists` over a NamedTuple."""
    res_list = get_compact_lists(mask, tuple(data), max_num_vals)
    return type(data)(*res_list)


def get_indices_from_mask(
    mask: Union[Tensor, RaggedBatch], max_output_size: Optional[int] = None
) -> RaggedBatch:
    """Per-sample indices of True mask entries (ascending), as a RaggedBatch."""
    if isinstance(mask, RaggedBatch):
        assert mask.num_batch_dims == 1, (
            "Only RaggedBatch instances with a single batch dimension are supported"
        )
        mask = mask.with_padded_set_to(False).tensor
    assert mask.ndim == 2, "Only 2D masks (batch_size, num_elements) are supported"
    batch_size, num_elements = mask.shape
    indices_all = torch.arange(num_elements, dtype=SIZE_DTYPE, device=mask.device)
    indices_all = indices_all[None, :].expand(batch_size, num_elements)
    return batched_bool_indexing(indices_all, mask, max_output_size)


# ---------------------------------------------------------------------- #
# combine_data (host-side batch assembly)                                #
# ---------------------------------------------------------------------- #


def _is_arraylike(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def combine_data(
    data_list: Sequence[Union[Sequence, Tensor, np.ndarray]],
    other_with_same_sample_sizes: Optional[RaggedBatch] = None,
    device=None,
    flatten_batch_dims: bool = True,
) -> RaggedBatch:
    """Combine a (nested) sequence of per-sample arrays into one RaggedBatch.

    ``flatten_batch_dims=True`` flattens nesting depth-first into one batch
    dim; ``False`` keeps the nesting levels as (uniform-size) batch dims.
    The padded layout is built on the host and moved to ``device`` once
    (default: the card; ``device="cpu"`` keeps it on the CPU). Dtypes are
    kept as given (no narrowing of 64-bit inputs, unlike JAX).
    """
    assert isinstance(data_list, Sequence), "`data_list` must be a sequence"
    assert len(data_list) > 0, "`data_list` must not be empty"
    dev = resolve_device(device)
    reuse = other_with_same_sample_sizes is not None

    def _put(data: np.ndarray) -> Tensor:
        return torch.from_numpy(data).to(dev)

    if flatten_batch_dims:
        flat: List[np.ndarray] = []

        def _flatten(d):
            if _is_arraylike(d):
                flat.append(_to_numpy(d))
            elif isinstance(d, Sequence) and not isinstance(d, str):
                for el in d:
                    _flatten(el)
            else:
                raise AssertionError(
                    "The data to combine must be an array or a (nested) sequence of arrays. "
                    f"Got {type(d)}."
                )

        _flatten(data_list)
        num_flat = len(flat)
        max_numel = max((el.shape[0] for el in flat), default=0)
        sample = next((el for el in flat if el.size > 0), flat[0] if flat else None)
        if sample is None:
            return RaggedBatch.Empty(2, 1, device=dev)

        data = np.zeros((num_flat, max_numel, *sample.shape[1:]), dtype=sample.dtype)
        sizes = np.zeros((num_flat,), dtype=np.int32)
        for i, el in enumerate(flat):
            size = min(el.shape[0], el.size)
            sizes[i] = size
            if size > 0:
                data[i, :size, ...] = el
        if reuse:
            assert num_flat == other_with_same_sample_sizes.sample_sizes.shape[0], (
                "Number of samples does not match `other_with_same_sample_sizes`"
            )
            assert (num_flat, max_numel) == tuple(other_with_same_sample_sizes.mask.shape), (
                "Needed mask dimension does not match `other_with_same_sample_sizes`"
            )
            return other_with_same_sample_sizes.create_with_sample_sizes_like_self(
                _put(data), 1, dev
            )
        return RaggedBatch(_put(data), sample_sizes=_put(sizes))

    # Nested mode: nesting levels become batch dims.
    def _get_batch_shape(d, level=0):
        assert isinstance(d, Sequence) and not isinstance(d, str), "`data` must be a sequence"
        first = d[0]
        if _is_arraylike(first):
            for item in d[1:]:
                if not _is_arraylike(item):
                    raise AssertionError(
                        f"Got {type(item)} contained in the sequence at level {level}."
                    )
            return [len(d)]
        sub = _get_batch_shape(first, level + 1)
        for item in d[1:]:
            if not isinstance(item, Sequence) or isinstance(item, str):
                raise AssertionError(
                    f"Got {type(item)} contained in the sequence at level {level + 1}."
                )
            if _get_batch_shape(item, level + 1) != sub:
                raise AssertionError(
                    f"Inconsistent sequence length structure at level {level + 1}."
                )
        return [len(d)] + sub

    def _first_element(d):
        return d if _is_arraylike(d) else _first_element(d[0])

    def _max_numel(d):
        if _is_arraylike(d):
            return d.shape[0]
        return max((_max_numel(el) for el in d), default=0)

    batch_shape = tuple(_get_batch_shape(data_list))
    nbd = len(batch_shape)
    if reuse:
        max_numel = other_with_same_sample_sizes.mask.shape[-1]
    else:
        max_numel = _max_numel(data_list)
    sample = _to_numpy(_first_element(data_list))

    if sample.size == 0 and max_numel == 0:
        data = np.zeros((*batch_shape, 0), dtype=np.float32)
        mask = np.zeros((*batch_shape, 0), dtype=bool)
        sizes = np.zeros(batch_shape, dtype=np.int32)
        return RaggedBatch(_put(data), _put(mask), _put(sizes), nbd)

    data = np.zeros((*batch_shape, max_numel, *sample.shape[1:]), dtype=sample.dtype)
    sizes = np.zeros(batch_shape, dtype=np.int32)

    def _fill(d, batch_idx=()):
        if _is_arraylike(d):
            d = _to_numpy(d)
            size = min(d.shape[0], d.size)
            if size > 0:
                data[batch_idx + (slice(0, size), Ellipsis)] = d
            sizes[batch_idx] = size
        else:
            for i, el in enumerate(d):
                _fill(el, batch_idx + (i,))

    _fill(data_list)
    if reuse:
        assert tuple(other_with_same_sample_sizes.sample_sizes.shape) == batch_shape, (
            "Sample sizes shape does not match required batch shape"
        )
        return other_with_same_sample_sizes.create_with_sample_sizes_like_self(
            _put(data), nbd, dev
        )
    return RaggedBatch(_put(data), sample_sizes=_put(sizes), non_uniform_dim=nbd)
