"""RaggedBatch: padded-dense representation of variable-size-per-sample batches.

PyTorch port of ``accvlab_tpu/ragged/ragged_batch.py``. A batch is

* ``tensor``: padded data, shape ``(*batch_shape, ..., max_sample_size, ...)``
  with the non-uniform dimension at ``non_uniform_dim``;
* ``mask``: bool validity mask, shape ``(*batch_shape, max_sample_size)``;
* ``sample_sizes``: per-sample valid counts (int32), shape ``batch_shape``.

``mask`` and ``sample_sizes`` derive lazily from each other. Methods that
return a new instance never modify ``tensor`` in place, as in the JAX
package; the two rebinding methods (``set_padded_to``, ``__setitem__``)
replace ``tensor`` by a new tensor, so an instance that shares the old one
does not see the change.

Differences from the JAX package:

* registered as a ``torch.utils._pytree`` node (``serialized_type_name``
  ``accvlab_tpu_torch.ragged.RaggedBatch``) with the JAX package's children
  ``(tensor, mask, sample_sizes)``, both derived ones materialized, so ``torch.export`` programs return
  RaggedBatches and the serving runtime splits them leaf by leaf;
* ``mask`` and ``sample_sizes`` are moved to the tensor's device, and
  ``sample_sizes`` is cast to int32 (numpy inputs become CPU tensors);
* ``long()`` and ``double()`` give int64 and float64, PyTorch's own widths.

Only ``FromOversizeTensor`` without ``max_sample_size``,
``total_num_entries`` and ``split`` read values back to the host.
"""

from __future__ import annotations

import inspect
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device

SIZE_DTYPE = torch.int32


def _callable_positional_arity(fn: Callable) -> int:
    """Positional arity of any callable — plain functions, lambdas,
    ``functools.partial``, bound methods, and ``__call__`` objects.

    ``inspect.signature`` already accounts for ``self`` binding and
    partial-applied arguments; callables it cannot introspect (C functions)
    default to arity 1, as does ``*args``.
    """
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return 1
    n = 0
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            n += 1
        elif p.kind == p.VAR_POSITIONAL:
            return 1
    return n


def _as_tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


class RaggedBatch:
    """Batch container for samples with variable size in one dimension.

    Args:
        tensor: the padded data.
        mask: optional bool ``(*batch_shape, max_sample_size)``.
        sample_sizes: optional int ``batch_shape`` valid counts.
        non_uniform_dim: the dimension of ``tensor`` that varies per sample
            (default: the one after the batch dimensions).

    At least one of ``mask`` and ``sample_sizes`` is needed. If both are
    given they must agree; this is not checked (as in the JAX package).
    """

    __slots__ = (
        "_tensor",
        "_mask",
        "_sample_sizes",
        "_non_uniform_dim",
        "_num_batch_dims",
        "_batch_shape",
        "_total_num_targets",
    )

    def __init__(
        self,
        tensor,
        mask=None,
        sample_sizes=None,
        non_uniform_dim: Optional[int] = None,
    ):
        assert (
            mask is not None or sample_sizes is not None
        ), "At least one of `mask` or `sample_sizes` needs to be set"

        tensor = _as_tensor(tensor)
        device = tensor.device
        mask = _as_tensor(mask, device).to(torch.bool) if mask is not None else None
        if sample_sizes is not None:
            sample_sizes = _as_tensor(sample_sizes, device).to(SIZE_DTYPE)

        if sample_sizes is not None:
            num_batch_dims = sample_sizes.ndim
        else:
            num_batch_dims = mask.ndim - 1

        assert num_batch_dims > 0, "Number of batch dimensions needs to be greater than 0"
        assert (
            num_batch_dims < tensor.ndim
        ), "The number of dimensions of the tensor needs to be at least num_batch_dims + 1"

        if non_uniform_dim is None:
            non_uniform_dim = num_batch_dims
        if non_uniform_dim < 0:
            non_uniform_dim = tensor.ndim + non_uniform_dim

        assert (
            num_batch_dims <= non_uniform_dim < tensor.ndim
        ), "Non-uniform dimension needs to be in the range [num_batch_dims; tensor.ndim["

        assert mask is None or (
            mask.shape[:num_batch_dims] == tensor.shape[:num_batch_dims]
            and mask.shape[num_batch_dims] == tensor.shape[non_uniform_dim]
        ), (
            "Shape of `tensor` does not match the required shape:\n"
            f"  According to mask: batch {tuple(mask.shape[:num_batch_dims])}, "
            f"max sample size {mask.shape[num_batch_dims]}\n"
            f"  According to tensor: batch {tuple(tensor.shape[:num_batch_dims])}, "
            f"max sample size {tensor.shape[non_uniform_dim]}"
        )
        assert sample_sizes is None or (
            sample_sizes.shape[:num_batch_dims] == tensor.shape[:num_batch_dims]
        ), (
            "Batch shape according to `tensor` does not match `sample_sizes`:\n"
            f"  tensor: {tuple(tensor.shape[:num_batch_dims])}  "
            f"sample_sizes: {tuple(sample_sizes.shape[:num_batch_dims])}"
        )

        self._tensor = tensor
        self._mask = mask
        self._sample_sizes = sample_sizes
        self._non_uniform_dim = int(non_uniform_dim)
        self._num_batch_dims = int(num_batch_dims)
        self._batch_shape = tuple(tensor.shape[:num_batch_dims])
        self._total_num_targets = None

    # ------------------------------------------------------------------ #
    # Constructors                                                       #
    # ------------------------------------------------------------------ #

    @classmethod
    def FromOversizeTensor(
        cls,
        tensor,
        mask=None,
        sample_sizes=None,
        non_uniform_dim: Optional[int] = None,
        max_sample_size: Optional[int] = None,
    ) -> "RaggedBatch":
        """Create from a tensor over-sized in the non-uniform dimension; the
        tensor (and mask) are cut to the largest sample.

        Without ``max_sample_size`` that size is read back from the device
        (one synchronisation); pass it to stay asynchronous.
        """
        tensor = _as_tensor(tensor)
        if non_uniform_dim is None:
            if sample_sizes is not None:
                non_uniform_dim = _as_tensor(sample_sizes).ndim
            elif mask is not None:
                non_uniform_dim = _as_tensor(mask).ndim - 1
            else:
                raise ValueError("Either `sample_sizes` or `mask` needs to be set")
        if non_uniform_dim < 0:
            non_uniform_dim = tensor.ndim + non_uniform_dim

        if mask is not None:
            mask = _as_tensor(mask, tensor.device).to(torch.bool)
        if sample_sizes is None:
            sample_sizes = mask.sum(dim=non_uniform_dim, dtype=SIZE_DTYPE)
        else:
            sample_sizes = _as_tensor(sample_sizes, tensor.device)

        if max_sample_size is None:
            max_sample_size = int(sample_sizes.max().item()) if sample_sizes.numel() else 0
        tensor = tensor.narrow(non_uniform_dim, 0, max_sample_size)
        if mask is not None:
            mask = mask.narrow(non_uniform_dim, 0, max_sample_size)
        return cls(tensor, mask, sample_sizes, non_uniform_dim)

    @classmethod
    def Empty(
        cls,
        num_dims: int,
        non_uniform_dim: int,
        device=None,
        num_batch_dims: Optional[int] = None,
        batch_shape: Optional[Union[Sequence[int], int]] = None,
        dtype=torch.float32,
    ) -> "RaggedBatch":
        """An instance of size 0 along all non-batch dims. ``device``
        defaults to the card (``device="cpu"`` for the CPU)."""
        assert (
            num_batch_dims is None or batch_shape is None
        ), "Either num_batch_dims or batch_shape can be provided, but not both"

        if num_batch_dims is None and batch_shape is None:
            num_batch_dims = 1
            batch_shape = (0,)
        elif batch_shape is not None:
            if isinstance(batch_shape, int):
                batch_shape = (batch_shape,)
            batch_shape = tuple(batch_shape)
            assert len(batch_shape) > 0, "Batch shape needs to be a non-empty sequence"
            num_batch_dims = len(batch_shape)
        else:
            assert num_batch_dims > 0, "Number of batch dimensions needs to be greater than 0"
            batch_shape = (0,) * num_batch_dims

        assert len(batch_shape) < num_dims
        assert num_batch_dims <= non_uniform_dim < num_dims

        dev = resolve_device(device)
        tensor_shape = batch_shape + (0,) * (num_dims - len(batch_shape))
        tensor = torch.zeros(tensor_shape, dtype=dtype, device=dev)
        mask = torch.zeros(batch_shape + (0,), dtype=torch.bool, device=dev)
        sizes = torch.zeros(batch_shape, dtype=SIZE_DTYPE, device=dev)
        return cls(tensor, mask, sizes, non_uniform_dim)

    @classmethod
    def FromFullTensor(
        cls, full_tensor, non_uniform_dim: int = 1, num_batch_dims: int = 1
    ) -> "RaggedBatch":
        """Create from a uniform-sized batch tensor (every entry valid)."""
        full_tensor = _as_tensor(full_tensor)
        batch_shape = tuple(full_tensor.shape[:num_batch_dims])
        assert num_batch_dims > 0
        if non_uniform_dim < 0:
            non_uniform_dim = full_tensor.ndim + non_uniform_dim
        assert num_batch_dims <= non_uniform_dim < full_tensor.ndim
        sample_size = full_tensor.shape[non_uniform_dim]
        dev = full_tensor.device
        mask = torch.ones((*batch_shape, sample_size), dtype=torch.bool, device=dev)
        sample_sizes = torch.full(batch_shape, sample_size, dtype=SIZE_DTYPE, device=dev)
        return cls(full_tensor, mask, sample_sizes, non_uniform_dim)

    # ------------------------------------------------------------------ #
    # Lazy derivation                                                    #
    # ------------------------------------------------------------------ #

    def _init_mask(self):
        sizes = self._sample_sizes
        max_size = self._tensor.shape[self._non_uniform_dim]
        iota = torch.arange(max_size, dtype=sizes.dtype, device=sizes.device)
        self._mask = iota < sizes[..., None]

    def _init_sample_sizes(self):
        self._sample_sizes = self._mask.sum(dim=self._num_batch_dims, dtype=SIZE_DTYPE)

    # ------------------------------------------------------------------ #
    # Properties                                                         #
    # ------------------------------------------------------------------ #

    @property
    def tensor(self) -> torch.Tensor:
        """The padded data tensor."""
        return self._tensor

    @property
    def mask(self) -> torch.Tensor:
        """Bool validity mask of shape ``(*batch_shape, max_sample_size)``."""
        if self._mask is None:
            self._init_mask()
        return self._mask

    @property
    def sample_sizes(self) -> torch.Tensor:
        """Per-sample valid counts of shape ``batch_shape``."""
        if self._sample_sizes is None:
            self._init_sample_sizes()
        return self._sample_sizes

    @property
    def non_uniform_dim(self) -> int:
        return self._non_uniform_dim

    @property
    def num_batch_dims(self) -> int:
        return self._num_batch_dims

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return self._batch_shape

    @property
    def total_num_samples_in_batch(self) -> int:
        return int(np.prod(self._batch_shape)) if len(self._batch_shape) else 1

    @property
    def total_num_entries(self) -> int:
        """Total number of valid entries (read back to the host)."""
        if self._total_num_targets is None:
            self._total_num_targets = int(self.sample_sizes.sum().item())
        return self._total_num_targets

    @property
    def max_sample_size(self) -> int:
        return self._tensor.shape[self._non_uniform_dim]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._tensor.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._tensor.dtype

    @property
    def device(self) -> torch.device:
        return self._tensor.device

    # ------------------------------------------------------------------ #
    # Derived-instance helpers                                           #
    # ------------------------------------------------------------------ #

    def as_self_with_cloned_data(self) -> "RaggedBatch":
        """Copy with cloned data, sharing mask and sizes."""
        return RaggedBatch(self._tensor.clone(), self.mask, self.sample_sizes,
                           self._non_uniform_dim)

    def create_with_sample_sizes_like_self(
        self,
        tensor,
        non_uniform_dim: Optional[int] = None,
        device=None,
    ) -> "RaggedBatch":
        """An instance with the same batch shape and sample sizes as ``self``."""
        tensor = _as_tensor(tensor)
        if non_uniform_dim is None:
            non_uniform_dim = self._non_uniform_dim
        elif non_uniform_dim < 0:
            non_uniform_dim = tensor.ndim + non_uniform_dim

        assert self._num_batch_dims <= non_uniform_dim < tensor.ndim, (
            f"Non-uniform dimension needs to be in [{self._num_batch_dims}; {tensor.ndim}["
        )
        assert tuple(tensor.shape[: self._num_batch_dims]) == self._batch_shape, (
            f"Batch shape mismatch: expected {self._batch_shape}, "
            f"got {tuple(tensor.shape[: self._num_batch_dims])}"
        )
        assert tensor.shape[non_uniform_dim] == self.shape[self._non_uniform_dim], (
            f"Non-uniform dim size mismatch: expected {self.shape[self._non_uniform_dim]}, "
            f"got {tensor.shape[non_uniform_dim]}"
        )
        if device is not None:
            tensor = tensor.to(device)
        res = RaggedBatch(tensor, self.mask, self.sample_sizes, non_uniform_dim)
        res._total_num_targets = self._total_num_targets
        return res

    def get_non_uniform_dimension_transposed_to(self, dim: int) -> "RaggedBatch":
        """The same batch with the non-uniform dimension moved to ``dim`` by
        swapping the two dimensions."""
        assert self._num_batch_dims <= dim < self._tensor.ndim
        if dim == self._non_uniform_dim:
            return self
        tensor_t = self._tensor.transpose(self._non_uniform_dim, dim)
        return self.create_with_sample_sizes_like_self(tensor_t, dim)

    # ------------------------------------------------------------------ #
    # Mask application                                                   #
    # ------------------------------------------------------------------ #

    def _mask_shaped_for_data(self) -> torch.Tensor:
        """Mask reshaped so its size-``max_sample_size`` axis sits at
        ``non_uniform_dim`` and all other non-batch axes are singleton."""
        nbd, nud = self._num_batch_dims, self._non_uniform_dim
        shape = list(self._batch_shape) + [1] * (self._tensor.ndim - nbd)
        shape[nud] = self._tensor.shape[nud]
        return self.mask.reshape(shape)

    def get_existence_weights(self, dtype=torch.float32) -> torch.Tensor:
        """1 for valid entries, 0 for fillers, broadcast to ``tensor.shape``."""
        return self._mask_shaped_for_data().expand(self._tensor.shape).to(dtype)

    def with_padded_set_to(self, value_to_set) -> "RaggedBatch":
        """A copy with the filler entries set to ``value_to_set`` (their
        gradient is zero)."""
        masked = self._tensor.masked_fill(~self._mask_shaped_for_data(), value_to_set)
        return self.create_with_sample_sizes_like_self(masked)

    def set_padded_to(self, value_to_set) -> None:
        """Set the filler entries to ``value_to_set`` by rebinding ``tensor``."""
        self._tensor = self.with_padded_set_to(value_to_set)._tensor

    # ------------------------------------------------------------------ #
    # Batch-dim transforms                                               #
    # ------------------------------------------------------------------ #

    def repeat_samples(
        self,
        num_repeats: Union[int, Sequence[int]],
        batch_dim: Optional[int] = None,
    ) -> "RaggedBatch":
        """Repeat (tile) along batch dimension(s)."""
        if isinstance(num_repeats, (int, np.integer)):
            if batch_dim is None:
                batch_dim = 0
            assert 0 <= batch_dim < self._num_batch_dims, (
                f"batch_dim must be in range [0, {self._num_batch_dims})"
            )
            tensor_reps = [1] * self._tensor.ndim
            tensor_reps[batch_dim] = int(num_repeats)
            mask_reps = [1] * (self._num_batch_dims + 1)
            mask_reps[batch_dim] = int(num_repeats)
            sizes_reps = [1] * self._num_batch_dims
            sizes_reps[batch_dim] = int(num_repeats)
        else:
            num_repeats = [int(r) for r in num_repeats]
            assert len(num_repeats) == self._num_batch_dims, (
                f"num_repeats must be a sequence of length {self._num_batch_dims}"
            )
            assert batch_dim is None, "batch_dim must be None if num_repeats is a sequence"
            tensor_reps = num_repeats + [1] * (self._tensor.ndim - self._num_batch_dims)
            mask_reps = num_repeats + [1]
            sizes_reps = num_repeats

        tensor = self._tensor.repeat(tensor_reps)
        mask = self._mask.repeat(mask_reps) if self._mask is not None else None
        sizes = (self._sample_sizes.repeat(sizes_reps)
                 if self._sample_sizes is not None else None)
        return RaggedBatch(tensor, mask, sizes, self._non_uniform_dim)

    def unsqueeze_batch_dim(self, dim: int) -> "RaggedBatch":
        """Add a batch dimension at ``dim``."""
        assert 0 <= dim <= self._num_batch_dims, f"dim must be in range [0, {self._num_batch_dims}]"
        tensor = self._tensor.unsqueeze(dim)
        mask = self._mask.unsqueeze(dim) if self._mask is not None else None
        sizes = self._sample_sizes.unsqueeze(dim) if self._sample_sizes is not None else None
        return RaggedBatch(tensor, mask, sizes, self._non_uniform_dim + 1)

    def squeeze_batch_dim(self, batch_dim: int) -> "RaggedBatch":
        """Remove a size-1 batch dimension."""
        assert 0 <= batch_dim < self._num_batch_dims
        if self._batch_shape[batch_dim] > 1:
            raise ValueError(
                f"Batch dimension {batch_dim} has size {self._batch_shape[batch_dim]} > 1. "
                "Cannot squeeze."
            )
        tensor = self._tensor.squeeze(batch_dim)
        mask = self._mask.squeeze(batch_dim) if self._mask is not None else None
        sizes = (self._sample_sizes.squeeze(batch_dim)
                 if self._sample_sizes is not None else None)
        return RaggedBatch(tensor, mask, sizes, self._non_uniform_dim - 1)

    def reshape_batch_dims(self, new_batch_shape: Union[int, Tuple[int, ...]]) -> "RaggedBatch":
        """Reshape the batch dimensions."""
        if isinstance(new_batch_shape, int):
            new_batch_shape = (new_batch_shape,)
        nbd = self._num_batch_dims
        tensor = self._tensor.reshape(*new_batch_shape, *self._tensor.shape[nbd:])
        mask = (
            self._mask.reshape(*new_batch_shape, *self._mask.shape[nbd:])
            if self._mask is not None
            else None
        )
        sizes = (
            self._sample_sizes.reshape(new_batch_shape) if self._sample_sizes is not None else None
        )
        new_nbd = tensor.ndim - (self._tensor.ndim - nbd)
        return RaggedBatch(tensor, mask, sizes, self._non_uniform_dim - nbd + new_nbd)

    def flatten_batch_dims(self) -> "RaggedBatch":
        """Flatten all batch dims into one."""
        return self.reshape_batch_dims(-1)

    def broadcast_batch_dims_to_shape(self, new_batch_shape: Sequence[int]) -> "RaggedBatch":
        new_batch_shape = tuple(int(s) for s in new_batch_shape)
        assert len(new_batch_shape) == self._num_batch_dims
        mult = []
        for cur, new in zip(self._batch_shape, new_batch_shape):
            assert cur != 0 and new % cur == 0, (
                f"Cannot broadcast batch dimensions of {self._batch_shape} to {new_batch_shape}."
            )
            mult.append(new // cur)
        return self.repeat_samples(mult)

    @staticmethod
    def broadcast_batch_dims(data: Sequence["RaggedBatch"]) -> List["RaggedBatch"]:
        """Broadcast several instances to a common batch shape."""
        nbds = {dt.num_batch_dims for dt in data}
        assert len(nbds) == 1, "Cannot broadcast as number of batch dimensions does not match."
        shapes = np.array([dt.batch_shape for dt in data])
        max_shape = shapes.max(axis=0)
        res = []
        for dt, shape in zip(data, shapes):
            assert np.all(shape > 0) and np.all(max_shape % shape == 0), (
                f"Cannot broadcast batch dimensions of {tuple(shape)} to {tuple(max_shape)}."
            )
            res.append(dt.repeat_samples(list(max_shape // shape)))
        return res

    # ------------------------------------------------------------------ #
    # Device / dtype                                                     #
    # ------------------------------------------------------------------ #

    def to_device(self, device) -> "RaggedBatch":
        tensor = self._tensor.to(device)
        mask = self._mask.to(device) if self._mask is not None else None
        sizes = self._sample_sizes.to(device) if self._sample_sizes is not None else None
        return RaggedBatch(tensor, mask, sizes, self._non_uniform_dim)

    def cpu(self) -> "RaggedBatch":
        return self.to_device("cpu")

    def to_dtype(self, dtype) -> "RaggedBatch":
        return self.create_with_sample_sizes_like_self(self._tensor.to(dtype))

    def astype(self, dtype) -> "RaggedBatch":
        return self.to_dtype(dtype)

    def detach(self) -> "RaggedBatch":
        return self.create_with_sample_sizes_like_self(self._tensor.detach())

    def int(self) -> "RaggedBatch":
        return self.to_dtype(torch.int32)

    def long(self) -> "RaggedBatch":
        return self.to_dtype(torch.int64)

    def bool(self) -> "RaggedBatch":
        return self.to_dtype(torch.bool)

    def half(self) -> "RaggedBatch":
        return self.to_dtype(torch.float16)

    def bfloat16(self) -> "RaggedBatch":
        return self.to_dtype(torch.bfloat16)

    def float(self) -> "RaggedBatch":
        return self.to_dtype(torch.float32)

    def double(self) -> "RaggedBatch":
        return self.to_dtype(torch.float64)

    def cfloat(self) -> "RaggedBatch":
        return self.to_dtype(torch.complex64)

    def cdouble(self) -> "RaggedBatch":
        return self.to_dtype(torch.complex128)

    def to(self, device=None, dtype=None) -> "RaggedBatch":
        res = self
        if dtype is not None:
            res = res.to_dtype(dtype)
        if device is not None:
            res = res.to_device(device)
        return res

    # ------------------------------------------------------------------ #
    # Functional application                                             #
    # ------------------------------------------------------------------ #

    def apply(self, proc_step: Callable) -> Union["RaggedBatch", Tuple["RaggedBatch", ...]]:
        """Apply a function to ``tensor`` (optionally with mask / sample_sizes).

        The function receives 1-3 positional args depending on its arity:
        ``(tensor)``, ``(tensor, mask)``, or ``(tensor, mask, sample_sizes)``.
        Outputs must keep the non-uniform dimension size and the
        valid-entries-first layout.
        """
        num_args = _callable_positional_arity(proc_step)
        if num_args == 1:
            args = (self._tensor,)
        elif num_args == 2:
            args = (self._tensor, self.mask)
        elif num_args == 3:
            args = (self._tensor, self.mask, self.sample_sizes)
        else:
            raise ValueError(
                f"Function {proc_step} has {num_args} arguments, but only 1, 2, or 3 are supported."
            )
        res_tensor = proc_step(*args)
        if isinstance(res_tensor, tuple):
            return tuple(
                RaggedBatch(rt, self.mask, self.sample_sizes, self._non_uniform_dim)
                for rt in res_tensor
            )
        return RaggedBatch(res_tensor, self.mask, self.sample_sizes, self._non_uniform_dim)

    def set_tensor(self, tensor) -> None:
        """Rebind the data tensor (shape-checked)."""
        tensor = _as_tensor(tensor)
        assert tuple(tensor.shape[: self._num_batch_dims]) == self._batch_shape, (
            f"Batch shape of data to set {tuple(tensor.shape[: self._num_batch_dims])} does not "
            f"match current batch shape {self._batch_shape}."
        )
        assert tensor.shape[self._non_uniform_dim] == self._tensor.shape[self._non_uniform_dim], (
            "Maximum sample size of data to set does not match current maximum sample size."
        )
        self._tensor = tensor

    def unsqueeze_data_dim(self, dim: int) -> "RaggedBatch":
        """Unsqueeze a data dimension (after the batch dimensions)."""
        if dim < 0:
            dim = self._tensor.ndim + 1 + dim
            assert 0 <= dim <= self._tensor.ndim, "Dimension outside the available range"
        assert dim >= self._num_batch_dims, "Can only add dimensions after the batch dimensions"
        tensor = self._tensor.unsqueeze(dim)
        nud = self._non_uniform_dim + 1 if dim <= self._non_uniform_dim else self._non_uniform_dim
        return self.create_with_sample_sizes_like_self(tensor, nud)

    def split(self) -> Union[List[torch.Tensor], List[list]]:
        """Split into per-sample tensors cut to their sizes (reads the sizes
        back to the host); nested lists for several batch dims."""
        need_transpose = self._non_uniform_dim != self._num_batch_dims
        if need_transpose:
            pre = self.get_non_uniform_dimension_transposed_to(self._num_batch_dims)
        else:
            pre = self
        tensor = pre.tensor
        sizes = pre.sample_sizes.cpu().numpy()
        orig_nud_unbatched = self._non_uniform_dim - self._num_batch_dims

        def _recurse(batch_idx, batch_dim):
            if batch_dim == self._num_batch_dims:
                size = int(sizes[batch_idx])
                sample = tensor[batch_idx][:size]
                if need_transpose:
                    sample = sample.transpose(0, orig_nud_unbatched)
                return sample
            return [
                _recurse(batch_idx + (i,), batch_dim + 1)
                for i in range(tensor.shape[batch_dim])
            ]

        return _recurse((), 0)

    # ------------------------------------------------------------------ #
    # Item access                                                        #
    # ------------------------------------------------------------------ #

    def __getitem__(self, item) -> torch.Tensor:
        return self._tensor[item]

    def __setitem__(self, item, value) -> None:
        """Item write that rebinds ``tensor`` to an updated copy."""
        tensor = self._tensor.clone()
        tensor[item] = value
        self._tensor = tensor

    def size(self, dim: Optional[int] = None):
        return tuple(self._tensor.shape) if dim is None else self._tensor.shape[dim]

    def dim(self) -> int:
        return self._tensor.ndim

    def __repr__(self) -> str:
        mask_str = "*uninitialized*" if self._mask is None else f"mask={self._mask}"
        sizes_str = (
            "*uninitialized*"
            if self._sample_sizes is None
            else f"sample_sizes={self._sample_sizes}"
        )
        return (
            f"RaggedBatch(tensor={self._tensor}, {mask_str}, {sizes_str}, "
            f"non_uniform_dim={self._non_uniform_dim}, batch_shape={self._batch_shape})"
        )


# ---------------------------------------------------------------------- #
# Pytree registration                                                    #
# ---------------------------------------------------------------------- #

SERIALIZED_TYPE_NAME = "accvlab_tpu_torch.ragged.RaggedBatch"


def _rb_flatten(rb: RaggedBatch):
    # mask and sample_sizes are materialized: every leaf is a tensor (a lazy
    # one would flatten to a None leaf, which a batch split cannot slice)
    return [rb.tensor, rb.mask, rb.sample_sizes], (rb._non_uniform_dim, rb._num_batch_dims)


def _rb_unflatten(children, aux) -> RaggedBatch:
    tensor, mask, sample_sizes = children
    non_uniform_dim, num_batch_dims = aux
    obj = object.__new__(RaggedBatch)
    obj._tensor = tensor
    obj._mask = mask
    obj._sample_sizes = sample_sizes
    obj._non_uniform_dim = non_uniform_dim
    obj._num_batch_dims = num_batch_dims
    shape = getattr(tensor, "shape", None)
    obj._batch_shape = tuple(shape[:num_batch_dims]) if shape is not None else ()
    obj._total_num_targets = None
    return obj


torch.utils._pytree.register_pytree_node(
    RaggedBatch,
    _rb_flatten,
    _rb_unflatten,
    serialized_type_name=SERIALIZED_TYPE_NAME,
    to_dumpable_context=list,
    from_dumpable_context=tuple,
)
