"""Debug helpers for processing steps.

PyTorch port of ``accvlab_tpu/pipeline/internal_helpers.py``. The JAX
package prints through ``jax.debug.print`` inside its fused device program;
the port's device steps run eagerly, so the printers print directly (a
tensor on the card is read back to do so: a synchronisation, as a debug
print is). Every helper takes torch tensors and numpy arrays alike and
returns its input unchanged.
"""

from __future__ import annotations

from typing import Any, Sequence, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .dtypes import numpy_dtype_for_torch


def _numpy_dtype(value) -> np.dtype:
    if isinstance(value, torch.Tensor):
        return numpy_dtype_for_torch(value.dtype)
    return np.dtype(value.dtype)


def check_type(input, expected_type_np, identifier: str):
    """Raise ``TypeError`` unless the array's dtype is ``expected_type_np``
    (a numpy dtype; a tensor's is its numpy counterpart); returns the input
    unchanged. A check of metadata only: nothing is read from the device."""
    actual = _numpy_dtype(input)
    expected = np.dtype(expected_type_np)
    if actual != expected:
        raise TypeError(
            f"check_type('{identifier}'): expected dtype {expected}, got {actual}"
        )
    return input


def _as_numpy(tensor) -> np.ndarray:
    if isinstance(tensor, torch.Tensor):
        return tensor.detach().cpu().numpy()
    return np.asarray(tensor)


def print_tensor_op(tensor, name: str):
    """Print ``name: <values>`` (numpy's formatting, as ``jax.debug.print``
    prints) and return the tensor."""
    print(f"{name}: {_as_numpy(tensor)}")
    return tensor


def print_tensor_size_op(tensor, name: str):
    """Print the tensor's shape and numpy dtype and return the tensor."""
    print(f"{name}: shape={tuple(tensor.shape)} dtype={_numpy_dtype(tensor)}")
    return tensor


def get_as_data_node(value, device: DeviceLike = None) -> torch.Tensor:
    """A constant as a tensor on ``device`` (default the card; a tensor
    stays on its device)."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value), device=resolve_device(device))


def get_mapped(val: Union[Sequence, Any], mapping: dict, encapsulate: bool = False):
    """Map value(s) through a dict; optionally wrap a scalar into a list."""
    if isinstance(val, (list, tuple)):
        return [mapping[v] for v in val]
    res = mapping[val]
    return [res] if encapsulate else res
