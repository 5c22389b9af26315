"""Data types for the pipeline framework.

Copy of ``accvlab_tpu/pipeline/dtypes.py`` (the port keeps its own): the
same vocabulary backed by numpy dtypes, plus the torch dtype of each, for
fields that live on the device as tensors.
"""

from __future__ import annotations

from enum import Enum

import numpy as np
import torch


class DType(Enum):
    """Field data types (parity with the DALIDataType subset the reference maps)."""

    BOOL = 0
    FLOAT = 1
    FLOAT16 = 2
    FLOAT64 = 3
    INT8 = 4
    INT16 = 5
    INT32 = 6
    INT64 = 7
    UINT8 = 8
    UINT16 = 9
    UINT32 = 10
    UINT64 = 11
    STRING = 12


_NUMPY_FOR_DTYPE = {
    DType.BOOL: np.bool_,
    DType.FLOAT: np.float32,
    DType.FLOAT16: np.float16,
    DType.FLOAT64: np.float64,
    DType.INT8: np.int8,
    DType.INT16: np.int16,
    DType.INT32: np.int32,
    DType.INT64: np.int64,
    DType.UINT8: np.uint8,
    DType.UINT16: np.uint16,
    DType.UINT32: np.uint32,
    DType.UINT64: np.uint64,
    # strings travel as uint8 byte tensors inside the pipeline
    DType.STRING: np.uint8,
}

_DTYPE_FOR_NUMPY = {
    np.dtype(v): k for k, v in _NUMPY_FOR_DTYPE.items() if k != DType.STRING
}


def numpy_dtype_for(dtype: DType):
    """numpy dtype used to store fields of ``dtype``."""
    return _NUMPY_FOR_DTYPE[dtype]


def dtype_for_numpy(np_dtype) -> DType:
    """DType corresponding to a numpy dtype."""
    return _DTYPE_FOR_NUMPY[np.dtype(np_dtype)]


_TORCH_FOR_NUMPY = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
}
_NUMPY_FOR_TORCH = {v: k for k, v in _TORCH_FOR_NUMPY.items()}


def torch_dtype_for(dtype: DType) -> torch.dtype:
    """torch dtype of device-resident fields of ``dtype``."""
    return _TORCH_FOR_NUMPY[np.dtype(_NUMPY_FOR_DTYPE[dtype])]


def torch_dtype_for_numpy(np_dtype) -> torch.dtype:
    return _TORCH_FOR_NUMPY[np.dtype(np_dtype)]


def numpy_dtype_for_torch(t_dtype: torch.dtype) -> np.dtype:
    return _NUMPY_FOR_TORCH[t_dtype]
