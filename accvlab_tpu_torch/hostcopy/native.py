"""ctypes binding + lazy build of the C++ packing engine (``csrc/pack.cpp``,
a byte-identical copy of the JAX package's), built into the port's own
``_build/`` directory."""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional

import numpy as np

from .._native_build import build_host_lib

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "pack.cpp")


def library_path() -> str:
    """Build (if needed) and return the path of the packing library."""
    return build_host_lib(SRC, "libaccvlab_pack", ["-lpthread"])


def get_lib() -> ctypes.CDLL:
    """The packing library, built on first use (raises if it cannot build)."""
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(library_path())
                lib.accvlab_pack_init.argtypes = [ctypes.c_int]
                lib.accvlab_pack.argtypes = [
                    ctypes.POINTER(ctypes.c_void_p),
                    ctypes.POINTER(ctypes.c_uint64),
                    ctypes.POINTER(ctypes.c_uint64),
                    ctypes.c_int64,
                    ctypes.c_void_p,
                ]
                lib.accvlab_pack_init(int(os.environ.get("ACCVLAB_PACK_THREADS", "4")))
                _LIB = lib
    return _LIB


def parallel_pack(arrays: List[np.ndarray], offsets: List[int], dst_ptr: int) -> None:
    """Copy C-contiguous ``arrays`` to ``dst_ptr + offsets[i]`` (parallel C++
    scatter-memcpy, GIL released)."""
    n = len(arrays)
    if n == 0:
        return
    srcs = (ctypes.c_void_p * n)(*[arr.ctypes.data for arr in arrays])
    sizes = (ctypes.c_uint64 * n)(*[arr.nbytes for arr in arrays])
    offs = (ctypes.c_uint64 * n)(*offsets)
    get_lib().accvlab_pack(
        ctypes.cast(srcs, ctypes.POINTER(ctypes.c_void_p)),
        ctypes.cast(sizes, ctypes.POINTER(ctypes.c_uint64)),
        ctypes.cast(offs, ctypes.POINTER(ctypes.c_uint64)),
        n,
        ctypes.c_void_p(dst_ptr),
    )
