"""ctypes binding + lazy build of the wire-compression encoder
(``csrc/wirepack.cpp`` with ``csrc/simd_bitplane.h``, byte-identical copies
of the JAX package's), built into the port's own ``_build/`` directory.

There is no fallback: :func:`get_lib` raises when the library cannot build.
The numpy encoder in ``processing_steps/wire_compression.py`` is the plain
twin that the tests hold this one against.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from .._native_build import build_host_lib

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "wirepack.cpp")

#: bins of the zigzag-residual histograms (residuals fit 10 bits)
HIST_BINS = 1024


def library_path() -> str:
    """Build (if needed) and return the path of the wire encoder library."""
    return build_host_lib(SRC, "libaccvlab_wirepack", [])


def get_lib() -> ctypes.CDLL:
    """The wire encoder library, built on first use (raises if it cannot build)."""
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(library_path())
                lib.accvlab_wire_analyze.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_void_p,
                ]
                lib.accvlab_wire_analyze.restype = None
                lib.accvlab_wire_pack.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int64,
                ]
                lib.accvlab_wire_pack.restype = ctypes.c_int64
                _LIB = lib
    return _LIB


def _check_plane2d(plane2d: np.ndarray, group: int) -> None:
    """The C engine trusts its pointer: enforce the layout contract here."""
    if plane2d.dtype != np.uint8 or plane2d.ndim != 2:
        raise TypeError(
            f"native wire encoder needs a 2-D uint8 plane, got {plane2d.dtype} {plane2d.shape}"
        )
    if not plane2d.flags["C_CONTIGUOUS"]:
        raise ValueError("native wire encoder needs a C-contiguous plane")
    if plane2d.shape[1] % 8 != 0:
        raise ValueError(
            f"native wire encoder: row width {plane2d.shape[1]} must be divisible by 8"
        )
    if group < 1 or plane2d.shape[1] % group != 0:
        raise ValueError(
            f"native wire encoder: group {group} must divide the row width {plane2d.shape[1]}"
        )


def analyze(plane2d: np.ndarray, group: int):
    """Histograms (counts, ``HIST_BINS`` each) of both predictors' zigzag
    residuals: ``(hist_vertical, hist_plane)``.

    ``plane2d``: C-contiguous uint8 ``(H, Wr)``; ``group``: trailing elements
    per horizontal step.
    """
    _check_plane2d(plane2d, group)
    lib = get_lib()
    h1 = np.zeros((HIST_BINS,), np.uint32)
    h2 = np.zeros((HIST_BINS,), np.uint32)
    lib.accvlab_wire_analyze(plane2d.ctypes.data, plane2d.shape[0], plane2d.shape[1], group,
                             h1.ctypes.data, h2.ctypes.data)
    return h1, h2


def pack(plane2d: np.ndarray, group: int, mode: int, b: int, cap: int):
    """Bitplanes + exception list for the chosen ``(mode, b)``:
    ``(bp (b, H, Wr/8) uint8, excp (cap,) int32, excv (cap,) int16)``.
    Raises if the true exception count exceeds ``cap`` (the caller sized it
    from the histograms, so that is a bug, not bad data)."""
    _check_plane2d(plane2d, group)
    lib = get_lib()
    h, wr = plane2d.shape
    bp = np.empty((b, h, wr // 8), np.uint8)
    excp = np.full((cap,), h * wr, np.int32)
    excv = np.zeros((cap,), np.int16)
    ne = lib.accvlab_wire_pack(plane2d.ctypes.data, h, wr, group, mode, b, bp.ctypes.data,
                               excp.ctypes.data, excv.ctypes.data, cap)
    if ne > cap:
        raise RuntimeError(f"wire pack: {ne} exceptions exceed the sized capacity {cap}")
    return bp, excp, excv
