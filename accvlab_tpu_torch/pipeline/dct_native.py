"""ctypes binding + lazy build of the native DCT-wire band encoder (port of
``accvlab_tpu/pipeline/dct_native.py``).

``csrc/dctpack.cpp`` (with ``csrc/simd_bitplane.h``) is a byte-identical
copy of the JAX package's source. It needs no libjpeg: it is built with g++
into the port's own ``_build/`` directory on first use.

There is no fallback: :func:`get_lib` raises ``RuntimeError`` with the
compiler's error when the library cannot build, where the JAX module warns
and switches to numpy. The numpy backend of
``processing_steps/dct_wire._CompsetEncoder`` is the plain twin the tests
hold this engine against; they reach it by patching :func:`get_lib` to
return ``None``, the only way :func:`analyze` and :func:`pack_group`
return ``None``.
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

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "dctpack.cpp")


def library_path() -> str:
    """Build (if needed) and return the path of the band encoder library."""
    return build_host_lib(SRC, "libaccvlab_dctpack", [])


def _build_and_load() -> ctypes.CDLL:
    lib = ctypes.CDLL(library_path())
    lib.accvlab_dct_analyze.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.accvlab_dct_analyze.restype = None
    lib.accvlab_dct_dc_analyze.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.accvlab_dct_dc_analyze.restype = None
    lib.accvlab_dct_pack_group.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.accvlab_dct_pack_group.restype = ctypes.c_int64
    return lib


def get_lib() -> ctypes.CDLL:
    """The band encoder library, built on first use. Raises ``RuntimeError``
    naming the compiler's error when it cannot build."""
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                try:
                    _LIB = _build_and_load()
                except (RuntimeError, OSError) as e:
                    raise RuntimeError(f"the native DCT band encoder did not build: {e}") from e
    return _LIB


def _check_bands(bands: np.ndarray) -> None:
    if bands.dtype != np.int16 or bands.ndim != 3:
        raise TypeError(
            f"native DCT encoder needs 3-D int16 bands, got {bands.dtype} {bands.shape}"
        )
    if not bands.flags["C_CONTIGUOUS"]:
        raise ValueError("native DCT encoder needs C-contiguous bands")
    if bands.shape[2] % 8 != 0:
        raise ValueError(
            f"native DCT encoder: row width {bands.shape[2]} must be divisible by 8"
        )


def analyze(bands: np.ndarray, bounds) -> Optional[tuple]:
    """Per-group width summaries ("fits" tables) in one sweep.

    ``bands``: C-contiguous int16 ``(nb, bh, bwp)``; ``bounds``: the
    ``ngroups+1`` band partition (group 0 must be the DC band alone).
    Returns ``(fits, dc3)``: uint32 ``(ngroups, 15)`` with row 0 zero and
    uint32 ``(3, 15)`` for the DC predictor variants, where
    ``fits[g][b] = count(zigzag < 2**b)``; ``None`` only when :func:`get_lib`
    is patched to return ``None``.
    """
    lib = get_lib()
    if lib is None:
        return None
    _check_bands(bands)
    bounds = np.ascontiguousarray(bounds, np.int64)
    ngroups = bounds.size - 1
    if bounds[0] != 0 or bounds[1] != 1 or bounds[-1] != bands.shape[0]:
        raise ValueError(
            "native DCT encoder: bounds must start (0, 1, ...) — group 0 is the DC band "
            "alone — and cover all bands"
        )
    fits = np.zeros((ngroups, 15), np.uint32)
    dc3 = np.zeros((3, 15), np.uint32)
    lib.accvlab_dct_analyze(bands.ctypes.data, bands.shape[1], bands.shape[2],
                            bounds.ctypes.data, ngroups, fits.ctypes.data)
    lib.accvlab_dct_dc_analyze(bands.ctypes.data, bands.shape[1], bands.shape[2],
                               dc3.ctypes.data)
    return fits, dc3


def pack_group(bands: np.ndarray, start: int, end: int, dc_mode: int, b: int, bp: np.ndarray,
               excp: np.ndarray, excv: np.ndarray, ne: int) -> Optional[int]:
    """Pack bands ``[start:end)`` at width ``b`` into ``bp`` and append
    exceptions (positions globally offset) to the unified list at ``ne``.

    ``dc_mode``: the DC predictor if ``start == 0``, else ignored. Returns
    the new true exception count (the caller raises if it exceeds the
    list's capacity); ``None`` only when :func:`get_lib` is patched to
    return ``None``.
    """
    lib = get_lib()
    if lib is None:
        return None
    _check_bands(bands)
    nb = end - start
    bh, bwp = bands.shape[1], bands.shape[2]
    if bp.shape != (b, nb * bh, bwp // 8) or bp.dtype != np.uint8:
        raise ValueError(f"native DCT encoder: bitplanes {bp.dtype} {bp.shape}, expected uint8 "
                         f"{(b, nb * bh, bwp // 8)}")
    if excp.dtype != np.int32 or excv.dtype != np.int16 or excv.size < excp.size:
        raise ValueError("native DCT encoder: exceptions need int32 positions and at least as "
                         "many int16 values")
    new_ne = lib.accvlab_dct_pack_group(
        bands.ctypes.data + start * bh * bwp * 2, nb, bh, bwp,
        dc_mode if start == 0 else -1, b, bp.ctypes.data,
        excp.ctypes.data, excv.ctypes.data, excp.size,
        start * bh * bwp, ne,
    )
    return int(new_ne)
