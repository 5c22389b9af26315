"""ctypes binding + lazy build of the native JPEG decoder (port of
``accvlab_tpu/pipeline/native_jpeg.py``).

``csrc/jpegdec.cpp`` is a byte-identical copy of the JAX package's. It is
compiled against the libjpeg headers copied beside it (libjpeg-turbo 2.1.5,
``JPEG_LIB_VERSION 62``) and linked with the system's ``libjpeg.so.62`` or,
on a host without one, the libjpeg-turbo that Pillow's wheel carries
(:func:`accvlab_tpu_torch._native_build.libjpeg_link`). The build goes to
the port's own ``_build/`` directory.

:func:`available` says whether the library built; :func:`build_error`
keeps the reason when it did not. Every decoding function raises
``RuntimeError`` then: nothing here falls back to another decoder.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from .._native_build import build_host_lib, libjpeg_link

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SRC = os.path.join(CSRC, "jpegdec.cpp")

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_ERROR: Optional[str] = None
#: the libjpeg the library was linked with (``libjpeg_link()``'s dict), once built
LINKED: Optional[dict] = None

_U8P = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> str:
    """Build (if needed) and return the path of the decoder library; records
    the libjpeg it linked in :data:`LINKED`. Raises when it cannot build."""
    global LINKED
    link = libjpeg_link()
    path = build_host_lib(SRC, "libaccvlab_jpeg", link["link_args"], [f"-I{CSRC}"])
    LINKED = {k: v for k, v in link.items() if k != "link_args"}
    return path


def _build_and_load() -> ctypes.CDLL:
    lib = ctypes.CDLL(library_path())
    lib.ajd_last_error.restype = ctypes.c_char_p
    lib.ajd_probe.restype = ctypes.c_int
    lib.ajd_probe.argtypes = [
        _U8P, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.ajd_decode_yuv420.restype = ctypes.c_int
    lib.ajd_decode_yuv420.argtypes = [
        _U8P, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32, _U8P, _U8P,
    ]
    lib.ajd_decode_rgb.restype = ctypes.c_int
    lib.ajd_decode_rgb.argtypes = [
        _U8P, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _U8P,
    ]
    lib.ajd_dct_info.restype = ctypes.c_int
    lib.ajd_dct_info.argtypes = [_U8P, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32)]
    lib.ajd_read_dct.restype = ctypes.c_int
    lib.ajd_read_dct.argtypes = [
        _U8P, ctypes.c_uint64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint16),
    ]
    return lib


def _try_load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_ERROR
    if _LIB is None and _LIB_ERROR is None:
        with _LIB_LOCK:
            if _LIB is None and _LIB_ERROR is None:
                try:
                    _LIB = _build_and_load()
                except (RuntimeError, OSError) as e:  # no libjpeg, or no compiler
                    _LIB_ERROR = str(e)
    return _LIB


def available() -> bool:
    """Whether the decoder library built (it is built on the first call)."""
    return _try_load() is not None


def build_error() -> Optional[str]:
    """Why the library did not build, or None."""
    _try_load()
    return _LIB_ERROR


def get_lib() -> ctypes.CDLL:
    """The decoder library; raises ``RuntimeError`` with the build error
    when it did not build."""
    lib = _try_load()
    if lib is None:
        raise RuntimeError(f"the native JPEG decoder is not available: {_LIB_ERROR}")
    return lib


def _buf(jpeg_bytes) -> np.ndarray:
    return np.ascontiguousarray(jpeg_bytes, np.uint8)


def _ptr(a: np.ndarray, ctype=ctypes.c_uint8):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise ValueError(f"{what} failed: {lib.ajd_last_error().decode()}")


def probe(jpeg_bytes: np.ndarray) -> Tuple[int, int]:
    """Source (height, width) from the header, without decoding."""
    lib = get_lib()
    buf = _buf(jpeg_bytes)
    h, w = ctypes.c_int32(), ctypes.c_int32()
    _check(lib, lib.ajd_probe(_ptr(buf), buf.nbytes, ctypes.byref(h), ctypes.byref(w)),
           "JPEG probe")
    return h.value, w.value


def decode_yuv420(jpeg_bytes: np.ndarray,
                  target_hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Decode straight to the wire layout at ``target_hw`` (even sizes):
    ``(y (H, W) uint8, cbcr (H/2, W/2, 2) uint8)``. The decode runs at the
    best M/8 DCT scale covering the target and chroma is resampled at half
    the target resolution."""
    lib = get_lib()
    th, tw = int(target_hw[0]), int(target_hw[1])
    buf = _buf(jpeg_bytes)
    y = np.empty((th, tw), np.uint8)
    cbcr = np.empty((th // 2, tw // 2, 2), np.uint8)
    _check(lib, lib.ajd_decode_yuv420(_ptr(buf), buf.nbytes, th, tw, _ptr(y), _ptr(cbcr)),
           "JPEG decode")
    return y, cbcr


def decode_rgb(jpeg_bytes: np.ndarray, target_hw: Tuple[int, int],
               as_bgr: bool = False) -> np.ndarray:
    """Decode to interleaved uint8 RGB (BGR) at exactly ``target_hw``, at the
    same M/8 DCT scale as :func:`decode_yuv420`. Grayscale sources are
    expanded by libjpeg; CMYK raises ``ValueError``."""
    lib = get_lib()
    th, tw = int(target_hw[0]), int(target_hw[1])
    buf = _buf(jpeg_bytes)
    out = np.empty((th, tw, 3), np.uint8)
    _check(lib, lib.ajd_decode_rgb(_ptr(buf), buf.nbytes, th, tw, int(as_bgr), _ptr(out)),
           "JPEG decode")
    return out


def dct_info(jpeg_bytes: np.ndarray) -> dict:
    """Header-only probe for the coefficient-domain read:
    ``{"src_hw", "ncomp", "blocks_y", "blocks_c", "progressive"}``, the block
    grids being libjpeg's ``{height,width}_in_blocks`` (the 4:2:0 chroma
    grid, made up for grayscale sources). Raises ``ValueError`` for anything
    but grayscale or YCbCr 4:2:0."""
    lib = get_lib()
    buf = _buf(jpeg_bytes)
    info = np.zeros(8, np.int32)
    _check(lib, lib.ajd_dct_info(_ptr(buf), buf.nbytes, _ptr(info, ctypes.c_int32)),
           "DCT probe")
    return {
        "src_hw": (int(info[0]), int(info[1])),
        "ncomp": int(info[2]),
        "blocks_y": (int(info[3]), int(info[4])),
        "blocks_c": (int(info[5]), int(info[6])),
        "progressive": bool(info[7]),
    }


def read_dct(jpeg_bytes: np.ndarray, m: int, info: Optional[dict] = None):
    """Entropy-decode only: the ``m x m`` top-left (natural order) quantized
    coefficients of every block, the subset libjpeg's own M/8 scaled decode
    uses, and the quantization tables. Returns ``(y, cb, cr, quant)``: int16
    ``(bh_y, bw_y, m, m)``, two int16 ``(bh_c, bw_c, m, m)`` (zeros for
    grayscale) and uint16 ``(2, m, m)`` (luma, chroma tables)."""
    lib = get_lib()
    if info is None:
        info = dct_info(jpeg_bytes)
    m = int(m)
    bh_y, bw_y = info["blocks_y"]
    bh_c, bw_c = info["blocks_c"]
    buf = _buf(jpeg_bytes)
    y = np.zeros((bh_y, bw_y, m, m), np.int16)
    cb = np.zeros((bh_c, bw_c, m, m), np.int16)
    cr = np.zeros((bh_c, bw_c, m, m), np.int16)
    quant = np.zeros((2, m, m), np.uint16)
    i16 = ctypes.c_int16
    _check(lib, lib.ajd_read_dct(_ptr(buf), buf.nbytes, m, bh_y, bw_y, bh_c, bw_c,
                                 _ptr(y, i16), _ptr(cb, i16), _ptr(cr, i16),
                                 _ptr(quant, ctypes.c_uint16)), "DCT read")
    return y, cb, cr, quant


def select_scale_m(source_hw: Tuple[int, int], target_hw: Tuple[int, int]) -> int:
    """The smallest M in 1..8 whose ceil(dim * M / 8) covers ``target_hw`` on
    both axes (``jpegdec.cpp``'s ``select_scale``)."""
    sh, sw = int(source_hw[0]), int(source_hw[1])
    th, tw = int(target_hw[0]), int(target_hw[1])
    for m in range(1, 9):
        if (sh * m + 7) // 8 >= th and (sw * m + 7) // 8 >= tw:
            return m
    return 8


def scaled_size(source_hw: Tuple[int, int], hint_hw: Tuple[int, int]) -> Tuple[int, int]:
    """The size libjpeg's best M/8 DCT scale gives for a scale-hint decode."""
    sh, sw = int(source_hw[0]), int(source_hw[1])
    m = select_scale_m(source_hw, hint_hw)
    return (sh * m + 7) // 8, (sw * m + 7) // 8
