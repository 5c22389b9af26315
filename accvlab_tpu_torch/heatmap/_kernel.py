"""ctypes binding of the CUDA rasterizer ``csrc/draw_heatmap.cu``.

The library is built with ``nvcc`` at first use (``_native_build``) and never
when this module is imported, so the CPU tests import it freely. The kernel
takes the raw per-target inputs and prepares the targets itself; each entry
point that launches it counts its launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .._native_build import build_cuda_lib

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "draw_heatmap.cu")
# -fmad=false pins the exact exp against multiply-add contraction (the
# source also spells every rounding out with __fmul_rn/__fadd_rn/__fsub_rn)
NVCC_EXTRA = ["-fmad=false"]

#: the tile of one block: threads along x (each draws 4 neighbouring pixels
#: of a row), threads along y, and rows per thread (1, 2 or 4), i.e. 4 *
#: TILE[0] columns by TILE[1] * TILE[2] rows. Chosen on the card with
#: scripts/torch_raster_tiles.py (PERF.md), as are the two below.
TILE: Tuple[int, int, int] = (8, 16, 2)
#: more targets per sample than TILE's 128 threads cull at once: 256 per chunk
TILE_MANY_TARGETS: Tuple[int, int, int] = (16, 16, 2)
#: TILE would give fewer than two blocks per SM: smaller tiles fill the card
TILE_SMALL_GRID: Tuple[int, int, int] = (8, 8, 1)
#: most classes the peak table of draw_gaussians holds (passed by value)
MAX_CLASSES = 256

#: kernel launches per entry point (wrapper name -> count); "bare" counts the
#: launches made through :func:`launch_draw` / :func:`launch_gaussians`
#: directly, outside every entry point
LAUNCHES = {
    "draw_heatmap_batched": 0,
    "draw_heatmap_batched_classwise": 0,
    "draw_heatmap": 0,
    "draw_gaussians": 0,
    "bare": 0,
}

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library_path() -> str:
    """Build (if needed) and return the path of the kernel library."""
    return build_cuda_lib(SRC, "libaccvlab_draw_heatmap", NVCC_EXTRA)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(library_path())
                lib.accvlab_draw_heatmap.restype = _I
                lib.accvlab_draw_heatmap.argtypes = (
                    [_P] * 6 + [_I] * 5 + [_F, _F] + [_I] * 5 + [_P]
                )
                lib.accvlab_draw_gaussians.restype = _I
                lib.accvlab_draw_gaussians.argtypes = (
                    [_P] * 7 + [_I] * 5 + [_F] + [_I] * 4 + [_P]
                )
                _LIB = lib
    return _LIB


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else _P(t.data_ptr())


def choose_tile(maps: int, height: int, width: int, targets: int,
                sms: int) -> Tuple[int, int, int]:
    """The tile for ``maps`` maps of ``height x width`` with ``targets``
    targets per sample on a card with ``sms`` SMs. Every block culls all
    targets of its sample, so many targets call for wide blocks; a small grid
    for smaller tiles."""
    if targets > TILE[0] * TILE[1]:
        return TILE_MANY_TARGETS
    cols, rows = 4 * TILE[0], TILE[1] * TILE[2]
    blocks = maps * -(-height // rows) * -(-width // cols)
    return TILE_SMALL_GRID if blocks < 2 * sms else TILE


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(hm_in: torch.Tensor, targets: int, tensors, tile) -> Tuple[int, int, int]:
    """Checks type, shape, contiguity and device of every input against the
    ``(B, C, H, W)`` float32 map and ``targets`` targets per sample, and the
    tile; raises ``ValueError``, and for a map that does not lie on the card,
    too. Returns ``tile``, or :func:`choose_tile`'s when it is None."""
    if hm_in.dtype != torch.float32 or hm_in.ndim != 4:
        raise ValueError(
            f"heatmap must be a float32 (B, C, H, W) tensor, got {hm_in.dtype} "
            f"{tuple(hm_in.shape)}"
        )
    for name, x, dtypes, shape in tensors:
        if x is None:
            continue
        if x.dtype not in dtypes or tuple(x.shape) != shape or not x.is_contiguous() \
                or x.device != hm_in.device:
            raise ValueError(
                f"{name}: expected a contiguous {'/'.join(map(str, dtypes))} tensor of shape "
                f"{shape} on {hm_in.device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    if tile is not None:
        tile = tuple(tile)
        if len(tile) != 3 or min(tile) < 1 or tile[0] * tile[1] > 256 \
                or tile[0] * tile[1] % 32 or tile[2] not in (1, 2, 4):
            raise ValueError(f"tile {tile}: threads x * y must be a multiple of 32, at most "
                             "256, and rows 1, 2 or 4")
    if not hm_in.is_cuda:
        raise ValueError("the CUDA rasterizer takes CUDA tensors only")
    if tile is None:
        b, c, h, w = hm_in.shape
        tile = choose_tile(b * c, h, w, targets, _sm_count(hm_in.device))
    return tile


def _run(entry: str, hm_in: torch.Tensor, fn, args) -> torch.Tensor:
    out = torch.empty_like(hm_in)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(hm_in.device).cuda_stream
    with torch.cuda.device(hm_in.device):
        err = fn(_ptr(hm_in), _ptr(out), *args, _P(stream))
    if err != 0:
        raise RuntimeError(f"draw_heatmap kernel launch failed: CUDA error {err}")
    LAUNCHES[entry] += 1
    return out


def launch_draw(
    entry: str,
    hm_in: torch.Tensor,
    centers: torch.Tensor,
    radii: torch.Tensor,
    num_valid: Optional[torch.Tensor],
    sel: Optional[torch.Tensor],
    factor: float,
    k_scale: float,
    exact: bool,
    log_domain: bool,
    tile: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """The ``draw.py`` form on CUDA tensors; returns the new ``(B, C, H, W)``
    map. A successful launch adds one to ``LAUNCHES[entry]``; an empty map
    launches nothing and counts nothing.

    ``hm_in`` (B, C, H, W) float32; ``centers`` (B, T, 2) int32 (x, y);
    ``radii`` (B, T) int32; ``num_valid`` (B,) int32 valid targets per sample,
    or None (all valid); ``sel`` (B, T) int32 class per target, or None.
    """
    b, c, h, w = hm_in.shape if hm_in.ndim == 4 else (0, 0, 0, 0)
    t = centers.shape[1] if centers.ndim == 3 else -1
    i32 = (torch.int32,)
    tile = _check(hm_in, t, (("centers", centers, i32, (b, t, 2)), ("radii", radii, i32, (b, t)),
                             ("num_valid", num_valid, i32, (b,)), ("sel", sel, i32, (b, t))), tile)
    hm_in = hm_in.contiguous()
    args = (_ptr(centers), _ptr(radii), _ptr(num_valid), _ptr(sel), b, c, h, w, t,
            float(factor), float(k_scale), int(exact), int(log_domain), *tile)
    return _run(entry, hm_in, _lib().accvlab_draw_heatmap, args)


def peak_table(k_for_classes: Sequence[float], num_classes: int) -> np.ndarray:
    """The first ``num_classes`` peaks as a float32 host array, which the
    launch passes by value (no copy to the card). Raises ``ValueError`` when
    there are fewer peaks than classes or more than :data:`MAX_CLASSES` classes."""
    k = np.ascontiguousarray(np.asarray(k_for_classes, np.float32).reshape(-1))
    if num_classes > MAX_CLASSES:
        raise ValueError(
            f"the CUDA rasterizer takes at most {MAX_CLASSES} classes, got {num_classes}"
        )
    if k.size < num_classes:
        raise ValueError(f"k_for_classes has {k.size} entries for {num_classes} classes")
    return k[:num_classes].copy()


def launch_gaussians(
    entry: str,
    hm_in: torch.Tensor,
    active: torch.Tensor,
    ids: torch.Tensor,
    centers: torch.Tensor,
    radii: torch.Tensor,
    k_for_classes: Sequence[float],
    factor: float,
    exact: bool,
    tile: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """The ``draw_gaussians`` form on CUDA tensors; counts as
    :func:`launch_draw`.

    ``active`` (B, T) bool; ``ids`` (B, T) int32 (clamped into [0, C-1] by
    the kernel); ``centers`` (B, T, 2) int32; ``radii`` (B, T) float32;
    ``k_for_classes`` per-class peaks on the host (see :func:`peak_table`).
    """
    b, c, h, w = hm_in.shape if hm_in.ndim == 4 else (0, 0, 0, 0)
    t = centers.shape[1] if centers.ndim == 3 else -1
    i32 = (torch.int32,)
    tile = _check(hm_in, t, (("active", active, (torch.bool,), (b, t)), ("ids", ids, i32, (b, t)),
                             ("centers", centers, i32, (b, t, 2)),
                             ("radii", radii, (torch.float32,), (b, t))), tile)
    peaks = peak_table(k_for_classes, c)
    hm_in = hm_in.contiguous()
    args = (_ptr(active), _ptr(ids), _ptr(centers), _ptr(radii),
            peaks.ctypes.data_as(_P), b, c, h, w, t, float(factor), int(exact), *tile)
    return _run(entry, hm_in, _lib().accvlab_draw_gaussians, args)
