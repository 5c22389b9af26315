"""ctypes binding of the CUDA rasterizer ``csrc/draw_heatmap.cu``.

The library is built with ``nvcc`` at first use (``_native_build``) and never
when this module is imported, so the CPU tests import it freely. Each entry
point that launches the kernel counts its launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from .._native_build import build_cuda_lib

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "draw_heatmap.cu")
# -fmad=false pins the exact exp against multiply-add contraction (the
# source also spells every rounding out with __fmul_rn/__fadd_rn/__fsub_rn)
NVCC_EXTRA = ["-fmad=false"]

#: kernel launches per entry point (wrapper name -> count); "bare" counts the
#: launches made through :func:`launch` directly, outside every entry point
LAUNCHES = {
    "draw_heatmap_batched": 0,
    "draw_heatmap_batched_classwise": 0,
    "draw_heatmap": 0,
    "draw_gaussians": 0,
    "bare": 0,
}

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


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
                fn = lib.accvlab_draw_heatmap
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
                    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ]
                _LIB = lib
    return _LIB


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def launch(
    entry: str,
    hm_in: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    rr: torch.Tensor,
    iv: torch.Tensor,
    sel: Optional[torch.Tensor],
    kt: Optional[torch.Tensor],
    k_scale: float,
    exact: bool,
    log_domain: bool,
) -> torch.Tensor:
    """Run the rasterizer on CUDA tensors; returns the new ``(B, C, H, W)`` map.
    A successful launch adds one to ``LAUNCHES[entry]``; an empty map
    launches nothing and counts nothing.

    ``hm_in`` (B, C, H, W) float32; ``xs, ys, rr, iv`` (B, T) float32;
    ``sel`` (B, T) int32 or None; ``kt`` (B, T) float32 or None.
    """
    if not hm_in.is_cuda:
        raise ValueError("the CUDA rasterizer takes CUDA tensors only")
    b, c, h, w = hm_in.shape
    t = xs.shape[1]
    for name, x, dt in (("xs", xs, torch.float32), ("ys", ys, torch.float32),
                        ("rr", rr, torch.float32), ("iv", iv, torch.float32),
                        ("sel", sel, torch.int32), ("kt", kt, torch.float32)):
        if x is None:
            continue
        if x.dtype != dt or tuple(x.shape) != (b, t) or not x.is_contiguous() \
                or x.device != hm_in.device:
            raise ValueError(
                f"{name}: expected a contiguous {dt} tensor of shape {(b, t)} on "
                f"{hm_in.device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    if hm_in.dtype != torch.float32:
        raise ValueError(f"heatmap must be float32, got {hm_in.dtype}")
    hm_in = hm_in.contiguous()
    out = torch.empty_like(hm_in)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(hm_in.device).cuda_stream
    with torch.cuda.device(hm_in.device):
        err = _lib().accvlab_draw_heatmap(
            _ptr(hm_in), _ptr(out), _ptr(xs), _ptr(ys), _ptr(rr), _ptr(iv),
            _ptr(sel), _ptr(kt), b, c, h, w, t, float(k_scale), int(exact),
            int(log_domain), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"draw_heatmap kernel launch failed: CUDA error {err}")
    LAUNCHES[entry] += 1
    return out
