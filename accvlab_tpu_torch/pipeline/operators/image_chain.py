"""The device stage's image chain as one operator,
``accvlab_tpu_torch::image_chain``: ``AffineTransformer``'s warp, then
``PhotoMetricDistorter``'s distortion, then ``ImageMeanStdDevNormalizer``'s
normalization, from a ``(B, H, W, 3)`` uint8 field to its ``(B, oh, ow,
3)`` float32 images.

* CUDA: the hand kernel ``csrc/image_chain.cu`` (built with ``nvcc`` at
  first use, bound through ``ctypes``), one launch per field; each launch
  adds one to ``LAUNCHES["image_chain"]``, and a failed build or launch
  raises;
* CPU: the plain version, :func:`image_chain_plain`: the steps' own pixel
  code (``warp_affine``, ``photo_metric_distorter.distort``,
  ``image_normalizers.mean_std_normalize``) on the same parameters;
* fake (tracing): a new float32 tensor of the output's shape, so
  ``shared_jit``'s trace, its CUDA graph and ``torch.export`` take the
  operator as they take ``draw_gaussians``.

The executor decides where the chain goes through the operator
(:mod:`..image_chain`); the steps compute the parameters, which
:func:`pack_params` lays out as ``(B, PARAMS)`` float32:

* ``[0:6]`` the map from output to source pixels, row by row;
* ``[6:12]`` the gates (1 or 0): brightness, contrast before, saturation,
  hue, contrast after, channel swap;
* ``[12:15]`` the brightness delta on the [0, 1] scale, the contrast factor,
  the saturation factor;
* ``[15:24]`` the hue matrix, row by row; ``[24:27]`` the permutation.

The step constants go by value (:func:`chain_consts`): float32(1/255), the
luma weights, the BGR flag, the mean and the inverse standard deviation.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..._native_build import build_cuda_lib
from ...tools import launch_counts
from .image_ops import warp_affine

OP_NAME = "accvlab_tpu_torch::image_chain"
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                   "image_chain.cu")
# no multiply-add contraction: each operation rounds as the eager kernels do
NVCC_EXTRA = ["-fmad=false"]
#: per-sample parameters of the kernel
PARAMS = 27
_GATES = ("brightness", "pre_contrast", "saturation", "hue", "post_contrast", "swap")

#: kernel launches, one per image field
LAUNCHES = launch_counts.register({"image_chain": 0})

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int


def library_path() -> str:
    """Build (if needed) and return the path of the kernel library."""
    return build_cuda_lib(SRC, "libaccvlab_image_chain", NVCC_EXTRA)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(library_path())
                lib.accvlab_image_chain.restype = _I
                lib.accvlab_image_chain.argtypes = [_P] * 3 + [_I] * 5 + [_P, _I, _P]
                _LIB = lib
    return _LIB


def pack_params(maps: torch.Tensor, v: dict) -> torch.Tensor:
    """``(B, PARAMS)`` float32 from the affine step's ``(B, 2, 3)`` sampling
    maps and the photometric step's per-sample values
    (``photo_metric_distorter.sample_values``)."""
    b = maps.shape[0]
    f32 = torch.float32
    return torch.cat([maps.reshape(b, 6).to(f32)]
                     + [torch.stack([v[g].to(f32) for g in _GATES], -1)]
                     + [torch.stack([v["delta"], v["alpha"], v["s"]], -1).to(f32)]
                     + [v["hue_m"].reshape(b, 9).to(f32), v["perm"].to(f32)], -1).contiguous()


def unpack_params(params: torch.Tensor):
    """The sampling maps and the per-sample values that :func:`pack_params`
    packed, bit for bit."""
    b = params.shape[0]
    v = {g: params[:, 6 + i] != 0 for i, g in enumerate(_GATES)}
    v.update(delta=params[:, 12], alpha=params[:, 13], s=params[:, 14],
             hue_m=params[:, 15:24].reshape(b, 3, 3), perm=params[:, 24:27].long())
    return params[:, :6].reshape(b, 2, 3), v


def chain_consts(is_bgr: bool, mean: np.ndarray, inv_std: np.ndarray) -> List[float]:
    """The step constants of :func:`image_chain`: 11 floats, each a float32
    value."""
    from ..processing_steps.photo_metric_distorter import U8_INTENSITY, luma_of

    return ([float(U8_INTENSITY)] + luma_of(is_bgr) + [float(bool(is_bgr))]
            + [float(np.float32(x)) for x in np.concatenate([mean, inv_std])])


def image_chain_plain(src: torch.Tensor, params: torch.Tensor, out_hw: Sequence[int],
                      consts: Sequence[float]) -> torch.Tensor:
    """The chain as the steps compute it, one step after the other."""
    from ..processing_steps.image_normalizers import mean_std_normalize
    from ..processing_steps.photo_metric_distorter import distort

    maps, v = unpack_params(params)
    img = warp_affine(src, maps, out_hw, fill_value=0.0, inverse_map=True)
    img = distort(img, v, True, bool(consts[4]))
    return mean_std_normalize(img, np.asarray(consts[5:8], np.float32),
                              np.asarray(consts[8:11], np.float32), torch.float32)


def _check(src: torch.Tensor, params: torch.Tensor, out_h: int, out_w: int, consts) -> None:
    if src.dtype != torch.uint8 or src.ndim != 4 or src.shape[-1] != 3 or not src.is_contiguous():
        raise ValueError(f"image_chain takes a contiguous (B, H, W, 3) uint8 field, got "
                         f"{src.dtype} {tuple(src.shape)}")
    if params.dtype != torch.float32 or tuple(params.shape) != (src.shape[0], PARAMS) \
            or not params.is_contiguous() or params.device != src.device:
        raise ValueError(f"image_chain's params: expected a contiguous float32 "
                         f"({src.shape[0]}, {PARAMS}) tensor on {src.device}, got {params.dtype} "
                         f"{tuple(params.shape)} on {params.device}")
    if len(consts) != 11 or out_h < 0 or out_w < 0:
        raise ValueError(f"image_chain: 11 constants and a non-negative output size, got "
                         f"{len(consts)} and {(out_h, out_w)}")


def launch(src: torch.Tensor, params: torch.Tensor, out_h: int, out_w: int,
           consts: Sequence[float]) -> torch.Tensor:
    """The kernel on CUDA tensors (checked as the operator's inputs); a
    launch adds one to ``LAUNCHES["image_chain"]``, an empty output launches
    nothing and counts nothing."""
    _check(src, params, out_h, out_w, consts)
    if not src.is_cuda:
        raise ValueError("the image chain kernel takes CUDA tensors only")
    if src.shape[0] > 65535:
        raise ValueError(f"the image chain kernel takes at most 65535 samples, got {src.shape[0]}")
    b, h, w, _ = src.shape
    out = torch.empty((b, out_h, out_w, 3), dtype=torch.float32, device=src.device)
    if out.numel() == 0:
        return out
    host = np.asarray(consts, np.float32)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        err = _lib().accvlab_image_chain(
            _P(src.data_ptr()), _P(params.data_ptr()), _P(out.data_ptr()), b, h, w, out_h,
            out_w, host.ctypes.data_as(_P), int(out.data_ptr() % 16 == 0), _P(stream))
    if err != 0:
        raise RuntimeError(f"image_chain kernel launch failed: CUDA error {err}")
    LAUNCHES["image_chain"] += 1
    return out


@torch.library.custom_op(OP_NAME, mutates_args=())
def image_chain(src: torch.Tensor, params: torch.Tensor, out_h: int, out_w: int,
                consts: List[float]) -> torch.Tensor:
    """The ``(B, out_h, out_w, 3)`` float32 images of the chain on ``src``
    (a new tensor). Implemented per device below."""
    raise NotImplementedError(f"{OP_NAME} has no implementation for {src.device}")


@image_chain.register_kernel("cuda")
def _cuda(src, params, out_h, out_w, consts):
    return launch(src, params, out_h, out_w, consts)


@image_chain.register_kernel("cpu")
def _cpu(src, params, out_h, out_w, consts):
    _check(src, params, out_h, out_w, consts)
    return image_chain_plain(src, params, (out_h, out_w), consts)


@image_chain.register_fake
def _fake(src, params, out_h, out_w, consts):
    return src.new_empty((src.shape[0], out_h, out_w, 3), dtype=torch.float32)
