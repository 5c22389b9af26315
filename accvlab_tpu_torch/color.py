"""YCbCr 4:2:0 -> RGB on the device, and the host's chroma subsampling.

Port of ``accvlab_tpu/color.py``. The host ships planar Y plus 2x2-subsampled
interleaved CbCr (1.5 bytes per pixel instead of 3 for RGB); the device
upsamples the chroma (nearest, each 2x2 luma block shares one chroma
sample), applies the colour matrix and rounds to uint8.

* :func:`ycbcr_coefficients` and :func:`ycbcr420_to_rgb` take torch tensors
  (any leading batch dimensions) and run on their device;
* :func:`subsample_chroma_420` and :func:`yuv420p_planes_to_wire` are numpy
  copies of the JAX package's host helpers (the port keeps its own).
"""

from __future__ import annotations

import numpy as np
import torch

# Kr/Kb per standard (Kg = 1 - Kr - Kb)
_MATRIX_KR_KB = {
    "bt601": (0.299, 0.114),
    "bt709": (0.2126, 0.0722),
    "bt2020": (0.2627, 0.0593),  # non-constant-luminance (the common case)
}


def ycbcr_coefficients(matrix: str = "bt601", color_range: str = "full"):
    """Return ``(y_scale, y_offset, c_rr, c_gb, c_gr, c_bb)`` as float32
    scalars such that, with ``cb' = cb - 128`` and ``cr' = cr - 128``::

        yf = (y - y_offset) * y_scale
        r  = yf + c_rr * cr'
        g  = yf - c_gb * cb' - c_gr * cr'
        b  = yf + c_bb * cb'

    ``color_range="full"`` is the JPEG/JFIF convention (Y, C in [0, 255]);
    ``"limited"`` is the video convention (Y in [16, 235], C in [16, 240]).
    """
    try:
        kr, kb = _MATRIX_KR_KB[matrix]
    except KeyError:
        raise ValueError(
            f"matrix must be one of {sorted(_MATRIX_KR_KB)}, got {matrix!r}"
        ) from None
    kg = 1.0 - kr - kb
    if color_range == "full":
        y_scale, y_offset, c_scale = 1.0, 0.0, 1.0
    elif color_range == "limited":
        y_scale, y_offset, c_scale = 255.0 / 219.0, 16.0, 255.0 / 224.0
    else:
        raise ValueError(f"color_range must be 'full' or 'limited', got {color_range!r}")
    return tuple(
        np.float32(v)
        for v in (
            y_scale,
            y_offset,
            2.0 * (1.0 - kr) * c_scale,
            2.0 * kb * (1.0 - kb) / kg * c_scale,
            2.0 * kr * (1.0 - kr) / kg * c_scale,
            2.0 * (1.0 - kb) * c_scale,
        )
    )


def _repeat2x(c: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of the last two axes: ``(..., h, w) -> (..., 2h,
    2w)``, one broadcast copy (no host synchronisation)."""
    *lead, h, w = c.shape
    return c[..., :, None, :, None].expand(*lead, h, 2, w, 2).reshape(*lead, 2 * h, 2 * w)


def ycbcr420_to_rgb(y: torch.Tensor, cbcr: torch.Tensor, matrix: str = "bt601",
                    color_range: str = "full") -> torch.Tensor:
    """Planar Y + interleaved subsampled CbCr to uint8 RGB (HWC).

    Args:
        y: ``(..., H, W)`` uint8 luma (H, W even).
        cbcr: ``(..., H/2, W/2, 2)`` uint8 chroma, channel order (Cb, Cr).
        matrix: ``"bt601"``, ``"bt709"`` or ``"bt2020"``.
        color_range: ``"full"`` (JPEG) or ``"limited"`` (typical video).

    The float32 arithmetic runs in the JAX package's order: ``(y - yo) * ys``,
    ``c - 128``, the nearest 2x chroma repeat on the last two spatial axes,
    the matrix, ``floor(x + 0.5)``, clip to [0, 255]. Returns
    ``(..., H, W, 3)`` uint8 on the inputs' device.
    """
    ys, yo, c_rr, c_gb, c_gr, c_bb = (float(c) for c in ycbcr_coefficients(matrix, color_range))
    yf = (y.to(torch.float32) - yo) * ys
    cbf = _repeat2x(cbcr[..., 0].to(torch.float32) - 128.0)
    crf = _repeat2x(cbcr[..., 1].to(torch.float32) - 128.0)
    r = yf + c_rr * crf
    g = yf - c_gb * cbf - c_gr * crf
    b = yf + c_bb * cbf
    rgb = torch.stack([r, g, b], dim=-1)
    rounded = torch.floor(rgb + 0.5)  # round half up
    return rounded.clamp_(0.0, 255.0).to(torch.uint8)


def subsample_chroma_420(ycbcr: np.ndarray):
    """Host-side split of a full-resolution YCbCr image into wire planes.

    Args:
        ycbcr: ``(H, W, 3)`` uint8, H and W even.

    Returns:
        ``(y, cbcr)``: ``(H, W)`` uint8 luma and ``(H/2, W/2, 2)`` uint8
        chroma, each chroma sample the rounded mean of its 2x2 block.
    """
    ycbcr = np.asarray(ycbcr, np.uint8)
    h, w, c = ycbcr.shape
    if c != 3:
        raise ValueError(f"expected (H, W, 3) YCbCr, got shape {ycbcr.shape}")
    if h % 2 or w % 2:
        raise ValueError(
            f"4:2:0 wire format needs even height/width, got {h}x{w} "
            "(pick an even decode/resize target)"
        )
    y = ycbcr[..., 0]
    c16 = ycbcr[..., 1:3].astype(np.uint16)
    cbcr = (
        c16[0::2, 0::2] + c16[1::2, 0::2] + c16[0::2, 1::2] + c16[1::2, 1::2] + 2
    ) >> 2
    return y, cbcr.astype(np.uint8)


def yuv420p_planes_to_wire(u: np.ndarray, v: np.ndarray):
    """Pack separate half-resolution U/V planes (I420 layout) into the
    interleaved ``(H/2, W/2, 2)`` CbCr wire array."""
    return np.stack([np.asarray(u, np.uint8), np.asarray(v, np.uint8)], axis=-1)
