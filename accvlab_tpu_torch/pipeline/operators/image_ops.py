"""Image resampling operators, batched (port of
``accvlab_tpu/pipeline/operators/image_ops.py``).

``warp_affine`` is the equivalent of DALI's ``fn.warp_affine`` (used by the
reference AffineTransformer): inverse-mapped bilinear resampling with a fill
value. The JAX package ``vmap``-s a per-sample gather + lerp; here the batch
is written out: one gather per bilinear corner over all samples, one 2x3
matrix per sample.
"""

from __future__ import annotations

import numpy as np
import torch


def invert_2x3(matrix: torch.Tensor) -> torch.Tensor:
    """Inverse of ``(..., 2, 3)`` affine transforms (same arithmetic order
    as the JAX package's ``_invert_2x3``)."""
    a, b, tx = matrix[..., 0, 0], matrix[..., 0, 1], matrix[..., 0, 2]
    c, d, ty = matrix[..., 1, 0], matrix[..., 1, 1], matrix[..., 1, 2]
    det = a * d - b * c
    inv_det = torch.ones_like(det) / det
    ia, ib = d * inv_det, -b * inv_det
    ic, id_ = -c * inv_det, a * inv_det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return torch.stack(
        [torch.stack([ia, ib, itx], dim=-1), torch.stack([ic, id_, ity], dim=-1)], dim=-2
    )


def warp_affine(
    images: torch.Tensor,
    matrix: torch.Tensor,
    out_hw,
    fill_value: float = 0.0,
    inverse_map: bool = False,
) -> torch.Tensor:
    """Affine-warp ``(B, H, W[, C])`` images to ``out_hw`` with bilinear sampling.

    Args:
        images: source images, any real dtype.
        matrix: ``(B, 2, 3)`` transforms (or one ``(2, 3)`` for all). With
            ``inverse_map=False`` (the DALI default) each maps source ->
            destination coordinates and its inverse is used for sampling.
        out_hw: output ``(height, width)``.
        fill_value: value for samples outside the source image.

    Pixel-center coordinates with (0, 0) at the center of the top-left pixel.
    """
    squeeze = images.ndim == 3
    img = images[..., None] if squeeze else images
    bsz, h, w, c = img.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    dev = img.device
    m = matrix.to(device=dev, dtype=torch.float32)
    if m.ndim == 2:
        m = m.expand(bsz, 2, 3)
    if not inverse_map:
        m = invert_2x3(m)

    def e(v):  # per-sample scalar -> (B, 1, 1)
        return v[:, None, None]

    ys = torch.arange(oh, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(ow, device=dev, dtype=torch.float32)[None, None, :]
    src_x = e(m[:, 0, 0]) * xs + e(m[:, 0, 1]) * ys + e(m[:, 0, 2])  # (B, oh, ow)
    src_y = e(m[:, 1, 0]) * xs + e(m[:, 1, 1]) * ys + e(m[:, 1, 2])

    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    wx = (src_x - x0)[..., None]
    wy = (src_y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = img.reshape(bsz * h * w, c)
    base = (torch.arange(bsz, device=dev, dtype=torch.int64) * (h * w))[:, None, None]

    def sample(yi, xi):
        idx = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        return flat[idx].to(torch.float32)  # (B, oh, ow, C)

    v00 = sample(y0i, x0i)
    v01 = sample(y0i, x0i + 1)
    v10 = sample(y0i + 1, x0i)
    v11 = sample(y0i + 1, x0i + 1)
    interp = (
        v00 * (1 - wx) * (1 - wy)
        + v01 * wx * (1 - wy)
        + v10 * (1 - wx) * wy
        + v11 * wx * wy
    )
    valid = (src_x >= 0) & (src_x <= w - 1) & (src_y >= 0) & (src_y <= h - 1)
    out = torch.where(valid[..., None], interp, torch.full((), float(fill_value), device=dev))
    if not img.dtype.is_floating_point:
        info = np.iinfo(str(img.dtype).replace("torch.", ""))
        out = torch.clamp(torch.round(out), info.min, info.max)
    out = out.to(img.dtype)
    return out[..., 0] if squeeze else out


def linear_resize_matrix(in_size: int, out_size: int) -> torch.Tensor:
    """``(out_size, in_size)`` float32 weights of a linear resize along one
    axis: what ``jax.image.resize(method="linear", antialias=False)``
    computes (``jax._src.image.scale.compute_weight_mat``, transposed), so
    that ``out = W @ x`` along that axis.

    Half-pixel sampling (``sample = (i + 0.5) * in/out - 0.5``), the triangle
    kernel ``max(0, 1 - |sample - j|)`` unscaled (no antialias), each
    output's weights divided by their sum, and zeroed where the sample lies
    outside ``[-0.5, in_size - 0.5]``, in float32 in the same order. Equal
    sizes give the identity. Built on the CPU; move it to the device once.
    """
    in_size, out_size = int(in_size), int(out_size)
    # JAX: scale = out / in in float64, its inverse rounded to float32
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None])
    weights = torch.clamp(1 - torch.abs(x), min=0.0)  # (in, out)
    total = torch.sum(weights, dim=0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    weights = torch.where(torch.abs(total) > 1000.0 * eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).T.contiguous()
