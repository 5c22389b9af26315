"""Gaussian splatting with float radii (pipeline variant), batched.

PyTorch counterpart of ``accvlab_tpu/heatmap/draw_gaussians.py``; runs on the
same CUDA rasterizer as :mod:`.draw` (``csrc/draw_heatmap.cu``, which
prepares the targets from the raw inputs itself) with the pipeline's own rule
(``draw_gaussians.py:61-89``):

* drawing box per target: ``|dy| <= ceil(r)``, ``|dx| <= ceil(r)``;
* ``sigma = radius * radius_to_sigma_factor``;
  ``val = k[class] * exp(-(dy^2 + dx^2) / max(2 sigma^2, 1e-12))``;
* max-combine with the existing heatmap; inactive targets skipped;
* class ids are **clamped** into ``[0, C-1]`` (unlike :mod:`.draw`, which
  masks out-of-range ids).

With ``implementation`` ``"auto"`` or ``"kernel"`` the call goes through the
registered operator ``accvlab_tpu_torch::draw_gaussians`` (:mod:`._ops`: the
kernel on CUDA tensors, the plain version on CPU tensors), so
``torch.export`` can trace it; ``"torch"`` runs the plain version inline.

Where the JAX function draws one sample, this one takes any number of
leading batch dimensions: ``active`` is ``(*batch, T)`` and ``heatmap`` is
``(*batch, C, H, W)`` (or ``(*batch, H, W)``). All samples go to the card in
one kernel launch; the per-class peaks travel in the launch's arguments, so
a call on CUDA tensors makes no copy between host and card.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ._ops import draw_gaussians_op
from .draw import _as_f32_map, _use_kernel, raster_plain


def draw_gaussians(
    heatmap,
    active,
    slice_ids,
    centers,
    radii,
    k_for_classes: Sequence[float],
    radius_to_sigma_factor: float,
    implementation: str = "auto",
    exact: bool = False,
    device=None,
) -> torch.Tensor:
    """Draw Gaussians into ``(*batch, C, H, W)`` (or ``(*batch, H, W)``) maps.

    Args:
        heatmap: float32 maps (a numpy array goes to ``device``, default CUDA).
        active: ``(*batch, T)`` bool.
        slice_ids: ``(*batch, T)`` int class/channel per target.
        centers: ``(*batch, T, 2)`` int — x, y full-pixel centers.
        radii: ``(*batch, T)`` float32.
        k_for_classes: per-class peak scale (a host sequence; the kernel
            takes at most ``_kernel.MAX_CLASSES`` classes).
        radius_to_sigma_factor: ``sigma = radius * factor``.
        implementation: ``"auto"`` | ``"kernel"`` | ``"torch"`` (see :mod:`.draw`).
        exact: ``True`` uses the bit-reproducible exp (the JAX function has
            only the backend exp, i.e. ``exact=False``).
    """
    hm = _as_f32_map(heatmap, device)
    dev = hm.device
    _use_kernel(implementation, dev)  # validates; "kernel" on CPU tensors raises

    def as_t(x, dtype):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.to(device=dev, dtype=dtype)

    active = as_t(active, torch.bool)
    batch = tuple(active.shape[:-1])
    t = active.shape[-1]
    squeeze = hm.ndim == len(batch) + 2
    if squeeze:
        hm = hm.unsqueeze(-3)
    c, h, w = hm.shape[-3:]
    b = int(math.prod(batch))
    hm4 = hm.reshape(b, c, h, w)
    targets = (active.reshape(b, t).contiguous(),
               as_t(slice_ids, torch.int32).reshape(b, t).contiguous(),
               as_t(centers, torch.int32).reshape(b, t, 2).contiguous(),
               as_t(radii, torch.float32).reshape(b, t).contiguous())
    if t == 0:
        out = hm4
    elif implementation != "torch":
        out = draw_gaussians_op(hm4.contiguous(), *targets,
                                [float(k) for k in np.asarray(k_for_classes).reshape(-1)],
                                float(radius_to_sigma_factor), bool(exact))
    else:
        params = gaussian_params(*targets, k_for_classes, radius_to_sigma_factor, c)
        out = raster_plain(hm4, *params, 1.0, exact, False)
    out = out.reshape(*batch, c, h, w)
    return out.squeeze(-3) if squeeze else out


def gaussian_params(active, slice_ids, centers, radii, k_for_classes, radius_to_sigma_factor,
                    num_classes: int):
    """``(B, T)`` targets -> the rasterizer's ``(xs, ys, rr, iv, sel, kt)``:
    ids clamped into ``[0, C-1]``, reach ``ceil(r)`` (``-1`` when inactive),
    ``iv = 1 / max(2 sigma^2, 1e-12)`` and the peak ``k[class]`` per target."""
    ids = slice_ids.clamp(0, max(num_classes - 1, 0))
    xs = centers[..., 0].to(torch.float32).contiguous()
    ys = centers[..., 1].to(torch.float32).contiguous()
    reach = torch.ceil(radii)
    rr = torch.where(active, reach, torch.full_like(reach, -1.0)).contiguous()
    sigma = radii * float(radius_to_sigma_factor)
    var2 = torch.maximum(2.0 * sigma * sigma, torch.full_like(sigma, 1e-12))
    inv = (torch.ones_like(var2) / var2).contiguous()
    k = torch.as_tensor(np.asarray(k_for_classes, np.float32), device=radii.device)
    kt = k[ids.long()].contiguous()
    return xs, ys, rr, inv, ids.contiguous(), kt
