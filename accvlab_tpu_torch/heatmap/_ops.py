"""The rasterizer of ``draw_gaussians`` as a registered PyTorch operator.

The CUDA rasterizer is bound through ``ctypes`` (:mod:`._kernel`), which
``torch.export`` cannot trace. ``accvlab_tpu_torch::draw_gaussians`` wraps it
as an operator that can: an exported program that draws heatmaps calls the
operator, and the operator launches the kernel. Importing this module
registers the operator; a serving host that loads such a program imports it
and nothing of ``pipeline`` or ``models``.

* CUDA: :func:`._kernel.launch_gaussians` (counts its launches in
  ``LAUNCHES["draw_gaussians"]``; a failed build or launch raises);
* CPU: the plain PyTorch version (:func:`.draw.raster_plain`);
* fake (tracing): a new map shaped as ``heatmap``.

The inputs are those of :func:`._kernel.launch_gaussians`: ``(B, C, H, W)``
float32 maps, ``(B, T)`` targets and the per-class peaks as a list of floats.
"""

from __future__ import annotations

from typing import List

import torch

from . import _kernel

OP_NAME = "accvlab_tpu_torch::draw_gaussians"


@torch.library.custom_op(OP_NAME, mutates_args=())
def draw_gaussians_op(heatmap: torch.Tensor, active: torch.Tensor, ids: torch.Tensor,
                      centers: torch.Tensor, radii: torch.Tensor, k_for_classes: List[float],
                      factor: float, exact: bool) -> torch.Tensor:
    """The maps with every active target's Gaussian max-combined in (a new
    tensor). Implemented per device below."""
    raise NotImplementedError(f"{OP_NAME} has no implementation for {heatmap.device}")


@draw_gaussians_op.register_kernel("cuda")
def _cuda(heatmap, active, ids, centers, radii, k_for_classes, factor, exact):
    return _kernel.launch_gaussians("draw_gaussians", heatmap, active, ids, centers, radii,
                                    k_for_classes, factor, exact)


@draw_gaussians_op.register_kernel("cpu")
def _cpu(heatmap, active, ids, centers, radii, k_for_classes, factor, exact):
    from .draw import raster_plain
    from .draw_gaussians import gaussian_params

    params = gaussian_params(active, ids, centers, radii, k_for_classes, factor,
                             heatmap.shape[1])
    return raster_plain(heatmap, *params, 1.0, exact, False)


@draw_gaussians_op.register_fake
def _fake(heatmap, active, ids, centers, radii, k_for_classes, factor, exact):
    return torch.empty_like(heatmap)
