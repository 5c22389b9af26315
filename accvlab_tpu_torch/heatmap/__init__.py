"""Gaussian heatmap rasterization on one hand-written CUDA kernel."""

from ._kernel import LAUNCHES, reset_launch_counts
from .draw import draw_heatmap, draw_heatmap_batched
from .draw_gaussians import draw_gaussians

__all__ = [
    "LAUNCHES",
    "draw_gaussians",
    "draw_heatmap",
    "draw_heatmap_batched",
    "reset_launch_counts",
]
