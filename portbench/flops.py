"""Operations and bytes from shapes, and the card's published peaks.

A multiply-add is 2 operations. A convolution makes ``cin * k * k``
multiply-adds for each of its ``cout`` outputs at each output pixel; a
transposed convolution, ``cout * k * k`` for each of its ``cin`` inputs at
each input pixel. A training step is the forward pass, the input gradient
of every layer but the first conv (whose input is the images) and every
layer's weight gradient, each as many operations as the forward layer:
``3 * forward - first conv``. Norms, activations, pooling, the losses and
the optimizer are left out. A family counts its own step
(``families/<family>.py``'s ``step_flops``) with these.
"""

from __future__ import annotations

from typing import Dict, Optional

#: NVIDIA's data sheet, H100 SXM, dense, at 700 W
PEAKS = {"H100": {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes": 3.35e12}}


def peaks(device_kind: str) -> Optional[Dict[str, float]]:
    for key, value in PEAKS.items():
        if key in device_kind:
            return value
    return None


def conv_ops(batch: int, cin: int, cout: int, k: int, pixels: int) -> float:
    """A convolution over ``pixels`` output pixels, or a transposed one over
    ``pixels`` input pixels, on ``batch`` images."""
    return 2.0 * batch * pixels * cin * cout * k * k


def raster_bound_s(cfg: dict, peak: Dict[str, float]) -> float:
    """The least time of one rasterizer launch over a batch's heatmaps
    (every camera of the batch): the maps read and written once, the targets
    read once, at the memory's rate; or the float32 operations of every
    target's window at the largest radius, 8 a pixel, whichever is longer
    (the bytes, at these shapes)."""
    n = int(cfg["batch_size"]) * int(cfg["num_cams"])
    hh, hw = cfg["heatmap_hw"]
    t = int(cfg["max_objects"])
    maps = n * int(cfg["num_classes"]) * hh * hw * 4
    targets = n * t * (1 + 4 + 8 + 4)  # active, class, centre, radius
    reach = 2 * 10 + 1
    ops = n * t * reach * reach * 8.0
    return max((2 * maps + targets) / peak["hbm_bytes"], ops / peak["fp32_flops"])


def image_chain_bound_s(cfg: dict, peak: Dict[str, float]) -> float:
    """The least time of one launch of the image chain's kernel (warp,
    photometric distortion, normalization) over one camera field of a batch:
    its uint8 source frames read once and its float32 images written once,
    at the memory's rate."""
    b = int(cfg["batch_size"])
    h, w = cfg["frame_hw"]
    oh, ow = cfg["out_hw"]
    return (b * h * w * 3 + b * oh * ow * 3 * 4) / peak["hbm_bytes"]
