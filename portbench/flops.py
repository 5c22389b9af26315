"""Operations and bytes from shapes, and the card's published peaks.

A multiply-add is 2 operations. A convolution makes ``cin * k * k``
multiply-adds for each of its ``cout`` outputs at each output pixel; a
transposed convolution, ``cout * k * k`` for each of its ``cin`` inputs at
each input pixel. A training step is the forward pass, the input gradient
of every layer but the first conv (whose input is the images) and every
layer's weight gradient, each as many operations as the forward layer:
``3 * forward - first conv``. Norms, activations, pooling, the losses and
the optimizer are left out.
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


def centernet_step(cfg: dict) -> float:
    """One training step of CenterNet's ResNet network (``network.py``) on
    every camera of a batch at ``out_hw``: the 7x7 stem, the basic blocks and
    their 1x1 shortcuts, the transposed convs, and per head its 3x3 and 1x1
    convs."""
    n = int(cfg["batch_size"]) * int(cfg["num_cams"])
    h, w = (-(-int(x) // 2) for x in cfg["out_hw"])
    widths = [int(c) for c in cfg["widths"]]
    first = conv_ops(n, 3, widths[0], 7, h * w)
    fwd = first
    h, w = -(-h // 2), -(-w // 2)  # the max pool
    cin = widths[0]
    for s, (blocks, cout) in enumerate(zip(cfg["blocks"], widths)):
        for j in range(int(blocks)):
            if s > 0 and j == 0:
                h, w = -(-h // 2), -(-w // 2)
            fwd += conv_ops(n, cin, cout, 3, h * w) + conv_ops(n, cout, cout, 3, h * w)
            if (s > 0 and j == 0) or cin != cout:
                fwd += conv_ops(n, cin, cout, 1, h * w)
            cin = cout
    for cout in cfg["deconv_filters"]:
        fwd += conv_ops(n, cin, int(cout), int(cfg["deconv_kernel"]), h * w)
        h, w, cin = 2 * h, 2 * w, int(cout)
    hc = int(cfg["head_conv"])
    for outs in (int(cfg["num_classes"]), 2, 2):
        fwd += conv_ops(n, cin, hc, 3, h * w) + conv_ops(n, hc, outs, 1, h * w)
    return 3.0 * fwd - first


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
