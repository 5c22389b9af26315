"""Cells of ``BENCHMARK.json`` cut to a size that a CPU test holds: the
same code, a few small frames, two cameras, a narrow network."""

from __future__ import annotations

from portbench.spec import load_cell

SEED = 2**31 + 977
CELLS = ["centernet_6cam.fed_frames"]


def tiny_cell(name: str):
    cell = load_cell(name)
    cfg, tr = cell.config, cell.traffic
    cfg.update(frame_hw=[48, 64], out_hw=[32, 64], heatmap_hw=[8, 16], batch_size=2,
               num_cams=2, max_objects=4, widths=[4, 8, 8, 8], deconv_filters=[8, 8, 8],
               head_conv=4)
    tr.update(num_unique=3, num_samples=200, warmup_steps=2, breakdown_steps=2, profile_steps=2,
              num_threads=2)
    return cell
