"""Cells of ``BENCHMARK.json`` cut to a size that a CPU test holds: the
same code, cut by the cell's family (its ``tiny``)."""

from __future__ import annotations

from portbench.spec import ROOT, load_cell

SEED = 2**31 + 977
CELLS = ["centernet_6cam.fed_frames"]


def tiny_cell(name: str, root: str = ROOT):
    cell = load_cell(name, root=root)
    cell.family.tiny(cell.config, cell.traffic)
    return cell
