"""Device time of the CUDA rasterizer for each tile shape, on one CUDA card.

Run from the repository root:  python3 scripts/torch_raster_tiles.py

For each entry point's kernel form (batched, classwise, flat, gaussians) at
the main path's shapes (48 maps, 10 classes, 64x176, T=32) and the
reference headline shapes (48 maps, 20 classes, 20x50, T=50; both from
``chip_smoke``'s ``make_case``), launches the kernel directly with every tile shape in TILES
(threads along x, each drawing 4 pixels of a row; threads along y; rows per
thread) and prints one JSON line per form: the median device time of each
tile (CUDA events, L2 flushed, ``chip_smoke.device_ms``), fast exp and exact
exp, beside that of a plain copy of the same map (``torch.clone``: the bytes
of the rasterizer without its work) and the tile the wrappers choose for it
(``_kernel.choose_tile``). Every tile's output is checked bitwise against the
chosen tile's first.
Needs a card; prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

TILES = [(8, 4, 1), (16, 4, 1), (32, 4, 1), (8, 8, 1), (8, 16, 1), (16, 8, 1), (8, 8, 2),
         (8, 16, 2), (16, 8, 2), (16, 16, 2), (32, 4, 2), (8, 8, 4), (8, 16, 4), (16, 8, 4),
         (32, 4, 4), (16, 4, 4), (8, 4, 4)]


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 2
    from accvlab_tpu_torch.heatmap import _kernel

    smi = chip_smoke.nvidia_smi_line()
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cases = [(kind, shapes) for kind in chip_smoke.KINDS for shapes in ("main", "headline")]
    for seed, (kind, shapes) in enumerate(cases):
        _, bare, plain, reads, shape, t = chip_smoke.make_case(kind, shapes, seed, dev)
        hm = plain(False)[0]
        chosen = _kernel.choose_tile(math.prod(shape[:-2]), *shape[-2:], reads[0].shape[1],
                                     torch.cuda.get_device_properties(dev).multi_processor_count)
        row = {"kernel": chip_smoke.ENTRY[kind], "shapes": shapes, "shape": shape, "targets": t,
               "card": smi, "chosen_tile": list(chosen),
               "copy_ms": chip_smoke.device_ms(hm.clone, chip_smoke.N_TIMED, flush)}
        for exact in (False, True):
            want = bare(exact)
            times = {}
            for tile in TILES:
                if not torch.equal(bare(exact, tile), want):
                    chip_smoke.fail(f"{kind}: tile {tile} differs from the chosen tile")
                times["x".join(map(str, tile))] = chip_smoke.device_ms(
                    lambda: bare(exact, tile), chip_smoke.N_TIMED, flush)
            row["exact_ms" if exact else "ms"] = times
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
