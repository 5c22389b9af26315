"""The port's main path from several source trees, in turns, on one CUDA card.

Run from the repository root, with each tree a checkout of this repository
(for example the parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists):

    python3 scripts/torch_main_path_ab.py [--wire dct|yuv|frames] build/parent . . build/parent

For each tree, in the order given, runs that tree's phase of bench.py's
pipeline at full width on ``--wire``, in a fresh process whose working
directory is the tree, so that it builds and imports that tree's own
package:

* ``dct`` (the default): ``chip_smoke.main_phase``, phase ``main``: 2
  warm-up batches, then 3 timed windows of 100 batches, outputs checked
  against the plain heatmap version;
* ``yuv``: ``chip_smoke.main_phase(wire="yuv")``, phase ``main_yuv``: one
  window of 100 batches on the YUV wire with libjpeg;
* ``frames``: ``chip_smoke.main_frames_phase``, phase ``main_frames``: one
  window of 100 batches on raw RGB frames.
 Prints one JSON line per run, with the tree
and the card's name and power limit, and exits non-zero if a run fails.
Comparing trees within one call keeps them on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PHASES = {
    "dct": ("main", "chip_smoke.main_phase(dev, '')"),
    "yuv": ("main_yuv", "chip_smoke.main_phase(dev, '', wire='yuv')"),
    "frames": ("main_frames", "chip_smoke.main_frames_phase(dev, '')"),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--wire", default="dct", choices=sorted(PHASES))
    parser.add_argument("trees", nargs="+")
    args = parser.parse_args()
    phase, call = PHASES[args.wire]
    code = f"import torch, chip_smoke; dev = torch.device('cuda', 0); {call}"
    prefix = json.dumps({"phase": phase})[:-1] + ","
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    for i, tree in enumerate(args.trees):
        res = subprocess.run([sys.executable, "-c", code], cwd=os.path.abspath(tree),
                             capture_output=True, text=True)
        lines = [json.loads(s) for s in res.stdout.splitlines() if s.startswith(prefix)]
        if res.returncode != 0 or not lines:
            print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        main_line = {k: v for k, v in lines[0].items() if k not in ("card", "config")}
        print(json.dumps({"run": i, "tree": tree, "card": smi, **main_line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
