"""The port's main path from several source trees, in turns, on one CUDA card.

Run from the repository root, with each tree a checkout of this repository
(for example the parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists):

    python3 scripts/torch_main_path_ab.py build/parent . . build/parent

For each tree, in the order given, runs that tree's ``chip_smoke.main_phase``
(bench.py's pipeline at full width: 2 warm-up batches, then 3 timed windows
of 100 batches, outputs checked against the plain heatmap version) in a
fresh process whose working directory is the tree, so that it builds and
imports that tree's own package. Prints one JSON line per run, with the tree
and the card's name and power limit, and exits non-zero if a run fails.
Comparing trees within one call keeps them on one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CODE = "import torch, chip_smoke; chip_smoke.main_phase(torch.device('cuda', 0), '')"


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    for i, tree in enumerate(trees):
        res = subprocess.run([sys.executable, "-c", CODE], cwd=os.path.abspath(tree),
                             capture_output=True, text=True)
        lines = [json.loads(s) for s in res.stdout.splitlines() if s.startswith('{"phase": "main"')]
        if res.returncode != 0 or not lines:
            print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        main_line = {k: v for k, v in lines[0].items() if k not in ("card", "config")}
        print(json.dumps({"run": i, "tree": tree, "card": smi, **main_line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
