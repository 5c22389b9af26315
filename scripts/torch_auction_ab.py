"""The auction kernel from several source trees, in turns, on one CUDA card.

Run from the repository root, with each tree a checkout of this repository
(for example an earlier commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists):

    python3 scripts/torch_auction_ab.py build/parent . . build/parent

For each tree, in the order given, a fresh process whose working directory
is the tree builds that tree's ``ragged/csrc/auction_matching.cu``, runs it
on the batched loss example's 8 x 48 x 300 cost
(``chip_smoke.example_matching_cost``) with the default eps made
beforehand, checks its columns and rounds bitwise against the plain
version, and times the bare launch (``_auction_kernel.launch_auction``,
median of 50, L2 flushed, CUDA events; ``chip_smoke.device_ms``). Prints
one JSON line per run, with the tree and the card's name and power limit,
and exits non-zero if a run fails or disagrees. Comparing trees within one
call keeps them on one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CODE = """
import json, torch, chip_smoke
from accvlab_tpu_torch.ragged import _auction_kernel
from accvlab_tpu_torch.ragged.matching import _eps_per_sample, auction_plain
dev = torch.device("cuda", 0)
flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
cost, nv = chip_smoke.example_matching_cost(dev)
eps = _eps_per_sample(cost, None)
got = _auction_kernel.launch_auction(cost, nv, eps, 20000)
want = auction_plain(cost, nv, eps, 20000)
torch.cuda.synchronize()
same = all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
ms = chip_smoke.device_ms(lambda: _auction_kernel.launch_auction(cost, nv, eps, 20000),
                          chip_smoke.N_TIMED, flush)
print(json.dumps({"kernel_ms": ms, "bitwise": same, "rounds": got[1].tolist()}))
"""


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
        lines = [json.loads(s) for s in res.stdout.splitlines() if s.startswith('{"kernel_ms"')]
        if res.returncode != 0 or not lines or not lines[0]["bitwise"]:
            print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        print(json.dumps({"run": i, "tree": tree, "card": smi, **lines[0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
