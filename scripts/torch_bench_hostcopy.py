"""Packed against per-tensor copies on the card (the counterpart of
``scripts/bench_hostcopy.py``; the reference's headline is x8.10 for 528
tensors against per-tensor ``.to()``).

Three rows, each over ``make_tree``'s 528 leaves (float32 and int32 in
turns, sizes drawn around an average):

* ``h2d`` at 4 KB (dispatch-bound): per-tensor ``torch.from_numpy(v).to(dev)``
  against ``start_copy(tree).get()``;
* ``h2d`` at 150 KB (bandwidth-bound): the same;
* ``d2h`` at 4 KB: per-leaf ``.cpu()`` of the tree on the card against
  ``start_copy(cuda_tree, device="cpu").get()``.

Every timed call ends in ``torch.cuda.synchronize()``. Each row first checks
that the two forms give the same bits, then times them in windows in turns
(naive, packed, packed, naive, ...): ``WINDOWS`` windows of ``REPS`` calls
for each form. It prints one JSON line per row: the median and the spread
(min, max) of each form's ms per call over its windows, the ratio of the
medians, the tree's bytes, and the card's name and power limit from
``nvidia-smi``.

Run on the card: ``python3 scripts/torch_bench_hostcopy.py [--n 528]``. Without a card it raises unless given
``--device cpu`` (a rehearsal: CPU times, no card metric).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from accvlab_tpu_torch._device import resolve_device
from accvlab_tpu_torch.hostcopy import start_copy

N = 528
ROWS = (("h2d", 4), ("h2d", 150), ("d2h", 4))
WINDOWS = 6
REPS = 5


def make_tree(avg_kb: int, seed: int, n: int = N) -> dict:
    """``scripts/bench_hostcopy.py``'s tree: ``n`` leaves, float32 and int32
    in turns, each of about ``avg_kb`` KB."""
    rng = np.random.default_rng(seed)
    tree = {}
    for i in range(n):
        size = max(16, int(rng.normal(avg_kb * 1024, avg_kb * 200)) // 4)
        tree[f"t{i}"] = (rng.integers(0, 100, size, np.int32) if i % 2
                         else rng.normal(size=size).astype(np.float32))
    return tree


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or "no card"."""
    if not torch.cuda.is_available():
        return "no card"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def forms(direction: str, avg_kb: int, dev: torch.device, n: int = N):
    """The row's tree, its bytes, and its two forms as functions that end
    in a synchronisation: ``(naive, packed, nbytes)``."""
    if direction == "h2d":
        tree = make_tree(avg_kb, seed=avg_kb, n=n)

        def naive():
            out = {k: torch.from_numpy(v).to(dev) for k, v in tree.items()}
            _sync(dev)
            return out

        def packed():
            out = start_copy(tree, dev).get()
            _sync(dev)
            return out
    elif direction == "d2h":
        host = make_tree(avg_kb, seed=1000 + avg_kb, n=n)
        tree = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        _sync(dev)

        def naive():
            out = {k: v.cpu() for k, v in tree.items()}
            _sync(dev)
            return out

        def packed():
            out = start_copy(tree, device="cpu").get()
            _sync(dev)
            return out
    else:
        raise ValueError(f"direction {direction!r}: 'h2d' or 'd2h'")
    return naive, packed, sum(v.nbytes for v in (tree if direction == "h2d" else host).values())


def same_bits(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def measure(direction: str, avg_kb: int, dev, windows: int = WINDOWS, reps: int = REPS,
            n: int = N) -> dict:
    """One row: the two forms checked bitwise, then timed in windows in
    turns; ms per call, median and spread over the windows."""
    dev = resolve_device(dev)
    naive, packed, nbytes = forms(direction, avg_kb, dev, n)
    if not same_bits(naive(), packed()):
        raise AssertionError(f"{direction} {avg_kb} KB: start_copy differs from per-tensor copies")
    fns = {"naive": naive, "packed": packed}
    ms = {"naive": [], "packed": []}
    for w in range(windows):  # naive, packed, packed, naive, naive, packed, ...
        for name in (("naive", "packed") if w % 2 == 0 else ("packed", "naive")):
            fns[name]()  # one call outside the window: each starts from the same state
            t0 = time.perf_counter()
            for _ in range(reps):
                fns[name]()
            ms[name].append((time.perf_counter() - t0) / reps * 1e3)
    med = {k: statistics.median(v) for k, v in ms.items()}
    return {
        "direction": direction, "avg_kb": avg_kb, "tensors": n, "total_mb": nbytes / 1e6,
        "device": str(dev) if dev.type == "cpu" else torch.cuda.get_device_name(dev),
        "naive_ms": med["naive"], "packed_ms": med["packed"],
        "naive_spread_ms": [min(ms["naive"]), max(ms["naive"])],
        "packed_spread_ms": [min(ms["packed"]), max(ms["packed"])],
        "speedup": med["naive"] / med["packed"], "windows": windows, "reps": reps,
        "bitwise": True,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' to rehearse (default: the card)")
    ap.add_argument("--n", type=int, default=N, help="leaves per tree")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line()
    for direction, avg_kb in ROWS:
        row = measure(direction, avg_kb, dev, n=args.n)
        print(json.dumps({**row, "card": card}), flush=True)


if __name__ == "__main__":
    main()
