"""Data-echoing throughput of bench.py's pipeline on the port.

The counterpart of ``scripts/bench_echo.py``: delivered (batch, augmented)
frames per second for each ``echo_factor`` on bench.py's 6-camera
372x1024 -> 256x704 pipeline (``bench_pipeline.build_pipeline``, batch 8)
on the DCT wire, bench.py's default. Each replay skips the host stage and
the transfer, so delivered frames/s grows with the factor until the
consumer's enqueue or the card sets the pace.

Per factor: one batch, then ``2 * factor`` warm-up deliveries, then the best
of 3 windows of ``batches * factor`` deliveries (the same host batches per
factor), the card synchronised at each window's end. Then the input idle
share of ``bench_pipeline.measure_input_idle`` fed by the echoed pipeline.
One JSON line per factor, then the card's ``nvidia-smi`` name and power
limit.

Usage: python3 scripts/torch_bench_echo.py [--factors 1,2,4] [--batches 12]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
                         "bench_cache")
IDLE_ITERS = 4


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def measure(factor: int, batches: int, batch_size: int = 8, num_cams: int = 6) -> dict:
    import torch

    from accvlab_tpu_torch.bench_pipeline import build_pipeline, measure_input_idle

    pipe = build_pipeline(batch_size=batch_size, echo_factor=factor, wire="dct",
                          cache_dir=CACHE_DIR)
    try:
        t0 = time.perf_counter()
        pipe.run()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        for _ in range(2 * factor):
            pipe.run()
        n = batches * factor
        best = None
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(n):
                pipe.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            best = dt if best is None else min(best, dt)
        stats = pipe.stats()
        frames = n * batch_size * num_cams
        idle = measure_input_idle(pipe, num_cams, n_iters=IDLE_ITERS)
    finally:
        pipe.stop()
    return {"echo_factor": factor, "wire": "dct", "delivered_fps": frames / best,
            "fresh_fps": frames / best / factor,
            "effective_wire_MBps": n / factor * stats["bytes_per_batch"] / 1e6 / best,
            "bytes_per_transfer": stats["bytes_per_batch"], "batches": n,
            "first_batch_s": first_s, "consumed": stats["consumed"],
            "transfers": stats["transfers"], "input_idle": idle["idle"],
            "t_e2e_s": idle["t_e2e_s"], "t_comp_s": idle["t_comp_s"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--factors", default="1,2,4")
    ap.add_argument("--batches", type=int, default=12)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_bench_echo: needs a CUDA device")
    for factor in [int(f) for f in args.factors.split(",")]:
        print(json.dumps(measure(factor, args.batches)), flush=True)
    print(nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
