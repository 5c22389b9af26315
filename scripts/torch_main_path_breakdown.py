"""Where the PyTorch port's headline pipeline spends its time, on one CUDA card.

Run from the repository root:  python3 scripts/torch_main_path_breakdown.py

Builds bench.py's multi-camera pipeline on the port
(``accvlab_tpu_torch.bench_pipeline``: 6 x 372x1024 RGB, batch 8, out
256x704, heatmap 10x64x176) and prints JSON lines:

* ``serial``: each phase of one batch run alone, one after the other, with a
  synchronise after each, on the host clock (median over ``--batches``):
  host stage (input callable + stacking, on the worker pool), transfer
  (pack into pinned memory + host-to-device copy) and every device step;
* ``pipelined``: the prefetching ``run()`` loop as a user drives it, frames/s
  and ms per batch, with the device's busy share over the same window from
  ``torch.profiler`` (sum of kernel and copy time over wall time);
* ``top_device_ops``: the device operations that take the most time in the
  pipelined window.

Needs a card; prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from accvlab_tpu_torch.bench_pipeline import build_pipeline  # noqa: E402


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed_steps(pipe, step_ms: dict) -> None:
    """Wrap each device step's ``_process`` of ``pipe`` so that it records
    its host-clock time, synchronised on both sides, into ``step_ms``."""
    for i, step in enumerate(pipe._device_steps):
        name = f"{i}:{type(step).__name__}"
        inner = step._process

        def process(data, inner=inner, name=name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(data)
            torch.cuda.synchronize()
            step_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            return out

        step._process = process


def serial_phase(batches: int) -> dict:
    pipe = build_pipeline(batch_size=8)
    step_ms: dict = {}
    host_ms, transfer_ms, device_ms = [], [], []
    for i in range(batches + 2):  # the first two warm up allocators and kernels
        t0 = time.perf_counter()
        batch_idx, host_batch = pipe._produce_host_batch()
        t1 = time.perf_counter()
        leaves = pipe._transfer(host_batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i == 2:
            timed_steps(pipe, step_ms)
        pipe.run_device_stage(leaves, batch_idx)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if i >= 2:
            host_ms.append((t1 - t0) * 1e3)
            transfer_ms.append((t2 - t1) * 1e3)
            device_ms.append((t3 - t2) * 1e3)
    pipe.stop()
    return {
        "host_stage_ms": float(np.median(host_ms)),
        "transfer_ms": float(np.median(transfer_ms)),
        "device_stage_ms": float(np.median(device_ms)),
        "device_steps_ms": {k: float(np.median(v)) for k, v in step_ms.items()},
        "bytes_per_batch": int(sum(a.nbytes for a in host_batch)),
    }


def pipelined_phase(batches: int):
    from torch.profiler import ProfilerActivity, profile

    pipe = build_pipeline(batch_size=8)
    for _ in range(3):
        pipe.run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            pipe.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = pipe.stats()
    pipe.stop()
    from torch.autograd import DeviceType

    # device events only: the host-side operator rows carry their kernels'
    # time as well, and would count it twice
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in rows)
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top = [{"name": e.key[:80], "calls": e.count,
            "device_ms_per_batch": e.self_device_time_total / 1e3 / batches} for e in rows[:15]]
    return {
        "frames_per_s": batches * 8 * 6 / wall,
        "ms_per_batch": wall / batches * 1e3,
        "device_busy_share": device_us / 1e6 / wall,
        "device_ms_per_batch": device_us / 1e3 / batches,
        "consumer_wait_s": stats["consumer_wait_s"],
        "device_stage_s": stats["device_stage_s"],
        "producer_busy_s": stats["producer_busy_s"],
        "input_bound_frac": stats["input_bound_frac"],
        "note": "under the profiler",
    }, top


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = {"card": smi, "cpu_count": os.cpu_count()}
    emit({"phase": "serial", **card, **serial_phase(args.batches)})
    pipelined, top = pipelined_phase(args.batches)
    emit({"phase": "pipelined", **card, **pipelined})
    emit({"phase": "top_device_ops", **card, "ops": top})
    return 0


if __name__ == "__main__":
    sys.exit(main())
