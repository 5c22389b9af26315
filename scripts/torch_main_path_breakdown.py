"""Where the PyTorch port's headline pipeline spends its time, on one CUDA card.

Run from the repository root:
  python3 scripts/torch_main_path_breakdown.py [--wire dct|yuv|frames] [--batches N]
      [--decoder native|pil] [--grouping dp16] [--packer-threads N]

Builds bench.py's multi-camera pipeline on the port
(``accvlab_tpu_torch.bench_pipeline``: 6 x 372x1024, batch 8, out 256x704,
heatmap 10x64x176) on the DCT wire (the default: q90 JPEGs entropy-decoded
on the host, their quantized coefficients packed in ``--grouping``, unpack +
IDCT + resize + colour conversion on the card), on the YUV 4:2:0 wire (the
JPEGs decoded on the host by ``--decoder``, libjpeg at its DCT scale by
default, the plane codec, unpack + colour conversion on the card) or on raw
RGB frames, and prints JSON lines:

* ``serial``: each phase of one batch run alone, one after the other, with a
  synchronise after each, on the host clock (median over ``--batches``):
  host stage (input callable, host steps and stacking, on the worker pool),
  with the image decoder's time summed over its calls and the packer's
  time (on the DCT wire also the packer's entropy decode, analyze and pack,
  each summed over the batch's images: ``dct_packer_ms_summed_over_images``);
  transfer (pack into pinned memory + host-to-device copy); every
  device step on the host clock (``device_steps_ms``) and its device time
  (``device_steps_device_ms``: CUDA events with the stream held by a sleep
  while the host enqueues the step, so the events see the device work
  only; a step with a blocking host-to-card copy still lets the host's
  enqueue after that copy into the reading);
* ``pipelined``: the prefetching ``run()`` loop as a user drives it, frames/s
  and ms per batch, with the device's busy share over the same window from
  ``torch.profiler`` (sum of kernel and copy time over wall time); and under
  ``unprofiled`` the same loop run just before without the profiler, with
  the consumer thread's transfer + enqueue time per batch;
* ``top_device_ops``: the device operations that take the most time in the
  pipelined window.

``--num-threads`` sets the host stage's worker threads (default: the core
count). ``--packer-threads`` sets the DCT packer's own pool (default
``min(4, cores)``). ``--switch-interval`` sets how long a thread that wants
the interpreter lock waits before it asks the holder to drop it (Python's
default 5 ms). They probe why the consumer thread's enqueue slows down
while the host stage decodes and packs.

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
from accvlab_tpu_torch.pipeline.processing_steps import DCTWirePacker  # noqa: E402


# about 50 ms of the card's clock: longer than the host takes to enqueue any step
SLEEP_CYCLES = 100_000_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def wrap(step, attr: str, record) -> None:
    """Replace ``step.<attr>`` by a wrapper that calls ``record(inner, *args)``."""
    inner = getattr(step, attr)
    setattr(step, attr, lambda *a: record(inner, *a))


def step_clock(name: str, clock: dict, host_ms: dict, device_ms: dict):
    """``record`` for :func:`wrap` of a device step. With ``clock["mode"]``
    "host": the call's host-clock ms, synchronised on both sides, into
    ``host_ms[name]``; "device": its device ms (CUDA events, the stream held
    by a sleep while the host enqueues), into ``device_ms[name]``."""
    def record(inner, *a):
        torch.cuda.synchronize()
        if clock["mode"] == "host":
            t0 = time.perf_counter()
            out = inner(*a)
            torch.cuda.synchronize()
            host_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            return out
        torch.cuda._sleep(SLEEP_CYCLES)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = inner(*a)
        e1.record()
        torch.cuda.synchronize()
        device_ms.setdefault(name, []).append(e0.elapsed_time(e1))
        return out
    return record


def per_call(name: str, into: dict):
    """``record`` for :func:`wrap` of a host step: each call's host-clock ms
    appended to ``into[name]`` (calls run on the worker pool)."""
    def record(inner, *a):
        t0 = time.perf_counter()
        out = inner(*a)
        into.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out
    return record


def build(wire: str, num_threads, decoder: str, grouping: str, packer_threads):
    """bench.py's pipeline at full width on the card, with the DCT packer's
    pool set to ``packer_threads`` when given."""
    pipe = build_pipeline(batch_size=8, wire=wire, num_threads=num_threads, decoder=decoder,
                          grouping=grouping)
    if packer_threads is not None:
        for step in pipe._host_steps:
            if isinstance(step, DCTWirePacker):
                step._num_threads = packer_threads
    return pipe


def serial_phase(batches: int, wire: str, num_threads, decoder: str, grouping: str,
                 packer_threads) -> dict:
    pipe = build(wire, num_threads, decoder, grouping, packer_threads)
    clock = {"mode": "host"}
    step_ms: dict = {}
    step_dev_ms: dict = {}
    host_calls: dict = {}
    for step in pipe._host_steps:
        wrap(step, "_process_batch" if step.is_batch_level else "_process",
             per_call(type(step).__name__, host_calls))
    host_ms, transfer_ms, device_ms, host_steps, dct_parts = [], [], [], {}, []
    dct_packers = [s for s in pipe._host_steps if isinstance(s, DCTWirePacker)]
    for i in range(batches + 2):  # the first two warm up allocators and kernels
        host_calls.clear()
        t0 = time.perf_counter()
        batch_idx, _, _, host_batch = pipe._produce_host_batch()
        t1 = time.perf_counter()
        leaves = pipe._transfer(host_batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i == 2:
            for j, step in enumerate(pipe._device_steps):
                wrap(step, "_process",
                     step_clock(f"{j}:{type(step).__name__}", clock, step_ms, step_dev_ms))
        clock["mode"] = "host"
        pipe.run_device_stage(leaves, batch_idx)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if i >= 2:
            clock["mode"] = "device"
            pipe.run_device_stage(leaves, batch_idx)
            host_ms.append((t1 - t0) * 1e3)
            transfer_ms.append((t2 - t1) * 1e3)
            device_ms.append((t3 - t2) * 1e3)
            for k, v in host_calls.items():
                host_steps.setdefault(k, []).append((sum(v), len(v)))
            dct_parts += [p.last_batch_seconds for p in dct_packers]
    pipe.stop()
    return {
        "wire": wire,
        "host_stage_ms": float(np.median(host_ms)),
        "host_steps_ms_summed_over_calls": {k: float(np.median([ms for ms, _ in v]))
                                            for k, v in host_steps.items()},
        "host_steps_calls_per_batch": {k: v[0][1] for k, v in host_steps.items()},
        "transfer_ms": float(np.median(transfer_ms)),
        "device_stage_ms": float(np.median(device_ms)),
        "device_steps_ms": {k: float(np.median(v)) for k, v in step_ms.items()},
        "device_steps_device_ms": {k: float(np.median(v)) for k, v in step_dev_ms.items()},
        "bytes_per_batch": int(sum(a.nbytes for a in host_batch)),
        **({"dct_packer_ms_summed_over_images": {
            k: float(np.median([p[k] for p in dct_parts])) * 1e3
            for k in ("entropy_decode", "analyze", "pack")},
            "dct_images_per_batch": dct_parts[0]["images"],
            "dct_grouping": [list(g) for g in dct_packers[0].groups]} if dct_parts else {}),
    }


def pipelined_phase(batches: int, wire: str, num_threads, decoder: str, grouping: str,
                    packer_threads):
    from torch.profiler import ProfilerActivity, profile

    pipe = build(wire, num_threads, decoder, grouping, packer_threads)
    for _ in range(3):
        pipe.run()
    torch.cuda.synchronize()
    # the same loop without the profiler first: its wall time and the
    # consumer's share of it (transfer + enqueue of the device steps)
    before = pipe.stats()
    t0 = time.perf_counter()
    for _ in range(batches):
        pipe.run()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    after = pipe.stats()
    unprofiled = {
        "frames_per_s": batches * 8 * 6 / plain_wall,
        "ms_per_batch": plain_wall / batches * 1e3,
        "consumer_device_stage_ms_per_batch":
            (after["device_stage_s"] - before["device_stage_s"]) / batches * 1e3,
        "consumer_wait_ms_per_batch":
            (after["consumer_wait_s"] - before["consumer_wait_s"]) / batches * 1e3,
        "producer_busy_ms_per_batch":
            (after["producer_busy_s"] - before["producer_busy_s"]) / batches * 1e3,
    }
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
        "wire": wire,
        "frames_per_s": batches * 8 * 6 / wall,
        "ms_per_batch": wall / batches * 1e3,
        "device_busy_share": device_us / 1e6 / wall,
        "device_ms_per_batch": device_us / 1e3 / batches,
        "consumer_wait_s": stats["consumer_wait_s"],
        "device_stage_s": stats["device_stage_s"],
        "producer_busy_s": stats["producer_busy_s"],
        "input_bound_frac": stats["input_bound_frac"],
        "note": "under the profiler",
        "unprofiled": unprofiled,
    }, top


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--wire", choices=("dct", "yuv", "frames"), default="dct")
    ap.add_argument("--grouping", default="dp16",
                    help="the DCT wire's band grouping (build_pipeline(grouping=))")
    ap.add_argument("--decoder", choices=("native", "pil"), default="native",
                    help="the YUV wire's host decoder (ImageDecoder(decoder=))")
    ap.add_argument("--num-threads", type=int, default=None,
                    help="host-stage worker threads (build_pipeline's default: the core count)")
    ap.add_argument("--packer-threads", type=int, default=None,
                    help="the DCT packer's own pool (DCTWirePacker's default: min(4, cores))")
    ap.add_argument("--switch-interval", type=float, default=None,
                    help="sys.setswitchinterval in seconds for the run (Python's default: 0.005)")
    args = ap.parse_args()
    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = {"card": smi, "cpu_count": os.cpu_count(), "switch_interval_s": sys.getswitchinterval(),
            "num_threads": args.num_threads,
            "decoder": args.decoder if args.wire == "yuv" else None,
            "grouping": args.grouping if args.wire == "dct" else None,
            "packer_threads": args.packer_threads}
    emit({"phase": "serial", **card, **serial_phase(args.batches, args.wire, args.num_threads,
                                                   args.decoder, args.grouping,
                                                   args.packer_threads)})
    pipelined, top = pipelined_phase(args.batches, args.wire, args.num_threads,
                                     args.decoder, args.grouping, args.packer_threads)
    emit({"phase": "pipelined", **card, **pipelined})
    emit({"phase": "top_device_ops", **card, "ops": top})
    return 0


if __name__ == "__main__":
    sys.exit(main())
