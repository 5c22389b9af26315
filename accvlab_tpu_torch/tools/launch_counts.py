"""Device launches of a callable, counted with ``torch.profiler`` on the card.

:func:`kernel_counts` is the launch count that ``chip_smoke.py``'s phase
lines and ``scripts/torch_bench_polyline.py`` report. It needs a CUDA device.
"""

from __future__ import annotations

import time

WARMUP = 3  # traced and discarded steps before each counted one
READINGS = 3  # readings per call; the median is kept
GAP_S = 0.05  # idle host time on each side of the counted step's window edges


def launches(counts: dict) -> int:
    """Kernels, memsets and copies of one reading."""
    return counts["kernels"] + counts["memsets"] + counts["copies"]


def median_reading(readings: list[dict]) -> dict:
    """The reading whose launch total is the median of the readings, with
    every reading's total under ``"readings"``. Of three readings it is the
    one that two agree on, where two do; a reading too high or too low is
    dropped and still shows in the spread."""
    chosen = sorted(readings, key=launches)[len(readings) // 2]
    return {**chosen, "readings": [launches(r) for r in readings]}


def kernel_counts(fn) -> dict:
    """``fn()`` under torch.profiler: its device kernels, memsets and
    copies, counted from the profiler's CUDA rows, and ``busy_ms``, the sum
    of their device times (gaps between them left out).

    Kineto keeps only the device records whose timestamps, on the host's
    clock, fall inside the counted step's window. Without room at the
    window's edges the readings lost the first kernels of a step, or all of
    a short one, late in a long process: an offset of some milliseconds
    between the card's timestamps and the host's would do that. So the
    counted step starts ``GAP_S`` after its window opens and after the last
    discarded step ends, and the window closes ``GAP_S`` after it. Each
    reading traces ``WARMUP`` discarded steps before the counted one, and
    :func:`median_reading` of ``READINGS`` readings is kept (``fn`` runs
    ``READINGS * (WARMUP + 1)`` times)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def reading():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=WARMUP, active=1, repeat=1)) as prof:
            for i in range(WARMUP + 1):
                if i == WARMUP:
                    time.sleep(GAP_S)
                fn()
                torch.cuda.synchronize()
                if i >= WARMUP - 1:
                    time.sleep(GAP_S)
                prof.step()
        counts = {"kernels": 0, "memsets": 0, "copies": 0, "busy_ms": 0.0}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            kind = ("copies" if e.key.startswith("Memcpy") else
                    "memsets" if e.key.startswith("Memset") else "kernels")
            counts[kind] += e.count
            counts["busy_ms"] += e.self_device_time_total / 1e3
        return counts

    return median_reading([reading() for _ in range(READINGS)])
