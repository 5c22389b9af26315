"""Batched polyline interpolation on the port, over bench_polyline's grid.

The counterpart of ``scripts/bench_polyline.py``: batch (1, 64) x points
(10, 100, 1000) x distances (10, 100, 1000), the same cases from the same
seeds (:func:`make_case`), against the same float64 numpy host baseline (a
cumulative-length + searchsorted + lerp restatement, :func:`numpy_interpolate`).

The port's ``interpolate`` (relative distances) is timed on the card with
CUDA events: K calls chained through the previous output, as the JAX script
chains them in a ``lax.scan`` (each call's distances are ``clamp(r0 +
1e-6 * mean(previous output), 0, 1)``, so the calls serialise), ms per call
of a chain of K, the median of ``--reps`` chains. Launches per call are
counted with ``torch.profiler`` after warm-up steps
(``accvlab_tpu_torch.tools.launch_counts``). One JSON line per case, then the card's
``nvidia-smi`` name and power limit.

Usage: python3 scripts/torch_bench_polyline.py [--k 64] [--reps 5]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GRID_POINTS = (10, 100, 1000)
GRID_DISTS = (10, 100, 1000)
GRID_BATCH = (1, 64)


def make_case(batch, n_points, n_dists, seed):
    """bench_polyline's case: a random walk of ``n_points`` 2-D points per
    polyline and ``n_dists`` relative distances in [0, 1)."""
    rng = np.random.default_rng(seed)
    pts = np.cumsum(rng.uniform(-1, 1, (batch, n_points, 2)), axis=1).astype(np.float32)
    rel = rng.uniform(0, 1, (batch, n_dists)).astype(np.float32)
    return pts, rel


def cases():
    """Every grid case as ``((batch, points, dists), (pts, rel))``, with
    bench_polyline's seeds."""
    for batch in GRID_BATCH:
        for n_points in GRID_POINTS:
            for n_dists in GRID_DISTS:
                yield (batch, n_points, n_dists), make_case(batch, n_points, n_dists,
                                                            seed=batch * 7 + n_points)


def numpy_interpolate(points, distances):
    """float64 numpy: cumulative segment lengths, searchsorted, lerp
    (absolute distances, clamped to the polyline)."""
    pts = np.asarray(points, np.float64)
    d = np.asarray(distances, np.float64)
    seg = np.linalg.norm(np.diff(pts, axis=1), axis=2)  # (B, N-1)
    cum = np.concatenate([np.zeros((pts.shape[0], 1)), np.cumsum(seg, axis=1)], axis=1)
    total = cum[:, -1]
    dc = np.clip(d, 0.0, total[:, None])
    out = np.empty((pts.shape[0], d.shape[1], pts.shape[2]), np.float64)
    for s in range(pts.shape[0]):
        i = np.clip(np.searchsorted(cum[s, 1:], dc[s], side="left"), 0, seg.shape[1] - 1)
        seg_i = seg[s, i]
        frac = np.where(seg_i > 0, (dc[s] - cum[s, i]) / np.where(seg_i > 0, seg_i, 1.0), 0.0)
        out[s] = pts[s, i] + frac[:, None] * (pts[s, i + 1] - pts[s, i])
    return out


def numpy_relative(points, rel):
    """:func:`numpy_interpolate` at ``rel`` times each polyline's length."""
    seg = np.linalg.norm(np.diff(np.asarray(points, np.float64), axis=1), axis=2)
    return numpy_interpolate(points, np.asarray(rel, np.float64) * seg.sum(axis=1)[:, None])


def numpy_ms(pts, rel, budget_s=1.0):
    """Host ms per call of :func:`numpy_relative` (the mean over a budget)."""
    numpy_relative(pts, rel)  # warm
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < budget_s and n < 200:
        numpy_relative(pts, rel)
        n += 1
    return (time.perf_counter() - t0) / n * 1e3


def chained_ms(pts, rel, k: int, reps: int) -> float:
    """Device ms per call of ``interpolate`` on CUDA tensors, ``k`` calls
    chained through the previous output (CUDA events; median of ``reps``)."""
    import torch

    from accvlab_tpu_torch.polyline import interpolate

    p, r0 = pts, rel

    def chain(n):
        carry = torch.zeros((), dtype=torch.float32, device=p.device)
        for _ in range(n):
            r = torch.clamp(r0 + carry * 1e-6, 0.0, 1.0)
            carry = interpolate(p, r, relative=True).mean()
        return carry

    chain(2)
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        chain(k)
        e1.record()
        e1.synchronize()
        samples.append(e0.elapsed_time(e1) / k)
    return float(np.median(samples))


def launches_per_call(pts, rel) -> int:
    """Device kernels, memsets and copies of one ``interpolate`` call
    (the median of ``launch_counts.kernel_counts``' readings)."""
    from accvlab_tpu_torch.polyline import interpolate
    from accvlab_tpu_torch.tools.launch_counts import kernel_counts, launches

    return launches(kernel_counts(lambda: interpolate(pts, rel, relative=True)))


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_bench_polyline: needs a CUDA device")
    dev = torch.device("cuda")
    for (batch, n_points, n_dists), (pts, rel) in cases():
        p, r = torch.from_numpy(pts).to(dev), torch.from_numpy(rel).to(dev)
        t_port = chained_ms(p, r, args.k, args.reps)
        t_np = numpy_ms(pts, rel)
        print(json.dumps({"batch": batch, "points": n_points, "dists": n_dists,
                          "port_ms": t_port, "numpy_ms": t_np,
                          "vs_numpy": t_np / t_port if t_port > 0 else None,
                          "launches_per_call": launches_per_call(p, r)}), flush=True)
    print(nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
