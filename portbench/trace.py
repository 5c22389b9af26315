"""What a traced run reads from ``torch.profiler``: the device rows and the
harness's own host spans of a short steady stretch.

``device_rows`` are the operations that ran on the card (kernels, copies,
sets), with their start and duration in seconds. ``busy_s`` is the length
of their union inside the stretch, ``window_s`` the stretch's length; the
idle gaps are named by the host span that was open when the card fell idle.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

Row = Tuple[str, float, float]  # name, start s, duration s


def profile_rows(prof) -> Tuple[List[Row], List[Row]]:
    """``(device rows, host spans)`` of a finished profiler; the host spans
    are the ``portbench.*`` ranges."""
    import torch

    device, host = [], []
    for e in prof.events():
        start = e.time_range.start * 1e-6
        dur = (e.time_range.end - e.time_range.start) * 1e-6
        if e.name.startswith("portbench."):
            # the harness's ranges show on both timelines; only the host's is a span
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host.append((e.name[len("portbench."):], start, dur))
        elif e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            device.append((e.name, start, dur))
    return device, host


def union(rows: List[Row], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The merged intervals of ``rows`` clipped to ``[lo, hi]``."""
    spans = sorted((max(s, lo), min(s + d, hi)) for _, s, d in rows if s + d > lo and s < hi)
    merged: List[List[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(device: List[Row], host: List[Row], lo: float, hi: float) -> Dict:
    merged = union(device, lo, hi)
    busy = sum(b - a for a, b in merged)
    gaps = []
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            open_spans = [h for h in host if h[1] <= a < h[1] + h[2] and h[0] != "window"]
            name = min(open_spans, key=lambda h: h[2])[0] if open_spans else "outside_steps"
            gaps.append([name, b - a])
    gaps.sort(key=lambda g: -g[1])
    totals: Dict[str, float] = {}
    for name, s, d in device:
        if s + d > lo and s < hi:
            totals[name] = totals.get(name, 0.0) + d
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": hi - lo, "device_ops": [[n, v] for n, v in top],
            "idle_gaps": gaps[:10], "rows": device}
