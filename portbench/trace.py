"""What a traced run reads from ``torch.profiler``: the device rows and the
harness's own host spans of a short steady stretch.

``device_rows`` are the operations that ran on the card (kernels, copies,
sets), with their start and duration in seconds. ``busy_s`` is the length
of their union inside the stretch, ``window_s`` the stretch's length; the
idle gaps are named by the host span that was open when the card fell idle.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

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


def innermost(ranges: List[Row], t: float) -> Optional[str]:
    """The name of the shortest of ``ranges`` (name, start s, duration s)
    open at ``t``."""
    open_ = [r for r in ranges if r[1] <= t < r[1] + r[2]]
    return min(open_, key=lambda r: r[2])[0] if open_ else None


def summarize(device: List[Row], host: List[Row], lo: float, hi: float,
              ranges: Sequence[dict] = ()) -> Dict:
    """Busy time, the top device operations and the longest idle gaps of
    ``[lo, hi]``; a gap is named by the innermost of the harness's spans
    (``host``) and the program's ``ranges`` (``phases.spans``) open at its
    start, ``outside_steps`` when none is."""
    merged = union(device, lo, hi)
    busy = sum(b - a for a, b in merged)
    opened = [h for h in host if h[0] != "window"] + [
        (r["name"], r["start"], r["dur"]) for r in ranges]
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = [[innermost(opened, a) or "outside_steps", b - a]
            for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps.sort(key=lambda g: -g[1])
    totals: Dict[str, float] = {}
    for name, s, d in device:
        if s + d > lo and s < hi:
            totals[name] = totals.get(name, 0.0) + d
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": hi - lo, "device_ops": [[n, v] for n, v in top],
            "idle_gaps": gaps[:10], "rows": device}
