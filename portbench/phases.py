"""The program's own phases in a profiled stretch of a cell: its
``accvlab.*`` ranges, the host calls that wait for the card, and the idle
gaps named by the innermost range open.

The port opens a ``torch.profiler`` range at each phase boundary of its
executor (``accvlab.pipeline.*``), of ``batch_to_train_inputs`` and of the
training step (``accvlab.train_step.*``) while a profiler records.
:func:`spans` reads them from a finished profiler of host and device
activities: each range's host interval, its arguments (kept when the
profiler records shapes) and the device time of the rows launched inside
it (the event's ``device_time_total``, which takes in a CUDA graph's
kernels through their launch). A program that opens no range gives none,
and the readers of them give nothing.

    python3 -m portbench.phases --workload <name> --seed <n>

runs a cell as ``portbench.run`` sets it up, then stretches of
``breakdown_steps`` steps, each closed by a synchronize: :data:`UNTRACED`
of them, one profiled on the host and the card (with the harness's own
``portbench.*`` ranges), and :data:`UNTRACED` more; it prints one JSON line: the six per-layer readings of ``metrics/`` that read
these spans and the pipeline's counters over the untraced stretches, the
traced stretch's time per step against the untraced ones, the idle gaps
named both ways, and the waiting calls grouped by their innermost range.
It reads the program; the cell's benchmark runs (``portbench.run``) do not
call it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import sys
import time
from typing import Dict, List, Optional

from . import trace as tracing

PREFIX = "accvlab."
#: the CUDA runtime calls that return only once the card has caught up
BLOCKING = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
            "cudaMemcpy", "cudaFree", "cudaFreeHost", "cudaHostAlloc", "cudaMallocHost")
#: the per-layer metrics that read :func:`spans` and the pipeline's counters
READERS = ("dispatch_ms.frames", "transfer_host_ms.frames", "stage_device_ms.frames",
           "loss_device_ms.centernet", "optimizer_device_ms.centernet", "host_blocked_ms")
#: the pipeline's counters that those read, with ``consumed``
COUNTERS = ("consumed", "device_stage_s", "transfers", "transfer_s")
#: the untraced stretches before the profiled one, and after it
UNTRACED = 3


def blocking_name(name: str) -> Optional[str]:
    """``name`` without a runtime call's version or per-thread suffix when
    it is one of :data:`BLOCKING`, else ``None``."""
    base = re.sub(r"(_v\d+)?(_pt(sz|ds))?$", "", name)
    return base if base in BLOCKING else None


def innermost(ranges: List[tuple], t: float) -> Optional[str]:
    """The name of the shortest of ``ranges`` (name, start s, duration s)
    open at ``t``."""
    open_ = [r for r in ranges if r[1] <= t < r[1] + r[2]]
    return min(open_, key=lambda r: r[2])[0] if open_ else None


def spans(prof, lo: float, hi: float, steps: int) -> Dict:
    """The program's ranges and the waiting calls of a finished profiler
    inside ``[lo, hi]`` (seconds on the profiler's clock): ``{"steps",
    "ranges": [{name, start, dur, args, device_s}], "blocking": [{name,
    start, dur, range}]}``. A range's name drops ``accvlab.``; a call's
    range is the innermost open among the program's and the harness's
    (``portbench.*``, without the prefix), ``None`` when none is."""
    import torch

    ranges, calls, harness = [], [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        start = e.time_range.start * 1e-6
        dur = (e.time_range.end - e.time_range.start) * 1e-6
        if not lo <= start < hi:
            continue
        if e.name.startswith(PREFIX):
            ranges.append({"name": e.name[len(PREFIX):], "start": start, "dur": dur,
                           "args": dict(getattr(e, "kwinputs", None) or {}),
                           "device_s": e.device_time_total * 1e-6})
        elif e.name.startswith("portbench."):
            harness.append((e.name[len("portbench."):], start, dur))
        elif blocking_name(e.name):
            calls.append({"name": blocking_name(e.name), "start": start, "dur": dur})
    opened = [(r["name"], r["start"], r["dur"]) for r in ranges] + harness
    for c in calls:
        c["range"] = innermost(opened, c["start"])
    ranges.sort(key=lambda r: r["start"])
    return {"steps": steps, "ranges": ranges, "blocking": calls}


def idle_gaps(device: List[tuple], host: List[tuple], ranges: List[dict], lo: float,
              hi: float, top: int = 10) -> List[list]:
    """``tracing.summarize``'s idle gaps, the same gaps of the same lengths,
    named by the innermost range open at the gap's start among the
    harness's spans (``host``, from ``tracing.profile_rows``) and the
    program's ``ranges`` (:func:`spans`); ``outside_steps`` when none is."""
    merged = tracing.union(device, lo, hi)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    opened = [h for h in host if h[0] != "window"] + [
        (r["name"], r["start"], r["dur"]) for r in ranges]
    gaps = [[innermost(opened, a) or "outside_steps", b - a]
            for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps.sort(key=lambda g: -g[1])
    return gaps[:top]


def blocking_summary(blocking: List[dict]) -> List[dict]:
    """The waiting calls grouped by call and innermost range: count, total
    and longest ms, the largest total first."""
    groups: Dict[tuple, list] = {}
    for c in blocking:
        groups.setdefault((c["name"], c["range"]), []).append(c["dur"])
    out = [{"call": k[0], "range": k[1], "count": len(v), "total_ms": 1e3 * sum(v),
            "max_ms": 1e3 * max(v)} for k, v in groups.items()]
    return sorted(out, key=lambda g: -g["total_ms"])


def run_phases(cell, seed: int, device, untraced: int = UNTRACED) -> dict:
    """Set up ``cell`` as ``portbench.run`` does (inputs, weights, pipeline,
    network, its checked and warm-up steps), then run ``untraced``
    stretches, the profiled one, and ``untraced`` more: the line
    :func:`main` prints."""
    import torch

    from . import data, program, run
    from .reference.centernet import leaf_specs
    from .reference.layers import make_leaves
    from .spec import load_reader

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device.type == "cuda"
    cfg, tr = cell.config, cell.traffic
    inputs = data.make_inputs(seed, cfg, tr)
    weights = make_leaves(leaf_specs(cfg), run.weight_generator(seed, device), device)
    feed = program.Feed(cfg, tr, inputs, seed, device, None)
    step = program.Step(cfg, weights, device, None)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def steps(n: int, span=None) -> float:
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            with span("portbench.feed") if span else contextlib.nullcontext():
                out = feed.next()
            with span("portbench.train_step") if span else contextlib.nullcontext():
                step(out)
        sync()
        return (time.perf_counter() - t0) * 1e3 / n

    n = int(tr["breakdown_steps"])
    try:
        steps(run.CHECKED_STEPS + int(tr["warmup_steps"]))
        counters0 = feed.stats()
        before = [steps(n) for _ in range(untraced)]
        counters1 = feed.stats()
        acts = [torch.profiler.ProfilerActivity.CPU]
        acts += [torch.profiler.ProfilerActivity.CUDA] if cuda else []
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("portbench.window"):
                traced = steps(n, torch.profiler.record_function)
        counters2 = feed.stats()
        after = [steps(n) for _ in range(untraced)]
        counters3 = feed.stats()
    finally:
        feed.close()
        step.close()

    device_rows, host = tracing.profile_rows(prof)
    win = [h for h in host if h[0] == "window"]
    lo, hi = (win[0][1], win[0][1] + win[0][2]) if win else (0.0, 0.0)
    ctx = {"pipeline": {k: (counters1.get(k, 0) - counters0.get(k, 0))
                        + (counters3.get(k, 0) - counters2.get(k, 0)) for k in COUNTERS
                        if k in counters0},
           "spans": spans(prof, lo, hi, n)}
    readings = {}
    for name in READERS:
        value = load_reader(name)(ctx)
        if value is not None:
            readings[name] = value
    ranges = ctx["spans"]["ranges"]
    return {
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "readings": readings,
        "untraced_ms_per_step": before + after,
        "traced_ms_per_step": traced,
        "range_counts": {name: sum(1 for r in ranges if r["name"] == name)
                         for name in sorted({r["name"] for r in ranges})},
        "device_rows_named_accvlab": sum(1 for r in device_rows if r[0].startswith(PREFIX)),
        "idle_gaps": tracing.summarize(device_rows, host, lo, hi)["idle_gaps"],
        "idle_gaps_by_phase": idle_gaps(device_rows, host, ranges, lo, hi),
        "blocking": blocking_summary([c for c in ctx["spans"]["blocking"]
                                      if c["range"] not in (None, "window")]),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)

    from . import run

    run.set_cache_dirs()
    import torch

    from .spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"portbench.phases: {args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line = run_phases(cell, args.seed, device)
    for g in line["blocking"]:
        print(f"blocking {g['call']} in {g['range']}: {g['count']} calls, "
              f"{g['total_ms']:.3f} ms", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
