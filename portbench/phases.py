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
``portbench.*`` ranges), and :data:`UNTRACED` more; it prints one JSON
line: the readings of the cell's per-layer metrics that find something in
these spans and the program's counters, taken over the untraced stretches
(:func:`readings`), the traced stretch's time per step against the
untraced ones, the idle gaps named both ways, and the waiting calls
grouped by their innermost range. A traced run of ``portbench.run`` reads
the same metrics from its own host-traced stretch and window.
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
#: the untraced stretches before the profiled one, and after it
UNTRACED = 3


def blocking_name(name: str) -> Optional[str]:
    """``name`` without a runtime call's version or per-thread suffix when
    it is one of :data:`BLOCKING`, else ``None``."""
    base = re.sub(r"(_v\d+)?(_pt(sz|ds))?$", "", name)
    return base if base in BLOCKING else None


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
        c["range"] = tracing.innermost(opened, c["start"])
    ranges.sort(key=lambda r: r["start"])
    return {"steps": steps, "ranges": ranges, "blocking": calls}


def blocking_summary(blocking: List[dict]) -> List[dict]:
    """The waiting calls grouped by call and innermost range: count, total
    and longest ms, the largest total first."""
    groups: Dict[tuple, list] = {}
    for c in blocking:
        groups.setdefault((c["name"], c["range"]), []).append(c["dur"])
    out = [{"call": k[0], "range": k[1], "count": len(v), "total_ms": 1e3 * sum(v),
            "max_ms": 1e3 * max(v)} for k, v in groups.items()]
    return sorted(out, key=lambda g: -g["total_ms"])


def readings(cell, ctx: dict) -> Dict[str, float]:
    """The cell's per-layer metrics that find something in ``ctx``, by
    name. ``ctx`` has the keys of ``portbench.run``'s that the readers
    index, over the untraced stretches, but no device stretch (``profile``,
    ``peaks``) and no step events: their readers return ``None``, and a
    reader that raises is at fault."""
    values = {name: read(ctx) for name, read in cell.readers.items()}
    return {name: v for name, v in values.items() if v is not None}


def run_phases(cell, seed: int, device, untraced: int = UNTRACED) -> dict:
    """Set up ``cell`` as ``portbench.run`` does (inputs, weights, pipeline,
    network, its checked and warm-up steps), then run ``untraced``
    stretches, the profiled one, and ``untraced`` more: the line
    :func:`main` prints."""
    import torch
    from accvlab_tpu_torch.tools import program_cache_stats

    from . import run
    from .reference.layers import make_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device.type == "cuda"
    cfg, tr, fam = cell.config, cell.traffic, cell.family
    inputs = fam.make_inputs(seed, cfg, tr)
    weights = make_leaves(fam.leaf_specs(cfg), run.weight_generator(seed, device), device)
    feed = fam.Feed(cfg, tr, inputs, seed, device, None)
    step = fam.Step(cfg, weights, device, None)

    def counters():
        return feed.stats(), program_cache_stats()

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
        counters0 = counters()
        before = [steps(n) for _ in range(untraced)]
        counters1 = counters()
        acts = [torch.profiler.ProfilerActivity.CPU]
        acts += [torch.profiler.ProfilerActivity.CUDA] if cuda else []
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("portbench.window"):
                traced = steps(n, torch.profiler.record_function)
        counters2 = counters()
        after = [steps(n) for _ in range(untraced)]
        counters3 = counters()
    finally:
        feed.close()
        step.close()

    device_rows, host = tracing.profile_rows(prof)
    win = [h for h in host if h[0] == "window"]
    lo, hi = (win[0][1], win[0][1] + win[0][2]) if win else (0.0, 0.0)

    def untraced_change(i: int) -> dict:
        """Counter set ``i``'s change over the untraced stretches."""
        a = run.counter_change(counters0[i], counters1[i])
        b = run.counter_change(counters2[i], counters3[i])
        return {k: a[k] + b[k] for k in a}

    pipeline = untraced_change(0)
    ctx = {"config": cfg, "traffic": tr, "steps": 2 * untraced * n, "pipeline": pipeline,
           "pipeline_unprofiled": pipeline, "program_cache": untraced_change(1),
           "step_device_ms": [], "step_interval_ms": [], "spans": spans(prof, lo, hi, n)}
    ranges = ctx["spans"]["ranges"]
    return {
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "readings": readings(cell, ctx),
        "untraced_ms_per_step": before + after,
        "traced_ms_per_step": traced,
        "range_counts": {name: sum(1 for r in ranges if r["name"] == name)
                         for name in sorted({r["name"] for r in ranges})},
        "device_rows_named_accvlab": sum(1 for r in device_rows if r[0].startswith(PREFIX)),
        "idle_gaps": tracing.summarize(device_rows, host, lo, hi)["idle_gaps"],
        "idle_gaps_by_phase": tracing.summarize(device_rows, host, lo, hi, ranges)["idle_gaps"],
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
