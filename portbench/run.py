"""One run of one cell of ``BENCHMARK.json`` on the card.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): the inputs made
from ``--seed`` on the host, the weights on the card, the pipeline and the
training step built through the port's entry points, the first three steps
(the checked ones), then ``warmup_steps`` more, so that the executor has
traced and captured the cell's one batch spec and every kernel has run.
The window then runs steps for ``--seconds``; nothing is read back inside
it, and one ``torch.cuda.synchronize()`` closes it. ``--trace 1`` reports
the per-layer metrics instead of the end-to-end ones: its first
``breakdown_steps`` steps are profiled on the host and the card (the
breakdown: the top device operations, the idle gaps named by the innermost
of the program's ranges and the harness's spans; and the program's ranges,
``phases.spans``), the next ``profile_steps`` on the card alone (the
device's busy time and rows, and the time per step), and the steps after
both give each step's card time and the program's counters unslowed by the
profiler. After the window the reference checks the run (``check.py``) and
the last line of standard output is the result.

What the program is, and its plain reference, come from the family module
that the cell's configuration names (``families``); everything here holds
for every family.

``--control`` runs no program: it prints the numbers that the reference,
one precision step down, reads against the reference. ``--fault`` plants one
of the family's ``FAULTS``. Both serve to set the check's limits.

Without a card, or with fewer than the cell asks for, the run exits 2 and
prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: build and kernel caches, fixed inside the checkout
CACHE = os.path.join(ROOT, ".portbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "accvlab_tpu")
CHECKED_STEPS = 3


def set_cache_dirs() -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)


def forbidden_modules() -> list:
    """The top-level names in ``sys.modules`` that are JAX or its package."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def control(cell, seed: int, device) -> tuple:
    """The reference one precision step down against the reference, on the
    cell's checked batches and steps: ``(result, notes)``."""
    from . import check
    from .reference.layers import make_leaves

    cfg, tr, fam = cell.config, cell.traffic, cell.family
    inputs = fam.make_inputs(seed, cfg, tr)
    weights = make_leaves(fam.leaf_specs(cfg), weight_generator(seed, device), device)
    echo = int(tr.get("echo_factor", 1))
    sources = [(k // echo, k % echo if echo > 1 else None) for k in range(CHECKED_STEPS)]
    sound = [fam.reference_batch(inputs, cfg, seed, s, device) for s in sources]
    low = [fam.reference_batch(inputs, cfg, seed, s, device, low=True) for s in sources]
    ctl = fam.reference_steps(cfg, weights, low, True)
    ref = fam.reference_steps(cfg, weights, sound, False)
    values = check.numbers(ctl, ref, weights)
    values.pop("_worst")
    values.update(fam.pipeline_numbers([fam.flat(b) for b in low], sound, cfg))
    ok, shown, other = check.verdict(values, limits(cell))
    return {"correct": ok, "control": True, "check": shown}, {"not compared": other}


def counter_change(before: dict, after: dict) -> dict:
    """The change of each numeric counter of ``before`` in ``after``."""
    return {k: after[k] - v for k, v in before.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def limits(cell) -> dict:
    return {**cell.config.get("limits", {}), **cell.traffic.get("limits", {})}


def weight_generator(seed: int, device):
    import torch

    from . import data

    gen = torch.Generator(device=device)
    gen.manual_seed(data.seed63(seed, 3))
    return gen


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float,
             fault=None) -> tuple:
    """One run: ``(result, notes)``, the result's fields (``check`` last) and
    what goes to standard error only (the modules of JAX found once the
    window closed, the worst leaves, the numbers not compared)."""
    import numpy as np
    import torch

    from . import check, flops, phases
    from . import trace as tracing
    from .reference.layers import make_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device.type == "cuda"
    cfg, tr, fam = cell.config, cell.traffic, cell.family

    marks = [("imports", time.perf_counter())]
    inputs = fam.make_inputs(seed, cfg, tr)
    weights = make_leaves(fam.leaf_specs(cfg), weight_generator(seed, device), device)
    marks.append(("inputs and weights", time.perf_counter()))
    feed = fam.Feed(cfg, tr, inputs, seed, device, fault)
    marks.append(("pipeline", time.perf_counter()))
    step = fam.Step(cfg, weights, device, fault)
    marks.append(("model", time.perf_counter()))

    # the checked steps: the window's own call and feed
    prog = {"losses": []}
    checked_outs = []
    for k in range(CHECKED_STEPS):
        out = feed.next()
        checked_outs.append(out)
        prog["losses"].append(step(out))
        if k == 0:
            prog["grads"] = step.first_grads()
    prog["params"] = step.params()
    marks.append(("checked steps", time.perf_counter()))
    for _ in range(int(tr["warmup_steps"])):
        step(feed.next())
    if cuda:
        torch.cuda.synchronize(device)
    marks.append(("warm-up steps", time.perf_counter()))
    last = t0
    for name, t in marks:
        print(f"setup {name}: {t - last:.3f} s", file=sys.stderr)
        last = t

    def event():
        ev = torch.cuda.Event(enable_timing=True) if cuda else None
        if ev is not None:
            ev.record()
        return ev

    rng = np.random.default_rng([seed, 5])
    keep = {0, int(rng.integers(1, 64))}
    kept = {}
    # traced: a breakdown stretch (host ops and device rows, which the host
    # side of the profiler slows), then a device stretch (device rows only)
    stretches = []
    if trace:
        n = int(tr["breakdown_steps"])
        stretches = [(0, n, True), (n, n + int(tr["profile_steps"]), False)]
    profiled = stretches[-1][1] if stretches else 0
    profs, prof = [], None
    starts, ends, losses = [], [], []
    stats0 = feed.stats()
    from accvlab_tpu_torch.tools import program_cache_stats

    cache0 = program_cache_stats()
    span = (torch.profiler.record_function if trace else
            (lambda name: contextlib.nullcontext()))
    t_start = time.perf_counter()
    setup_s = t_start - t0
    k = 0
    while True:
        for first, last, host_side in stretches:
            if k == first:
                acts = [torch.profiler.ProfilerActivity.CUDA] if cuda else []
                acts += [torch.profiler.ProfilerActivity.CPU] if host_side or not cuda else []
                prof = torch.profiler.profile(activities=acts)
                prof.start()
                window_span = torch.profiler.record_function("portbench.window")
                window_span.__enter__()
        with span("portbench.feed"):
            out = feed.next()
        if k in keep:
            kept[k] = (feed.count - 1, out)
        if trace:
            starts.append(event())
        with span("portbench.train_step"):
            losses.append(step(out))
        if trace:
            ends.append(event())
        k += 1
        for first, last, host_side in stretches:
            if k == last:
                if cuda:
                    torch.cuda.synchronize(device)
                window_span.__exit__(None, None, None)
                prof.stop()
                profs.append((prof, last - first, host_side))
        if trace and k == profiled:
            stats_unprofiled = feed.stats()
        # at least one step after the profiled stretches, for the readers of those
        if time.perf_counter() - t_start >= seconds and k > profiled:
            break
    if cuda:
        torch.cuda.synchronize(device)
    t_end = time.perf_counter()
    steps = k
    leftover = forbidden_modules()
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    stats1 = feed.stats()
    cache1 = program_cache_stats()
    failed = sum(1 for x in losses if not math.isfinite(float(x)))
    prog["losses"] = [float(x) for x in prog["losses"]]
    intervals, device_ms = [], []
    if cuda and trace:
        intervals = [a.elapsed_time(b) for a, b in zip(ends[:-1], ends[1:])]
        # the steps after the profiled stretches, which the profiler slows
        device_ms = [a.elapsed_time(b) for a, b in zip(starts[profiled:], ends[profiled:])]
    window_s = t_end - t_start

    ctx = {"config": cfg, "traffic": tr, "steps": steps, "window_s": window_s,
           "step_device_ms": device_ms,
           # the intervals that end after the profiled stretches, none spanning their close
           "step_interval_ms": intervals[profiled:],
           "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu"}
    # every counter of the program's, as its change over the window
    ctx["pipeline"] = counter_change(stats0, stats1)
    ctx["program_cache"] = counter_change(cache0, cache1)
    if trace:
        # and from the profiled stretches' close, over the steps of step_device_ms
        ctx["pipeline_unprofiled"] = counter_change(stats_unprofiled, stats1)
    ctx["peaks"] = flops.peaks(ctx["device_kind"])
    ctx["step_flops"] = fam.step_flops(cfg)
    breakdown = None
    for prof, n, host_side in profs:
        rows, host = tracing.profile_rows(prof)
        if host_side:
            win = [h for h in host if h[0] == "window"]
            lo, hi = (win[0][1], win[0][1] + win[0][2]) if win else (0.0, 0.0)
            ctx["spans"] = phases.spans(prof, lo, hi, n)
            summary = tracing.summarize(rows, host, lo, hi, ctx["spans"]["ranges"])
            breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
        else:
            # the device stretch: from its first device row to its last
            lo = min((s for _, s, _ in rows), default=0.0)
            hi = max((s + d for _, s, d in rows), default=0.0)
            ctx["profile"] = {**tracing.summarize(rows, [], lo, hi), "steps": n}

    # the program's state goes before the reference runs
    checked_src = [feed.source(k2) for k2 in range(CHECKED_STEPS)]
    window_outs = [o for _, (_, o) in sorted(kept.items())]
    window_src = [feed.source(c) for _, (c, _) in sorted(kept.items())]
    feed.close()
    step.close()
    del feed, step, out, losses
    if cuda:
        torch.cuda.empty_cache()

    ref_batches = [fam.reference_batch(inputs, cfg, seed, s, device) for s in checked_src]
    ref = fam.reference_steps(cfg, weights, ref_batches, False)
    values = check.numbers(prog, ref, weights)
    worst = values.pop("_worst")
    values.update(fam.pipeline_numbers(
        checked_outs + window_outs,
        ref_batches + [fam.reference_batch(inputs, cfg, seed, s, device) for s in window_src],
        cfg))
    ok, shown, other = check.verdict(values, limits(cell))

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.readers[m["name"]](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"train_step_ms": window_s * 1e3 / steps, "setup_s": setup_s}
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": ctx["device_kind"],
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    if "profile" in ctx:
        dev["busy_s"] = ctx["profile"]["busy_s"]
        dev["window_s"] = ctx["profile"]["window_s"]
    result = {"correct": ok, "attempted": steps, "failed": failed, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = shown
    return result, {"forbidden": leftover, "worst": worst, "not compared": other}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    set_cache_dirs()

    import torch

    from .spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    if args.control:
        result, notes = control(cell, args.seed, device)
    else:
        result, notes = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T0,
                                 fault=args.fault)
    leftover = sorted(set(notes.get("forbidden", ())) | set(forbidden_modules()))
    if leftover:
        print(f"portbench: modules of JAX or its package were loaded: {leftover}",
              file=sys.stderr)
        return 3
    for name, where in notes.get("worst", {}).items():
        print(f"worst leaf of {name}: {where}", file=sys.stderr)
    for name, value in notes["not compared"].items():
        print(f"not compared {name} {value!r}", file=sys.stderr)
    for name, (value, limit) in result["check"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
