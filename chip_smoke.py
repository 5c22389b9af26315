"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase exits non-zero):

1. header  — card name and power limit (nvidia-smi), torch and CUDA versions;
2. build   — the host packer (g++) and the CUDA rasterizer (nvcc, sm_90a),
             compiled in parallel into accvlab_tpu_torch/_build/;
3. kernels — the rasterizer through each entry point (draw_heatmap_batched,
             its classwise form, draw_heatmap, draw_gaussians), exact and
             fast exp, at the main path's shapes and the reference headline
             shapes: held against the plain PyTorch version on the card
             (bitwise for exact, rtol 1e-6 for fast exp) and against the
             committed goldens. The bare kernel launch (``ms``), its plain
             version (``plain_ms``) and the whole entry point (``entry_ms``)
             are timed on the device with CUDA events, beside the bound
             computed from this run's data;
4. main    — bench.py's multi-camera pipeline on the port at full width
             (6 x 372x1024 RGB, batch 8, out 256x704, heatmap 10x64x176,
             T=32) through run(): 2 warm-up batches, then 3 timed windows of
             100 batches (frames/s per window and their median); outputs
             checked, one batch recomputed with the plain heatmap version
             and compared;
5. the {"kernels": [...]} line, the nvidia-smi line, and last the result
   line {"ok": true, "device": {...}}.

Exits non-zero without a result when torch.cuda.is_available() is false.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# float32 operations of one repro_exp.exp_f32: a Dekker product is 17, a
# 2Sum 6; the reduction takes one product, each of the 6 Horner steps two
# products, one 2Sum and 3 additions
EXACT_EXP_FLOPS = 282
SLEEP_CYCLES = 4_000_000  # about 2 ms of the card's clock: longer than any enqueue here
N_TIMED = 50
N_TIMED_PLAIN = 10
MAIN_WINDOWS = 3
MAIN_WINDOW_BATCHES = 100
GOLDENS = os.path.join("tests", "data", "goldens", "heatmap_goldens.npz")
SOURCE = "accvlab_tpu_torch/heatmap/csrc/draw_heatmap.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
# kernel phase                                                          #
# --------------------------------------------------------------------- #


def make_case(kind: str, shapes: str, seed: int, dev):
    """Inputs of one rasterizer instantiation. Returns ``call(implementation,
    exact)`` of the public entry point, the rasterizer arguments that entry
    point prepares (``raster(exact)`` -> the argument tuple of
    ``_kernel.launch`` and ``raster_plain``), the heatmap shape and the
    targets per sample."""
    from accvlab_tpu_torch.heatmap import draw_gaussians, draw_heatmap, draw_heatmap_batched
    from accvlab_tpu_torch.heatmap.draw import _prep_target_params
    from accvlab_tpu_torch.heatmap.draw_gaussians import gaussian_params
    from accvlab_tpu_torch.ragged import RaggedBatch

    rng = np.random.default_rng(seed)
    if shapes == "main":
        b, c, h, w, t = 48, 10, 64, 176, 32
    else:  # reference headline shapes (draw_heatmap_batched's benchmark)
        b, c, h, w, t = 48, 20, 20, 50, 50
    gpu = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    centers = gpu(np.stack([rng.integers(0, w, (b, t)), rng.integers(0, h, (b, t))], -1)
                  .astype(np.int32))
    radii_i = gpu(rng.integers(0, 8, (b, t)).astype(np.int32))
    sizes = gpu(rng.integers(t // 2, t + 1, b).astype(np.int32))
    labels = gpu(rng.integers(0, c, (b, t)).astype(np.int32))
    cb, rb = RaggedBatch(centers, sample_sizes=sizes), RaggedBatch(radii_i, sample_sizes=sizes)

    if kind == "batched":
        shape = (b, h, w)
        hm = torch.zeros(shape, device=dev)
        prep = (hm[:, None], *_prep_target_params(centers, radii_i, sizes, 6.0), None, None, True)

        def call(impl, exact):
            return draw_heatmap_batched(hm, cb, rb, implementation=impl, exact=exact)
    elif kind == "classwise":
        shape = (b, c, h, w)
        hm = torch.zeros(shape, device=dev)
        prep = (hm, *_prep_target_params(centers, radii_i, sizes, 6.0), labels, None, True)

        def call(impl, exact):
            return draw_heatmap_batched(hm, cb, rb, labels=RaggedBatch(labels, sample_sizes=sizes),
                                        implementation=impl, exact=exact)
    elif kind == "flat":
        # b maps, t targets per map, as one flat list of b*t targets
        shape = (b, h, w)
        hm = torch.zeros(shape, device=dev)
        fc, fr = centers.reshape(-1, 2), radii_i.reshape(-1)
        fi = gpu(np.repeat(np.arange(b, dtype=np.int32), t))
        nums = torch.full((1,), b * t, dtype=torch.int32, device=dev)
        prep = (hm[None], *_prep_target_params(fc[None], fr[None], nums, 6.0), fi[None], None,
                True)

        def call(impl, exact):
            return draw_heatmap(hm, fc, fr, fi, implementation=impl, exact=exact)
    else:  # gaussians: the main path's heatmap step
        shape = (b, c, h, w)
        hm = torch.zeros(shape, device=dev)
        act = gpu(rng.random((b, t)) < 0.9)
        rad = gpu(rng.uniform(0.5, 10.0, (b, t)).astype(np.float32))
        prep = (hm, *gaussian_params(act, labels, centers, rad, [1.0] * c, 1.0 / 3.0, c), False)

        def call(impl, exact):
            return draw_gaussians(hm, act, labels, centers, rad, [1.0] * c, 1.0 / 3.0,
                                  implementation=impl, exact=exact)

    def raster(exact):
        hm4, xs, ys, rr, iv, sel, kt, log_domain = prep
        return hm4, xs, ys, rr, iv, sel, kt, 1.0, exact, log_domain

    return call, raster, shape, t


def device_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time in ms of ``fn`` over ``reps`` runs (CUDA events).
    Before each run the L2 cache is flushed (64 MB write) and the stream is
    kept busy (``torch.cuda._sleep``) while the host enqueues ``fn``, so the
    events time the device work and not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        times.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in times]))


def count_work(args, out: torch.Tensor):
    """(bytes, flops) that this call's data needs. Bytes: the maps read once
    and written once, plus each target parameter array read once. Flops: 7
    for each (target, pixel) pair inside the target's clipped box (two
    differences, the squared distance, the scale, the max), plus one exp and
    its scale for each pair (exp-first) or for each pixel drawn (one exp per
    pixel in the log-domain form)."""
    hm4, xs, ys, rr, iv, sel, kt, _, exact, log_domain = args
    h, w = hm4.shape[-2:]
    nbytes = 2 * hm4.numel() * 4 + sum(a.numel() * 4 for a in (xs, ys, rr, iv, sel, kt)
                                        if a is not None)
    live = rr >= 0
    span_x = (torch.clamp(xs + rr, max=w - 1) - torch.clamp(xs - rr, min=0) + 1).clamp(min=0)
    span_y = (torch.clamp(ys + rr, max=h - 1) - torch.clamp(ys - rr, min=0) + 1).clamp(min=0)
    pairs = float((span_x * span_y * live).sum())
    exps = float((out != hm4).sum()) if log_domain else pairs
    return nbytes, 7.0 * pairs + exps * (1 + (EXACT_EXP_FLOPS if exact else 1))


def kernel_phase(dev, flush):
    from accvlab_tpu_torch.heatmap import LAUNCHES, _kernel, reset_launch_counts
    from accvlab_tpu_torch.heatmap.draw import raster_plain

    kinds = ["batched", "classwise", "flat", "gaussians"]
    entry = {"batched": "draw_heatmap_batched", "classwise": "draw_heatmap_batched_classwise",
             "flat": "draw_heatmap", "gaussians": "draw_gaussians"}
    replaces = {
        "batched": "accvlab_tpu/heatmap/draw.py:208 (_batched_kernel)",
        "classwise": "accvlab_tpu/heatmap/draw.py:278 (_tiled_kernel, classwise)",
        "flat": "accvlab_tpu/heatmap/draw.py:278 (_tiled_kernel, flat)",
        "gaussians": "accvlab_tpu/heatmap/draw_gaussians.py:23 (draw_gaussians, XLA segment_max)",
    }
    cases = {(k, s): make_case(k, s, seed, dev)
             for seed, (k, s) in enumerate((k, s) for k in kinds for s in ("main", "headline"))}

    # the entry points' own path: counts from 0, one call per case and exp mode
    reset_launch_counts()
    for (k, s), (call, _, _, _) in cases.items():
        for exact in (False, True):
            call("auto", exact)
    torch.cuda.synchronize()
    entry_launches = dict(LAUNCHES)
    for k in kinds:
        if entry_launches[entry[k]] == 0:
            fail(f"{entry[k]}: its entry point never launched the kernel")

    results = {}
    for (k, s), (call, raster, shape, t) in cases.items():
        for exact in (False, True):
            args = raster(exact)
            got = call("kernel", exact)
            bare = _kernel.launch("bare", *args)
            plain = call("torch", exact)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"{k}/{s}/exact={exact}: non-finite kernel output")
            if not torch.equal(bare.reshape(got.shape), got):
                fail(f"{k}/{s}/exact={exact}: the bare launch differs from the entry point")
            if exact:
                same = (got.view(torch.int32) == plain.view(torch.int32)).all().item()
                if not same:
                    n = int((got != plain).sum())
                    fail(f"{k}/{s}/exact=True: kernel differs from the plain version in {n} pixels")
            elif not torch.allclose(got, plain, rtol=1e-6, atol=0.0):
                fail(f"{k}/{s}/exact=False: kernel outside rtol 1e-6 of the plain version")
            err = float((got - plain).abs().max())
            ms = device_ms(lambda: _kernel.launch("bare", *args), N_TIMED, flush)
            plain_ms = device_ms(lambda: raster_plain(*args), N_TIMED_PLAIN, flush)
            entry_ms = device_ms(lambda: call("kernel", exact), N_TIMED, flush)
            nbytes, flops = count_work(args, bare)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / F32_FLOP_PER_S * 1e3
            results[(k, s, exact)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, entry_ms=entry_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, flops=flops, shape=list(shape), targets=t,
            )
            emit({"phase": "kernel", "kernel": entry[k], "shapes": s, "exact": exact,
                  **results[(k, s, exact)]})

    # the committed goldens through the kernel, bitwise
    goldens = np.load(GOLDENS)
    n_golden = golden_check(goldens, dev)
    return kinds, entry, replaces, results, entry_launches, n_golden


def golden_check(goldens, dev) -> int:
    from accvlab_tpu_torch.heatmap import draw_heatmap, draw_heatmap_batched
    from accvlab_tpu_torch.ragged import RaggedBatch

    def group(name):
        p = name + "/"
        return {k[len(p):]: goldens[k] for k in goldens.files if k.startswith(p)}

    gpu = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    checked = 0
    for name in ("batched_ref_shape", "batched_large_radii", "batched_factor3_k05",
                 "classwise", "flat"):
        g = group(name)
        kw = dict(diameter_to_sigma_factor=float(g["factor"]), k_scale=float(g["k_scale"]),
                  implementation="kernel", exact=True)
        hm = torch.zeros(g["heatmap"].shape, device=dev)
        if name == "flat":
            out = draw_heatmap(hm, gpu(g["centers"]), gpu(g["radii"]), gpu(g["idxes"]), **kw)
        else:
            sz = gpu(g["sizes"])
            labels = RaggedBatch(gpu(g["labels"]), sample_sizes=sz) if name == "classwise" else None
            out = draw_heatmap_batched(hm, RaggedBatch(gpu(g["centers"]), sample_sizes=sz),
                                       RaggedBatch(gpu(g["radii"]), sample_sizes=sz),
                                       labels=labels, **kw)
        got = out.cpu().numpy()
        if not (got.view(np.int32) == g["heatmap"].astype(np.float32).view(np.int32)).all():
            fail(f"golden {name}: kernel output is not bitwise equal to the golden")
        checked += 1
    return checked


# --------------------------------------------------------------------- #
# main path                                                             #
# --------------------------------------------------------------------- #


def check_outputs(out, num_cams: int, batch: int) -> None:
    for name, v in out.items():
        if not (isinstance(v, torch.Tensor) and v.is_cuda):
            fail(f"main path: output {name} is not a CUDA tensor")
        if v.dtype.is_floating_point and not torch.isfinite(v).all():
            fail(f"main path: output {name} has non-finite values")
    for c in range(num_cams):
        p = f"cameras.[{c}]."
        img = out[p + "image"]
        hm = out[p + "annotations.heatmap"]
        if tuple(img.shape) != (batch, 256, 704, 3) or img.dtype != torch.float32:
            fail(f"main path: {p}image has shape {tuple(img.shape)} {img.dtype}")
        if tuple(hm.shape) != (batch, 10, 64, 176):
            fail(f"main path: {p}heatmap has shape {tuple(hm.shape)}")
        if float(hm.min()) < 0.0 or float(hm.max()) > 1.0:
            fail(f"main path: {p}heatmap outside [0, 1]")
        act = out[p + "annotations.active"]
        cen = out[p + "annotations.center"].long()
        cat = out[p + "annotations.categories"].long()
        bi, ti = torch.nonzero(act, as_tuple=True)
        peaks = hm[bi, cat[bi, ti], cen[bi, ti, 1], cen[bi, ti, 0]]
        if bi.numel() == 0 or not bool((peaks == 1.0).all()):
            fail(f"main path: {p}heatmap has no peak of 1 at some active centre")


def main_phase(dev, card: str):
    from accvlab_tpu_torch.bench_pipeline import build_pipeline
    from accvlab_tpu_torch.heatmap import LAUNCHES, reset_launch_counts

    batch, num_cams = 8, 6
    pipe = build_pipeline(batch_size=batch, device=dev)
    first = {k: v.clone() for k, v in pipe.run().items()}  # batch 0, kept for the plain recompute
    pipe.run()
    torch.cuda.synchronize()

    # MAIN_WINDOWS back-to-back windows of MAIN_WINDOW_BATCHES batches each,
    # on one pipeline: frames/s is reported per window, with their median
    reset_launch_counts()
    window_s = []
    for _ in range(MAIN_WINDOWS):
        t0 = time.perf_counter()
        for _ in range(MAIN_WINDOW_BATCHES):
            out = pipe.run()
        torch.cuda.synchronize()
        window_s.append(time.perf_counter() - t0)
    n_batches = MAIN_WINDOWS * MAIN_WINDOW_BATCHES
    launches = LAUNCHES["draw_gaussians"]
    main_launches = dict(LAUNCHES)
    stats = pipe.stats()
    pipe.stop()
    if launches != n_batches:
        fail(f"main path: draw_gaussians launched {launches} times for {n_batches} batches")
    check_outputs(out, num_cams, batch)
    check_outputs(first, num_cams, batch)

    # batch 0 again, with the plain heatmap version: same host batch, same draws
    plain_pipe = build_pipeline(batch_size=batch, device=dev, heatmap_implementation="torch")
    plain = plain_pipe.run()
    torch.cuda.synchronize()
    plain_pipe.stop()
    worst = {}
    for name, v in first.items():
        w = plain[name]
        if name.endswith("heatmap"):
            ok = torch.allclose(v, w, rtol=1e-6, atol=0.0)
        else:
            ok = torch.equal(v, w)
        if not ok:
            fail(f"main path: {name} differs between the kernel and the plain heatmap version")
        if v.dtype.is_floating_point:
            worst[name.split(".")[-1]] = max(worst.get(name.split(".")[-1], 0.0),
                                             float((v - w).abs().max()))
    fps = [MAIN_WINDOW_BATCHES * batch * num_cams / w for w in window_s]
    ms_per_batch = [w / MAIN_WINDOW_BATCHES * 1e3 for w in window_s]
    emit({
        "phase": "main", "card": card, "frames_per_s": float(np.median(fps)),
        "frames_per_s_windows": fps, "ms_per_batch": float(np.median(ms_per_batch)),
        "ms_per_batch_windows": ms_per_batch, "batches": n_batches,
        "draw_gaussians_launches": launches, "bytes_per_batch": stats["bytes_per_batch"],
        "consumer_wait_s": stats["consumer_wait_s"], "device_stage_s": stats["device_stage_s"],
        "input_bound_frac": stats["input_bound_frac"], "plain_recompute_max_abs_err": worst,
        "config": "raw RGB frames (no DCT wire): 6 cams x 372x1024, batch 8 -> 256x704, "
                  "heatmap 10x64x176, T=32",
    })
    return main_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    import accvlab_tpu_torch  # noqa: F401  (fails outside a checkout of the repository)
    from accvlab_tpu_torch import _native_build
    from accvlab_tpu_torch.heatmap import _kernel
    from accvlab_tpu_torch.hostcopy import native as hostcopy_native

    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    card = f"{smi} (nvidia-smi name, power.limit)"
    emit({"phase": "header", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as ex:  # one compiler per source, together
        libs = list(ex.map(lambda f: f(), [_kernel.library_path, hostcopy_native.library_path]))
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "libraries": libs,
          "compiler_seconds": _native_build.build_seconds})

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    kinds, entry, replaces, results, entry_launches, n_golden = kernel_phase(dev, flush)
    emit({"phase": "goldens", "bitwise_groups": n_golden})
    main_launches = main_phase(dev, card)

    kernels = []
    for k in kinds:
        r = results[(k, "main", False)]
        rx = results[(k, "main", True)]
        kernels.append({
            "name": entry[k], "route": "cuda", "source": SOURCE, "replaces": replaces[k],
            "launches": main_launches[entry[k]] if k == "gaussians" else entry_launches[entry[k]],
            "max_abs_err": max(r["max_abs_err"], rx["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "entry_ms": r["entry_ms"],
            "exact_ms": rx["ms"], "exact_plain_ms": rx["plain_ms"],
            "exact_bound_ms": rx["bound_ms"], "exact_entry_ms": rx["entry_ms"],
            "launches_from": "main path" if k == "gaussians" else "entry-point drive",
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
