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
             computed from this run's data. Then the edge cases of the tiled
             kernel (EDGE_CASES, correctness only), and one draw_gaussians
             call under torch.cuda.set_sync_debug_mode("error"), which fails
             on any copy or wait between host and card;
4. main    — bench.py's multi-camera pipeline on the port at full width
             (6 x 372x1024 RGB, batch 8, out 256x704, heatmap 10x64x176,
             T=32) through run(): 2 warm-up batches, then 3 timed windows of
             100 batches (frames/s per window and their median); outputs
             checked, one batch recomputed with the plain heatmap version
             and compared;
5. train_parity — a seeded CenterNet (width 64) on make_example_batch, on
             the card and on the CPU (the port's plain path): loss, heads
             and parameter gradients within the bf16 tolerances stated in
             TRAIN_TOL; and the ragged gather's backward at the main path's
             shapes with many duplicate indices, twice on the card: both
             bitwise equal to each other and to the CPU's;
6. train   — the training path at full width: build_train_pipeline (6
             cameras x batch 8, heatmap 10x64x176) -> batch_to_train_inputs
             of all cameras (48 images) -> make_train_step(CenterNetDetector(
             10, width=64)): 20 steps on fresh batches (every loss finite),
             30 steps on one cached batch (the loss falls below its first
             value; device time per step with CUDA events, peak memory, conv
             FLOPs per second as a share of the bf16 peak), then one step
             under torch.cuda.set_sync_debug_mode("error");
7. input_idle — bench_pipeline.measure_input_idle(pipe, 6, n_iters=50,
             width=64) on bench.py's pipeline: t_e2e, t_comp, idle and the
             pipeline's input_bound_frac;
8. the {"kernels": [...]} line, the nvidia-smi line, and last the result
   line {"ok": true, "device": {...}}.

The pipeline phases (main, train, input_idle) each count the rasterizer's
launches from 0 and fail unless it ran once per pipeline batch.

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
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
TRAIN_FRESH_STEPS = 20
TRAIN_CACHED_STEPS = 30
IDLE_ITERS = 50
# card against CPU, same weights and batch, both with bf16 convs: a bf16
# rounding is 2^-8 of a value, and the two sides accumulate the convs in
# different orders, so some roundings land one step apart and propagate.
# Errors are relative to the largest magnitude of each tensor.
TRAIN_TOL = {"loss": 2e-2, "heads": 3e-2, "grads": 1e-1, "grad_cosine": 0.99}
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
    exact)`` of the public entry point; ``bare(exact, tile=None)``, the kernel
    launched directly on the raw inputs that entry point hands it; ``plain(
    exact)``, the argument tuple of ``raster_plain`` on the targets its plain
    version prepares; the raw target tensors the kernel reads; the heatmap
    shape and the targets per sample."""
    from accvlab_tpu_torch.heatmap import _kernel, draw_gaussians, draw_heatmap
    from accvlab_tpu_torch.heatmap import draw_heatmap_batched
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
        draw = (hm[:, None], centers, radii_i, sizes, None)

        def call(impl, exact):
            return draw_heatmap_batched(hm, cb, rb, implementation=impl, exact=exact)
    elif kind == "classwise":
        shape = (b, c, h, w)
        hm = torch.zeros(shape, device=dev)
        draw = (hm, centers, radii_i, sizes, labels)

        def call(impl, exact):
            return draw_heatmap_batched(hm, cb, rb, labels=RaggedBatch(labels, sample_sizes=sizes),
                                        implementation=impl, exact=exact)
    elif kind == "flat":
        # b maps, t targets per map, as one flat list of b*t targets
        shape = (b, h, w)
        hm = torch.zeros(shape, device=dev)
        fc, fr = centers.reshape(-1, 2), radii_i.reshape(-1)
        fi = gpu(np.repeat(np.arange(b, dtype=np.int32), t))
        draw = (hm[None], fc[None], fr[None], None, fi[None])

        def call(impl, exact):
            return draw_heatmap(hm, fc, fr, fi, implementation=impl, exact=exact)
    else:  # gaussians: the main path's heatmap step
        shape = (b, c, h, w)
        hm = torch.zeros(shape, device=dev)
        act = gpu(rng.random((b, t)) < 0.9)
        rad = gpu(rng.uniform(0.5, 10.0, (b, t)).astype(np.float32))
        gauss = (hm, act, labels, centers, rad, [1.0] * c, 1.0 / 3.0)

        def call(impl, exact):
            return draw_gaussians(*gauss, implementation=impl, exact=exact)

        def bare(exact, tile=None):
            return _kernel.launch_gaussians("bare", *gauss, exact, tile)

        def plain(exact):
            return (hm, *gaussian_params(*gauss[1:5], gauss[5], gauss[6], c), 1.0, exact, False)

        return call, bare, plain, gauss[1:5], shape, t

    def bare(exact, tile=None):
        return _kernel.launch_draw("bare", *draw, 6.0, 1.0, exact, True, tile)

    def plain(exact):
        hm4, cen, rad_i, nums, sel = draw
        return (hm4, *_prep_target_params(cen, rad_i, nums, 6.0), sel, None, 1.0, exact, True)

    return call, bare, plain, draw[1:], shape, t


# Correctness-only cases at the edges of the tiled kernel: boxes larger than
# a tile and than the map, centres outside it, special float radii (reach
# -0.0, NaN, inf), widths that are not a multiple of 4, H = 1, more targets
# than one chunk of the kernel, one class holding every target,
# out-of-range ids on the card, and non-positive peaks (the exp-first form).
EDGE_DEFAULTS = dict(b=3, c=4, h=20, w=44, t=24, rmax=8, outside=False, ids="in_range",
                     k_scale=1.0, hm="zeros")
EDGE_CASES = {
    "batched_big_radii_outside": dict(kind="batched", h=33, w=175, t=40, rmax=60, outside=True),
    "batched_w1": dict(kind="batched", h=37, w=1),
    "batched_h1": dict(kind="batched", h=1, w=175),
    "batched_k_negative": dict(kind="batched", k_scale=-0.5, hm="normal"),
    "classwise_big_radii_outside": dict(kind="classwise", w=76, rmax=40, outside=True),
    "classwise_one_class": dict(kind="classwise", c=5, h=24, w=64, t=30, ids="one"),
    "classwise_bad_labels": dict(kind="classwise", ids="bad"),
    "classwise_k_zero": dict(kind="classwise", k_scale=0.0, hm="normal"),
    "classwise_h1_w175": dict(kind="classwise", h=1, w=175),
    "flat_many_targets": dict(kind="flat", b=40, h=24, w=40, t=5000, rmax=12),
    "flat_big_radii_outside_w1": dict(kind="flat", b=6, h=50, w=1, t=300, rmax=60, outside=True),
    "flat_bad_ids": dict(kind="flat", b=5, t=60, ids="bad"),
    "flat_k_negative": dict(kind="flat", b=5, t=60, k_scale=-0.5, hm="normal"),
    "gaussians_special_radii": dict(kind="gaussians", h=9, w=175, t=40),
    "gaussians_big_radii_outside": dict(kind="gaussians", h=33, w=70, t=40, rmax=80,
                                        outside=True),
    "gaussians_one_class": dict(kind="gaussians", c=6, ids="one"),
    "gaussians_bad_ids": dict(kind="gaussians", ids="bad", hm="normal"),
    "gaussians_w1_h1": dict(kind="gaussians", h=1, w=1, t=8),
}
# float radii of draw_gaussians at the edges: ceil gives -0.0 for (-1, 0)
SPECIAL_RADII = [-0.5, -0.0, 0.0, float("nan"), float("inf"), float("-inf"), 1e-30, 3e38, -2.5]


def edge_case(name: str, dev):
    """``call(implementation, exact)`` of edge case ``name`` through its
    public entry point, on inputs made from a seed."""
    from accvlab_tpu_torch.heatmap import draw_gaussians, draw_heatmap, draw_heatmap_batched
    from accvlab_tpu_torch.ragged import RaggedBatch

    spec = dict(EDGE_DEFAULTS, **EDGE_CASES[name])
    kind, b, c, h, w, t = (spec[k] for k in ("kind", "b", "c", "h", "w", "t"))
    rng = np.random.default_rng(sorted(EDGE_CASES).index(name))
    gpu = lambda a: torch.as_tensor(np.asarray(a)).to(dev)  # noqa: E731
    n = 1 if kind == "flat" else b  # the flat form: one list of t targets over b maps
    lo, hi = (-1, 2) if spec["outside"] else (0, 1)
    centers = np.stack([rng.integers(lo * w, hi * w, (n, t)), rng.integers(lo * h, hi * h, (n, t))],
                       -1).astype(np.int32)
    n_ids = b if kind == "flat" else c
    ids = {"in_range": rng.integers(0, n_ids, (n, t)), "one": np.full((n, t), n_ids // 2),
           "bad": rng.integers(-3, n_ids + 3, (n, t))}[spec["ids"]].astype(np.int32)
    maps = (b, h, w) if kind in ("batched", "flat") else (b, c, h, w)
    hm = gpu(np.zeros(maps, np.float32) if spec["hm"] == "zeros"
             else rng.normal(size=maps).astype(np.float32))
    if kind == "gaussians":
        radii = rng.uniform(0.3, spec["rmax"], (b, t)).astype(np.float32)
        if name == "gaussians_special_radii":
            radii.reshape(-1)[: len(SPECIAL_RADII) * 3] = np.repeat(SPECIAL_RADII, 3)
        active = rng.random((b, t)) < 0.85
        ks = rng.uniform(0.5, 1.5, c).astype(np.float32).tolist()
        args = (hm, gpu(active), gpu(ids), gpu(centers), gpu(radii), ks, 1.0 / 3.0)
        return lambda impl, exact: draw_gaussians(*args, implementation=impl, exact=exact)
    radii = rng.integers(-2, spec["rmax"] + 1, (n, t)).astype(np.int32)
    radii.reshape(-1)[:2] = 1 << 20
    kw = dict(k_scale=spec["k_scale"])
    if kind == "flat":
        args = (hm, gpu(centers[0]), gpu(radii[0]), gpu(ids[0]))
        return lambda impl, exact: draw_heatmap(*args, **kw, implementation=impl, exact=exact)
    sizes = gpu(rng.integers(0, t + 1, b).astype(np.int32))
    rag = (RaggedBatch(gpu(centers), sample_sizes=sizes),
           RaggedBatch(gpu(radii), sample_sizes=sizes))
    if kind == "classwise":
        kw["labels"] = RaggedBatch(gpu(ids), sample_sizes=sizes)
    return lambda impl, exact: draw_heatmap_batched(hm, *rag, **kw, implementation=impl,
                                                    exact=exact)


def matches_plain(got: torch.Tensor, plain: torch.Tensor, exact: bool) -> bool:
    """Bitwise for the exact exp, rtol 1e-6 for the fast one."""
    if exact:
        return bool((got.view(torch.int32) == plain.view(torch.int32)).all())
    return torch.allclose(got, plain, rtol=1e-6, atol=0.0, equal_nan=True)


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


def count_work(plain_args, reads, out: torch.Tensor):
    """(bytes, flops) that this call's data needs. Bytes: the maps read once
    and written once, plus each raw target array the kernel reads, once.
    Flops: 7 for each (target, pixel) pair inside the target's clipped box
    (two differences, the squared distance, the scale, the max), plus one exp
    and its scale for each pair (exp-first) or for each pixel drawn (one exp
    per pixel in the log-domain form). The target preparation (a few dozen
    flops per target) is left out."""
    hm4, xs, ys, rr, iv, sel, kt, _, exact, log_domain = plain_args
    h, w = hm4.shape[-2:]
    nbytes = 2 * hm4.numel() * 4 + sum(a.numel() * a.element_size() for a in reads
                                        if a is not None)
    live = rr >= 0
    span_x = (torch.clamp(xs + rr, max=w - 1) - torch.clamp(xs - rr, min=0) + 1).clamp(min=0)
    span_y = (torch.clamp(ys + rr, max=h - 1) - torch.clamp(ys - rr, min=0) + 1).clamp(min=0)
    pairs = float((span_x * span_y * live).sum())
    exps = float((out != hm4).sum()) if log_domain else pairs
    return nbytes, 7.0 * pairs + exps * (1 + (EXACT_EXP_FLOPS if exact else 1))


KINDS = ["batched", "classwise", "flat", "gaussians"]
ENTRY = {"batched": "draw_heatmap_batched", "classwise": "draw_heatmap_batched_classwise",
         "flat": "draw_heatmap", "gaussians": "draw_gaussians"}


def kernel_phase(dev, flush):
    from accvlab_tpu_torch.heatmap import LAUNCHES, reset_launch_counts
    from accvlab_tpu_torch.heatmap.draw import raster_plain

    replaces = {
        "batched": "accvlab_tpu/heatmap/draw.py:208 (_batched_kernel)",
        "classwise": "accvlab_tpu/heatmap/draw.py:278 (_tiled_kernel, classwise)",
        "flat": "accvlab_tpu/heatmap/draw.py:278 (_tiled_kernel, flat)",
        "gaussians": "accvlab_tpu/heatmap/draw_gaussians.py:23 (draw_gaussians, XLA segment_max)",
    }
    cases = {(k, s): make_case(k, s, seed, dev)
             for seed, (k, s) in enumerate((k, s) for k in KINDS for s in ("main", "headline"))}

    # the entry points' own path: counts from 0, one call per case and exp mode
    reset_launch_counts()
    for (k, s), (call, *_) in cases.items():
        for exact in (False, True):
            call("auto", exact)
    torch.cuda.synchronize()
    entry_launches = dict(LAUNCHES)
    for k in KINDS:
        if entry_launches[ENTRY[k]] == 0:
            fail(f"{ENTRY[k]}: its entry point never launched the kernel")

    results = {}
    for (k, s), (call, bare, plain, reads, shape, t) in cases.items():
        for exact in (False, True):
            args = plain(exact)
            got = call("kernel", exact)
            direct = bare(exact)
            ref = call("torch", exact)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"{k}/{s}/exact={exact}: non-finite kernel output")
            if not torch.equal(direct.reshape(got.shape), got):
                fail(f"{k}/{s}/exact={exact}: the bare launch differs from the entry point")
            if not matches_plain(got, ref, exact):
                n = int((got != ref).sum())
                fail(f"{k}/{s}/exact={exact}: kernel differs from the plain version in {n} pixels")
            err = float((got - ref).abs().max())
            ms = device_ms(lambda: bare(exact), N_TIMED, flush)
            plain_ms = device_ms(lambda: raster_plain(*args), N_TIMED_PLAIN, flush)
            entry_ms = device_ms(lambda: call("kernel", exact), N_TIMED, flush)
            nbytes, flops = count_work(args, reads, direct)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / F32_FLOP_PER_S * 1e3
            results[(k, s, exact)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, entry_ms=entry_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, flops=flops, shape=list(shape), targets=t,
            )
            emit({"phase": "kernel", "kernel": ENTRY[k], "shapes": s, "exact": exact,
                  **results[(k, s, exact)]})

    # the edges of the tiling, correctness only
    for name in EDGE_CASES:
        call = edge_case(name, dev)
        for exact in (False, True):
            got, ref = call("kernel", exact), call("torch", exact)
            torch.cuda.synchronize()
            if not matches_plain(got, ref, exact):
                fail(f"edge case {name}/exact={exact}: kernel differs from the plain version in "
                     f"{int((got != ref).sum())} pixels")
    emit({"phase": "edge_cases", "cases": len(EDGE_CASES), "exp_modes": 2})

    # draw_gaussians on card tensors makes no copy between host and card
    call = cases[("gaussians", "main")][0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call("kernel", False)
    except RuntimeError as e:
        fail(f"draw_gaussians synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    emit({"phase": "no_sync", "draw_gaussians": "no synchronising call"})

    # the committed goldens through the kernel, bitwise
    goldens = np.load(GOLDENS)
    n_golden = golden_check(goldens, dev)
    return replaces, results, entry_launches, n_golden


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


# --------------------------------------------------------------------- #
# training path                                                         #
# --------------------------------------------------------------------- #


def gather_adjoint_inputs(seed: int = 0):
    """The ragged gather of the main path's loss (48 feature maps of 64x176
    with 2 channels, 32 slots per sample), its indices drawn from 8 pixels
    so that most slots share one with another slot."""
    rng = np.random.default_rng(seed)
    b, n, t = 48, 64 * 176, 32
    data = rng.normal(size=(b, n, 2)).astype(np.float32)
    idx = rng.integers(0, 8, (b, t)).astype(np.int32)
    sizes = rng.integers(t // 2, t + 1, b).astype(np.int32)
    ct = rng.normal(size=(b, t, 2)).astype(np.float32)
    return data, idx, sizes, ct


def gather_adjoint(inputs, dev, ordered: bool = True) -> torch.Tensor:
    """The gradient of sum(ct * gather(data)) with respect to data: through
    the port's ragged gather, or (``ordered=False``) through plain
    torch.gather autograd."""
    from accvlab_tpu_torch.ragged import RaggedBatch, batched_indexing_access

    data, idx, sizes, ct = (torch.from_numpy(a).to(dev) for a in inputs)
    x = data.clone().requires_grad_(True)
    if ordered:
        out = batched_indexing_access(x, RaggedBatch(idx, sample_sizes=sizes)).tensor
    else:
        out = torch.gather(x, 1, idx.long()[:, :, None].expand(*idx.shape, 2))
    out.backward(ct)
    return x.grad


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32)))


def rel_to_max(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def train_parity_phase(dev):
    import copy

    from accvlab_tpu_torch.models.centernet import (
        CenterNetDetector, centernet_loss, init_params, make_example_batch)

    cpu = torch.device("cpu")
    model_cpu = init_params(CenterNetDetector(10, width=64), torch.Generator().manual_seed(0))
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    res = {}
    for name, model, d in (("cpu", model_cpu, cpu), ("gpu", model_gpu, dev)):
        batch = make_example_batch(device=d)
        heads = model(batch["images"])
        loss = centernet_loss(heads, batch["targets"])["loss"]
        loss.backward()
        res[name] = (loss.detach(), heads, {n: p.grad for n, p in model.named_parameters()})
    loss_err = abs(float(res["gpu"][0]) - float(res["cpu"][0])) / abs(float(res["cpu"][0]))
    head_err = max(rel_to_max(res["gpu"][1][k], res["cpu"][1][k]) for k in res["cpu"][1])
    grad_err, cosine = 0.0, 1.0
    for n, g_cpu in res["cpu"][2].items():
        g_gpu = res["gpu"][2][n].cpu()
        grad_err = max(grad_err, rel_to_max(g_gpu, g_cpu))
        cosine = min(cosine, float(torch.nn.functional.cosine_similarity(
            g_gpu.double().flatten(), g_cpu.double().flatten(), dim=0)))
    errors = {"loss": loss_err, "heads": head_err, "grads": grad_err, "grad_cosine": cosine}
    for k, tol in TRAIN_TOL.items():
        bad = errors[k] < tol if k == "grad_cosine" else errors[k] > tol
        if bad:
            fail(f"train_parity: {k} {errors[k]} against the CPU (tolerance {tol})")

    inputs = gather_adjoint_inputs()
    first, second = gather_adjoint(inputs, dev), gather_adjoint(inputs, dev)
    on_cpu = gather_adjoint(inputs, cpu)
    if not (bitwise_equal(first, second) and bitwise_equal(first, on_cpu)):
        fail("train_parity: the ragged gather's backward is not the same bits run to run "
             "and on the CPU")
    plain = [gather_adjoint(inputs, dev, ordered=False) for _ in range(2)]
    emit({"phase": "train_parity", "model": "CenterNetDetector(10, width=64), "
          "make_example_batch(2, (64, 96))", "errors": errors, "tolerance": TRAIN_TOL,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "gather_adjoint_bitwise_run_to_run": True, "gather_adjoint_bitwise_vs_cpu": True,
          "plain_torch_gather_adjoint_bitwise_run_to_run": bitwise_equal(*plain),
          "plain_torch_gather_adjoint_bitwise_vs_cpu": bitwise_equal(plain[0], on_cpu)})


def conv_flops(model, batch: int, hw) -> tuple:
    """(forward, step) FLOPs of the model's convs on ``batch`` images of
    ``hw``: 2 per multiply-add; the backward pass computes each conv's
    weight gradient and, except for the first conv (whose input is the
    images), its input gradient, each as many FLOPs as the forward conv.
    GroupNorm, the losses and Adam are left out."""
    h, w = hw
    fwd, first = 0.0, None
    for block in model.blocks:
        weight, s = block.conv.weight, block.stride
        h, w = -(-h // s), -(-w // s)  # 'SAME' keeps ceil(n / s)
        flops = 2.0 * batch * h * w * weight[0].numel() * weight.shape[0]
        first = flops if first is None else first
        fwd += flops
    for head in model.heads().values():
        fwd += 2.0 * batch * h * w * head.weight[0].numel() * head.weight.shape[0]
    return fwd, 3.0 * fwd - first


def count_launches(fn):
    """``fn()`` with the rasterizer's launch counts from 0; returns its
    result and the draw_gaussians launches it made."""
    from accvlab_tpu_torch.heatmap import LAUNCHES, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    res = fn()
    torch.cuda.synchronize()
    return res, LAUNCHES["draw_gaussians"]


def train_phase(dev, card: str):
    from accvlab_tpu_torch.models.centernet import CenterNetDetector, make_train_step
    from accvlab_tpu_torch.train_centernet_e2e import batch_to_train_inputs, build_train_pipeline

    batch, num_cams, cams = 8, 6, list(range(6))
    pipe = build_train_pipeline(batch_size=batch, device=dev)
    model = CenterNetDetector(10, width=64)
    init_fn, step = make_train_step(model)

    def fresh_steps():
        out = pipe.run()
        cached = batch_to_train_inputs(out, cam=cams)
        model_, opt = init_fn(0, cached["images"])
        losses = []
        for i in range(TRAIN_FRESH_STEPS):
            inputs = cached if i == 0 else batch_to_train_inputs(pipe.run(), cam=cams)
            losses.append(step(model_, opt, inputs)[2]["loss"])
        return cached, opt, torch.stack(losses).cpu()

    (cached, opt, fresh), launches = count_launches(fresh_steps)
    if launches != TRAIN_FRESH_STEPS:
        fail(f"train: draw_gaussians launched {launches} times for {TRAIN_FRESH_STEPS} batches")
    if tuple(cached["images"].shape) != (batch * num_cams, 256, 704, 3) or \
            tuple(cached["targets"]["heatmap"].shape) != (batch * num_cams, 64, 176, 10):
        fail(f"train: inputs of shape {tuple(cached['images'].shape)}, "
             f"{tuple(cached['targets']['heatmap'].shape)}")
    if not bool(torch.isfinite(fresh).all()):
        fail(f"train: non-finite loss on fresh batches: {fresh.tolist()}")

    torch.cuda.reset_peak_memory_stats()
    events, losses = [], []
    t0 = time.perf_counter()
    for _ in range(TRAIN_CACHED_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        losses.append(step(model, opt, cached)[2]["loss"])
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / TRAIN_CACHED_STEPS * 1e3
    peak_bytes = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in events]
    repeated = torch.stack(losses).cpu()
    if not bool(torch.isfinite(repeated).all()) or not float(repeated[-1]) < float(repeated[0]):
        fail(f"train: the loss on a repeated batch did not fall: {repeated.tolist()}")

    # one full step under the sync check: adapting the batch, forward, loss,
    # backward and Adam make no copy or wait between host and card
    out = pipe.run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(model, opt, batch_to_train_inputs(out, cam=cams))
    except RuntimeError as e:
        fail(f"train: the step synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    pipe.stop()

    fwd_flops, step_flops = conv_flops(model, batch * num_cams, (256, 704))
    med = float(np.median(step_ms))
    emit({
        "phase": "train", "card": card,
        "config": "CenterNetDetector(10, width=64), Adam lr 1e-3; 6 cams x batch 8 = 48 images "
                  "of 256x704, heatmap 10x64x176, T=32",
        "fresh_losses": fresh.tolist(), "repeated_loss_first": float(repeated[0]),
        "repeated_loss_last": float(repeated[-1]), "step_device_ms": med,
        "step_device_ms_all": step_ms, "step_host_ms": host_ms, "peak_memory_bytes": peak_bytes,
        "conv_gflop_forward": fwd_flops / 1e9, "conv_gflop_step": step_flops / 1e9,
        "bf16_peak_share": step_flops / (med / 1e3) / BF16_FLOP_PER_S,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "draw_gaussians_launches": launches, "sync_free_step": True,
    })


def input_idle_phase(dev, card: str):
    from accvlab_tpu_torch.bench_pipeline import build_pipeline, measure_input_idle

    pipe = build_pipeline(batch_size=8, device=dev)
    try:
        res, launches = count_launches(lambda: measure_input_idle(pipe, 6, n_iters=IDLE_ITERS,
                                                                  width=64))
        stats = pipe.stats()
    finally:
        pipe.stop()
    batches = 1 + 2 * IDLE_ITERS  # the first, the warm-up window, the timed window
    if launches != batches:
        fail(f"input_idle: draw_gaussians launched {launches} times for {batches} batches")
    emit({"phase": "input_idle", "card": card, "t_e2e_ms": res["t_e2e_s"] * 1e3,
          "t_comp_ms": res["t_comp_s"] * 1e3, "idle": res["idle"],
          "input_bound_frac": stats["input_bound_frac"], "n_iters": IDLE_ITERS,
          "draw_gaussians_launches": launches})


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
    replaces, results, entry_launches, n_golden = kernel_phase(dev, flush)
    emit({"phase": "goldens", "bitwise_groups": n_golden})
    main_launches = main_phase(dev, card)
    train_parity_phase(dev)
    train_phase(dev, card)
    input_idle_phase(dev, card)

    kernels = []
    for k in KINDS:
        r = results[(k, "main", False)]
        rx = results[(k, "main", True)]
        kernels.append({
            "name": ENTRY[k], "route": "cuda", "source": SOURCE, "replaces": replaces[k],
            "launches": main_launches[ENTRY[k]] if k == "gaussians" else entry_launches[ENTRY[k]],
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
