"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase exits non-zero):

1. header  — card name and power limit (nvidia-smi), torch and CUDA versions;
2. build   — the host packer, the wire encoder, the DCT band encoder and
             the native JPEG decoder (g++; the decoder linked with the
             system's libjpeg.so.62 or, on a host without one, Pillow's
             libjpeg-turbo, named in the line),
             the CUDA rasterizer and the CUDA auction (nvcc, sm_90a),
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
4. main    — bench.py's multi-camera pipeline on the port at full width, on
             bench.py's default DCT wire (6 x 372x1024 q90 JPEG, 16 unique
             frame sets; the host entropy-decodes with libjpeg and packs the
             quantized coefficients with dctpack.cpp in the "dp16" band
             grouping; the card unpacks them, runs the IDCT and the resize,
             then the colour conversion; batch 8, heatmap 10x64x176, T=32)
             through run(): 2 warm-up batches, then 3 timed windows of 100
             batches (frames/s per window and their median); bytes per batch,
             the grouping and the packer's choices and host seconds; outputs
             checked, one batch recomputed with the plain heatmap version and
             compared;
   main_yuv — one window of 100 batches of the same pipeline on the YUV
             4:2:0 wire (decoded by WIRE_DECODER, libjpeg at its 6/8 DCT scale,
             straight to 256x704 planes; the line counts the frames each
             decoder took; the plane codec on the host, unpack + colour
             conversion on the card), outputs checked;
5. main_frames — one window of 100 batches of the same pipeline on raw RGB
             frames (the earlier slices' path), for a same-call comparison;
   dct_wire — one full-width host batch of the DCT wire decoded on the card
             and on the CPU: the integer coefficients (after the exceptions,
             the DC predictor, de-zigzag and dequantise) bitwise equal, the
             planes within 1 (the share that differs printed); the whole
             unpack step under torch.cuda.set_sync_debug_mode("error"); its
             device ms per batch (CUDA events, the stream held by a sleep
             while the host enqueues, median of 50) and its kernel launches
             per batch (torch.profiler);
6. wire    — one host batch of the YUV wire decoded on the card, bitwise
             equal to the unpacked planes and to the CPU decode; the RGB of
             the packed and the unpacked wire bitwise equal (augmentation
             off); the colour conversion on the card within 1 of the CPU's,
             with the share that differs; unpack + convert under the sync
             check;
7. echo    — echo_factor=2 on the YUV and on the DCT wire: delivered batches
             twice the transfers, the replays of a host batch different,
             delivered frames/s; a mid-echo get_state, a fresh pipeline and
             set_state continue bitwise for 3 batches;
   det2d   — the 2-D detection example's counterpart
             (accvlab_tpu_torch/object_detection_2d_pipeline.py) at bench.py's
             width (BenchNuScenesProvider: bench.py's cached q90 JPEGs, 6 cams
             of 372x1024, 32 boxes of 10 classes; batch 8 -> 256x704,
             heatmaps 10x64x176) on its DCT wire (optimize_band_groups, 16
             groups), through StructuredOutputIterator.CreateAsDataLoaderObject:
             2 warm-up batches, one timed window of DET2D_BATCHES (frames/s),
             the epoch's end and the next epoch's first batch, timed by the
             port's Stopwatch and traced (build/det2d_trace.json: every span
             and instant name present, each span's start before its end);
             the rasterizer once per delivered batch; batch 0 recomputed on
             the CPU (images within DET2D_IMAGE_LEVELS in at most a share
             DET2D_IMAGE_SHARE of the values, heatmaps rtol 1e-6, the
             rest within 1e-5 or equal);
   steps_2d — one full-width pipeline through every 2-D step: on the
             host VisibleBboxSelector (per camera, through an applied-step
             wrapper), AnnotationElementConditionEval and
             ConditionalElementRemover, ImageToTileSizePadder and
             PaddingToUniform with optimize_size_buckets' buckets; on the card
             an AffineTransformer per camera (NonUniformScaling, both shift
             steps, a Selection of Rotation, Shearing and scaling), then
             TensorSizeAdder, PointsInRangeCheck, CoordinateCropper, a
             condition, AxesLayoutSetter and UnneededFieldRemover: a few
             batches through run(), then one host batch's device stage on
             the card under torch.cuda.set_sync_debug_mode("error") and on
             the CPU (images within 1, boxes 1e-6 relative, the rest equal),
             its device ms and launches per batch;
   workers — the YUV wire (WIRE_DECODER) and the DCT wire, each with
             worker_mode="thread" and "process": one window of WORKER_BATCHES
             each (frames/s, the consumer's ms per batch, producer busy);
             process batch 0 bitwise the thread batch 0; a process-mode
             get_state after the window, a fresh process pipeline and
             set_state continue bitwise for 3 batches;
8. train_parity — a seeded CenterNet (width 64) on make_example_batch, on
             the card and on the CPU (the port's plain path): loss, heads
             and parameter gradients within the bf16 tolerances stated in
             TRAIN_TOL; and the ragged gather's backward at the main path's
             shapes with many duplicate indices, twice on the card: both
             bitwise equal to each other and to the CPU's;
   affine_sizes — AffineTransformer on a batch of mixed image_hw (sizes
             per sample, nothing read back): points, projection matrices and
             the rewritten sizes on the card against the CPU run, under
             torch.cuda.set_sync_debug_mode("error");
9. train   — the training path at full width: build_train_pipeline (raw
             frames, 6 cameras x batch 8, heatmap 10x64x176) ->
             batch_to_train_inputs of all cameras (48 images) ->
             make_train_step(CenterNetDetector(10, width=64)): 20 steps on
             fresh batches (every loss finite), 30 steps on one cached batch
             (the loss falls below its first value; device time per step
             with CUDA events, peak memory, conv FLOPs per second as a share
             of the bf16 peak), then one step under
             torch.cuda.set_sync_debug_mode("error");
10. input_idle — bench_pipeline.measure_input_idle(pipe, 6, n_iters=IDLE_ITERS,
             width=64) on the YUV wire (WIRE_DECODER, with its counts), on
             raw frames and on the DCT wire: t_e2e, t_comp, idle and the
             pipeline's input_bound_frac of each;
11. petr_parity — the full-width motion-aware streaming PETR (128 queries,
             64 memory slots, dim 128, 3 layers) with the same weights
             (numpy arrays through load_jax_params) on the card and on the
             CPU: forward outputs, loss, the gradients of one step and the
             propagated (memory, memory_ref) within PETR_TOL;
12. petr   — train_petr_e2e's streaming loop at that width, fed in drive
             order by the YUV-wire pipeline (SequenceSampler, 160 drives of
             40 frames; 8 x 6 cameras of 256x704): 10 steps of the example's
             loop (a loss read back per step), 10 fed steps timed with CUDA
             events, one step under the sync check, 10 steps on a cached
             batch; every loss finite, memory_ref non-zero after step 1,
             peak memory, and the example's evaluation (decode_detections_3d,
             centre-distance mAP on 0.5/1/2/4 m) finite in [0, 1];
13. matching — the CUDA auction kernel against its plain version, bitwise in
             col_of_row, rounds and both compacted RaggedBatches, on (a)
             examples/batched_loss_computation.py's data and cost (8 x 48 x
             300), (b) the petr phase's shape (8 x 32 x 192, its last step's
             outputs as test data) and (c) the edge cases
             (matching_edge_cases); the gap to scipy's Hungarian optimum
             on (a) and (b), held within R * eps; rounds per sample; kernel
             and plain ms (medians of 50 and 10) beside the bound; scipy's
             host ms; µs per round of the slowest sample; one call under the
             sync check;
14. matched_loss — batched_loss_computation's full iteration at the
             example's width (8 x 48 x 300, head dim 256): the step with
             matches from the CUDA auction inside it and the step after the
             host Hungarian loop, their losses within 1e-5, each timed with
             CUDA events (median of MATCHED_STEPS); the device form under
             the sync check (the host form synchronises: it reads the cost
             back); the device form's matches equal to the plain auction's;
15. serving — CenterNetDetector(10, width=64) with seeded weights at 256x704:
             two asynchronous checkpoints (keep=2), the latest restored
             bitwise; batch-polymorphic torch.export artifacts of the forward
             + decode_detections with float, int8 and int4 (group 64)
             weights: file bytes, params_nbytes, the float artifact's heads
             within TRAIN_TOL of the live module (and whether bitwise), each
             quantized artifact within TRAIN_TOL of its in-process
             dequantized model, int8 within QUANT_TOL of the float module
             (int4's drift reported: INT4_NOTE); ms per batch of the artifact
             per bucket (1, 2, 4, 8; CUDA events, median of SERVE_ITERS),
             images/s and the 8-over-1 amortization, one call under the sync
             check; the InferenceServer (4 clients x 25 requests, depth 2,
             3 ms window): requests/s, client p50/p95, the bucket histogram,
             every request bitwise a direct call of the artifact on its
             stacked batch, and within TRAIN_TOL of a batch-1 call;
16. export  — bench.py's pipeline on the DCT wire at full width delivers 2
             batches; the last host batch's device stage is exported
             (build/preprocess.accvserve), reloaded and run on that batch's
             leaves with its key: every output leaf bitwise
             run_device_stage's, the rasterizer launched once per call
             through the registered operator; the artifact's and the eager
             stage's device ms (stream held, EXPORT_TIMED reps) and launches
             (profiler); the chained path on the two files alone
             (preprocessed 48 images -> the serving artifact) bitwise the
             in-process composition; device_program_text() naming every
             device step;
17. polyline — scripts/bench_polyline.py's grid (batch 1, 64 x points 10,
             100, 1000 x distances 10, 100, 1000; its cases and seeds, from
             scripts/torch_bench_polyline.py): interpolate on the card against
             the port on the CPU and the float64 numpy restatement, within
             8 * eps_f32 * the longest polyline; ms per call (CUDA events,
             POLY_K calls chained through the previous output, median of
             POLY_REPS) beside numpy's host ms, launches per call (profiler);
             the var-size forms on 64 polylines of 2-1000 points; one call of
             each under the sync check;
18. lane   — lane_regression_training.run's loop at the example's width
             (batch 32, 32x32 rasters, 8 control points, 16 arc-length
             samples, 150 steps, Adam 3e-3) from seeded parameters: the last
             loss below half the first, the first LANE_PARITY_STEPS losses
             within LANE_TOL of a CPU run from the same parameters; device ms
             and launches per step; one step under the sync check;
19. bev    — BEVBBoxesTransformer3D over a seeded 3-D provider (batch 8 x 64
             boxes, 6 cameras' projection @ extrinsics, ego<->world) with
             StreamPETR's nuScenes rotation and scaling and a translation whose
             z range is constant: BEV_BATCHES batches through run(), one host
             batch's stage on the card (sync check) and on the CPU within
             BEV_TOL, the JAX test's invariants, the exported stage bitwise
             the eager one, device ms and launches per batch;
20. elastic — the elastic stanza of examples/preemptible_training.py: a
             2-shard fleet takes 2 steps, elastic_reshard to 3 shards drains
             the epoch (28 distinct samples), then 2 -> 3 -> 1 (all 32 once),
             the images normalized on the card;
21. tools  — bench.py's main path (DCT wire, full width) with TraceRangeWrapper
             ranges (sync_on_pop) around the consumer's batch, forward and
             gradients under torch.profiler: every range in the trace, each
             closing after the device work it launched; TensorDumper dumps the
             last batch and its CenterNet gradients, compares them clean, a
             value within eps clean, and reports one moved one ulp past eps;
22. mesh   — the main path on a mesh: make_mesh() (one rank over NCCL, a
             (1, 1) mesh; host_shard_info, shard_batch and shard_like_batch
             on the main path's leaves), bench.py's pipeline at full width on
             the DCT wire through get_pipeline(mesh=): MESH_CHECK_BATCHES
             batches whose every leaf is a DTensor sharded over data, its full
             tensor bitwise the unsharded pipeline's batch; two pairs of
             MESH_BATCHES-batch windows in turns with unsharded ones
             (frames/s, the median ratio, beside main's; shard_batch's ms per
             batch); pipeline_loss and pipeline_apply on (data 1,
             pipe 1) against the sequential application (MESH_PP_RTOL); the
             preemptible trainer's resume, bitwise; its checkpoint and a
             sharded one restored onto DTensor templates, bitwise;
23. the {"kernels": [...]} line, the nvidia-smi line, and last the result
   line {"ok": true, "device": {...}}.

The pipeline phases (main, main_yuv, main_frames, echo, det2d, workers, train, input_idle,
petr, export, tools, mesh) each count the rasterizer's launches from 0 and fail unless it ran
once per delivered pipeline batch; the kernels line's draw_gaussians launches are main's,
det2d's, export's, tools' and mesh's. The encoded JPEGs are kept in build/bench_cache (bench.py's
cache format) for the phases after the first.

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

from accvlab_tpu_torch.tools.launch_counts import kernel_counts

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# float32 operations of one repro_exp.exp_f32: a Dekker product is 17, a
# 2Sum 6; the reduction takes one product, each of the 6 Horner steps two
# products, one 2Sum and 3 additions
EXACT_EXP_FLOPS = 282
SLEEP_CYCLES = 4_000_000  # about 2 ms of the card's clock: longer than any enqueue here
# about 20 ms of the card's clock: longer than the host takes to enqueue the DCT decode
DECODE_SLEEP_CYCLES = 40_000_000
N_TIMED = 50
N_TIMED_PLAIN = 10
MAIN_WINDOWS = 3
MAIN_WINDOW_BATCHES = 100
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
TRAIN_FRESH_STEPS = 20
TRAIN_CACHED_STEPS = 30
IDLE_ITERS = 50
ECHO_BATCHES = 100
RESUME_BATCHES = 3
PETR_FRESH_STEPS = 10
PETR_TIMED_STEPS = 10
PETR_CACHED_STEPS = 10
MATCHED_STEPS = 20
# the YUV wire's host decoder: libjpeg (a host without a system libjpeg
# links the libjpeg-turbo in Pillow's wheel; the build line names it)
WIRE_DECODER = "native"
# the full-width PETR, card against CPU: bf16 attention and MLPs (a bf16
# rounding is 2^-8 of a value; the two sides sum the products in different
# orders). Outputs and memory relative to the largest magnitude of each
# tensor; gradients as the norm of the difference over the norm of the CPU's
# (the box L1 term's slope flips sign where a prediction lies within
# rounding of its target, which moves single gradient entries by their
# whole size); the propagated memory compared on the queries both sides
# chose (topk_gap: how far below the other side's cut a query chosen by one
# side only may score)
PETR_TOL = {"loss": 2e-2, "outputs": 3e-2, "grads": 1e-1, "grad_cosine": 0.99,
            "memory": 3e-2, "memory_ref": 3e-2, "topk_gap": 1e-2}
# the YUV wire's planes of one batch before the codec: 48 Y planes of 256x704
# and 48 CbCr planes of 128x352x2
UNPACKED_PLANE_BYTES = 48 * (256 * 704 + 128 * 352 * 2)
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "bench_cache")
# card against CPU, same weights and batch, both with bf16 convs: a bf16
# rounding is 2^-8 of a value, and the two sides accumulate the convs in
# different orders, so some roundings land one step apart and propagate.
# Errors are relative to the largest magnitude of each tensor.
TRAIN_TOL = {"loss": 2e-2, "heads": 3e-2, "grads": 1e-1, "grad_cosine": 0.99}
GOLDENS = os.path.join("tests", "data", "goldens", "heatmap_goldens.npz")
SOURCE = "accvlab_tpu_torch/heatmap/csrc/draw_heatmap.cu"
AUCTION_SOURCE = "accvlab_tpu_torch/ragged/csrc/auction_matching.cu"
# the widths of det2d, steps_2d and workers: bench.py's
WIDTH = {"hw": (372, 1024), "out_hw": (256, 704), "heatmap_hw": (64, 176), "cams": 6,
         "batch": 8}
DET2D_BATCHES = 100  # det2d's timed window
STEPS_2D_BATCHES = 5
# about 400 ms of the card's clock: longer than the host takes to enqueue
# steps_2d's device stage (45-189 ms on an H100 host)
STEPS_2D_SLEEP_CYCLES = 800_000_000
# each workers window: four windows and four process pools (9-14 s each
# to start on an 8-core H100 host) make this phase the script's dearest
WORKER_BATCHES = 30
# det2d's images, card against CPU: both sides run the port's own DCT
# decode, whose planes agree (dct_wire), so only the colour conversion, the
# warp and the distortion's float order differ: within 1 uint8 level, in at
# most this share of the values
DET2D_IMAGE_LEVELS = 1
DET2D_IMAGE_SHARE = 1e-3
# the executor's trace: producer spans, consumer spans, instants
TRACE_NAMES = ("host_build", "queue_put", "consumer_wait", "device_dispatch", "epoch_end",
               "reset")


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
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


def timed_windows(pipe, windows: int, batches: int):
    """Seconds of each of ``windows`` back-to-back windows of ``batches``
    run() calls, each ended by a synchronise; returns them and the last
    output."""
    window_s, out = [], None
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(batches):
            out = pipe.run()
        torch.cuda.synchronize()
        window_s.append(time.perf_counter() - t0)
    return window_s, out


def packer_of(pipe):
    from accvlab_tpu_torch.pipeline.processing_steps import DCTWirePacker, WirePlanePacker

    return next(s for s in pipe._host_steps if isinstance(s, (DCTWirePacker, WirePlanePacker)))


def main_phase(dev, card: str, wire: str = "dct"):
    """The main path on ``wire`` ("dct": the phase ``main``, 3 windows and
    the plain heatmap recompute; "yuv": ``main_yuv``, one window)."""
    from accvlab_tpu_torch.bench_pipeline import build_pipeline
    from accvlab_tpu_torch.heatmap import LAUNCHES, reset_launch_counts

    batch, num_cams = 8, 6
    kw = dict(batch_size=batch, device=dev, cache_dir=CACHE_DIR, wire=wire)
    if wire == "yuv":
        kw["decoder"] = WIRE_DECODER
    windows = MAIN_WINDOWS if wire == "dct" else 1
    phase = "main" if wire == "dct" else f"main_{wire}"
    t0 = time.perf_counter()
    pipe = build_pipeline(**kw)
    setup_s = time.perf_counter() - t0
    first = {k: v.clone() for k, v in pipe.run().items()}  # batch 0, kept for the plain recompute
    pipe.run()
    torch.cuda.synchronize()

    # back-to-back windows of MAIN_WINDOW_BATCHES batches each, on one
    # pipeline: frames/s is reported per window, with their median
    reset_launch_counts()
    window_s, out = timed_windows(pipe, windows, MAIN_WINDOW_BATCHES)
    n_batches = windows * MAIN_WINDOW_BATCHES
    launches = LAUNCHES["draw_gaussians"]
    main_launches = dict(LAUNCHES)
    stats = pipe.stats()
    packer = packer_of(pipe)
    wire_stats = packer.last_batch_stats
    pipe.stop()
    if launches != n_batches:
        fail(f"{phase}: draw_gaussians launched {launches} times for {n_batches} batches")
    check_outputs(out, num_cams, batch)
    check_outputs(first, num_cams, batch)
    extra = {}
    if wire == "yuv":
        decoded = stats["decoded_by"]
        if decoded[WIRE_DECODER] == 0 or sum(decoded.values()) != decoded[WIRE_DECODER]:
            fail(f"{phase}: frames decoded by {decoded}, not all by {WIRE_DECODER}")
        extra = {"decoder": WIRE_DECODER, "decoded_by": decoded}
    else:
        extra = {"grouping": [list(g) for g in packer.groups],
                 "packer_seconds": packer.last_batch_seconds}
    if not 0 < stats["bytes_per_batch"] < UNPACKED_PLANE_BYTES:
        fail(f"{phase}: {stats['bytes_per_batch']} bytes per batch, not below the "
             f"{UNPACKED_PLANE_BYTES} bytes of the unpacked planes")

    worst = {}
    if wire == "dct":
        # batch 0 again, with the plain heatmap version: same host batch, same draws
        plain_pipe = build_pipeline(heatmap_implementation="torch", **kw)
        plain = plain_pipe.run()
        torch.cuda.synchronize()
        plain_pipe.stop()
        for name, v in first.items():
            w = plain[name]
            if name.endswith("heatmap"):
                ok = torch.allclose(v, w, rtol=1e-6, atol=0.0)
            else:
                ok = torch.equal(v, w)
            if not ok:
                fail(f"{phase}: {name} differs between the kernel and the plain heatmap version")
            if v.dtype.is_floating_point:
                worst[name.split(".")[-1]] = max(worst.get(name.split(".")[-1], 0.0),
                                                 float((v - w).abs().max()))
    fps = [MAIN_WINDOW_BATCHES * batch * num_cams / w for w in window_s]
    ms_per_batch = [w / MAIN_WINDOW_BATCHES * 1e3 for w in window_s]
    config = ("DCT wire, 'dp16' grouping: 6 cams x 372x1024 q90 JPEG (16 unique sets) -> "
              "256x704 on the card" if wire == "dct" else
              f"YUV 4:2:0 wire, packed: 6 cams x 372x1024 q90 JPEG (16 unique sets, decoder "
              f"{WIRE_DECODER!r} to 256x704)")
    emit({
        "phase": phase, "card": card, "wire": wire, "frames_per_s": float(np.median(fps)),
        "frames_per_s_windows": fps, "ms_per_batch": float(np.median(ms_per_batch)),
        "ms_per_batch_windows": ms_per_batch, "batches": n_batches,
        "draw_gaussians_launches": launches, "bytes_per_batch": stats["bytes_per_batch"],
        "unpacked_plane_bytes": UNPACKED_PLANE_BYTES, "packer_last_batch": wire_stats,
        "consumer_wait_s": stats["consumer_wait_s"], "device_stage_s": stats["device_stage_s"],
        "producer_busy_s": stats["producer_busy_s"], "produced": stats["produced"],
        "input_bound_frac": stats["input_bound_frac"], "plain_recompute_max_abs_err": worst,
        "setup_s": setup_s, **extra,
        "config": config + ", batch 8, heatmap 10x64x176, T=32",
    })
    return main_launches, float(np.median(fps))


def main_frames_phase(dev, card: str):
    from accvlab_tpu_torch.bench_pipeline import build_pipeline

    batch, num_cams = 8, 6
    pipe = build_pipeline(batch_size=batch, device=dev, wire="frames")
    try:
        pipe.run()
        pipe.run()
        torch.cuda.synchronize()
        (window_s, out), launches = count_launches(
            lambda: timed_windows(pipe, 1, MAIN_WINDOW_BATCHES))
        stats = pipe.stats()
    finally:
        pipe.stop()
    if launches != MAIN_WINDOW_BATCHES:
        fail(f"main_frames: draw_gaussians launched {launches} times for "
             f"{MAIN_WINDOW_BATCHES} batches")
    check_outputs(out, num_cams, batch)
    emit({"phase": "main_frames", "card": card,
          "frames_per_s": MAIN_WINDOW_BATCHES * batch * num_cams / window_s[0],
          "ms_per_batch": window_s[0] / MAIN_WINDOW_BATCHES * 1e3,
          "batches": MAIN_WINDOW_BATCHES, "draw_gaussians_launches": launches,
          "bytes_per_batch": stats["bytes_per_batch"],
          "input_bound_frac": stats["input_bound_frac"],
          "config": "raw RGB frames (2 unique sets): 6 cams x 372x1024, batch 8 -> 256x704"})


def decode_readings(run_step, reps: int = N_TIMED, sleep_cycles: int = DECODE_SLEEP_CYCLES
                    ) -> dict:
    """Device ms of ``run_step()`` (CUDA events, the stream held by a sleep
    of ``sleep_cycles`` while the host enqueues, so the events see the device
    work only; median and spread of ``reps``), its host enqueue ms beside the
    hold's own ms (the reading is clean when the enqueue is the shorter), and
    its launches."""
    run_step()  # constants on the card, allocator warm
    dev_ms, host_ms = [], []
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    torch.cuda._sleep(sleep_cycles)
    e1.record()
    torch.cuda.synchronize()
    hold_ms = e0.elapsed_time(e1)
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(sleep_cycles)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        run_step()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        e1.record()
        torch.cuda.synchronize()
        dev_ms.append(e0.elapsed_time(e1))
    return {"device_ms": float(np.median(dev_ms)), "device_ms_min": float(min(dev_ms)),
            "device_ms_max": float(max(dev_ms)), "enqueue_host_ms": float(np.median(host_ms)),
            "hold_ms": hold_ms, "launches": kernel_counts(run_step)}


def dct_wire_phase(dev, card: str):
    """One full-width host batch of the DCT wire, decoded on the card and on
    the CPU: coefficients bitwise, planes within 1; the step sync-free; its
    device time and launches per batch."""
    from accvlab_tpu_torch.bench_pipeline import build_pipeline

    pipe = build_pipeline(batch_size=8, device=dev, cache_dir=CACHE_DIR, affine_prob=0.0,
                          photometric_prob=0.0)
    try:
        host = pipe._produce_host_batch()[3]
        leaves = pipe._transfer(host)
    finally:
        pipe.stop()
    packer = packer_of(pipe)
    unpacker = pipe._device_steps[0]

    def sdg_of(values):
        sdg = pipe._host_out_blueprint.get_empty_like_self()
        sdg.set_data(list(values))
        return sdg

    _, on_card = unpacker.stacked_fields(sdg_of(leaves))
    _, on_cpu = unpacker.stacked_fields(sdg_of([torch.from_numpy(a) for a in host]))
    coef_card, coef_cpu = unpacker.coefficients(on_card.__getitem__), \
        unpacker.coefficients(on_cpu.__getitem__)
    for cs, want in coef_cpu.items():
        if not torch.equal(coef_card[cs].cpu(), want):
            fail(f"dct_wire: the integer coefficients of '{cs}' differ between card and CPU")
    planes = {}
    for name, got, want in zip(("y", "cbcr"), unpacker.decode_fields(on_card.__getitem__),
                               unpacker.decode_fields(on_cpu.__getitem__)):
        d = (got.cpu().to(torch.int32) - want.to(torch.int32)).abs()
        planes[name] = {"shape": list(want.shape), "max_abs_diff": int(d.max()),
                        "differing_share": float((d > 0).double().mean())}
        if planes[name]["max_abs_diff"] > 1:
            fail(f"dct_wire: the {name} planes on the card are {planes[name]} from the CPU's")

    # the whole step (stacking the cameras, then the decode) after a warm-up
    # call makes no copy or wait between host and card
    unpacker._process(sdg_of(leaves))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        unpacker._process(sdg_of(leaves))
    except RuntimeError as e:
        fail(f"dct_wire: the decode synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    readings = decode_readings(lambda: unpacker._process(sdg_of(leaves)))
    emit({"phase": "dct_wire", "card": card, "coefficients_bitwise_vs_cpu": True,
          "images": len(coef_cpu["y"]), "planes_vs_cpu": planes, "sync_free_decode": True,
          "decode_device_ms_per_batch": readings["device_ms"],
          "decode_device_ms_min_max": [readings["device_ms_min"], readings["device_ms_max"]],
          "decode_enqueue_host_ms": readings["enqueue_host_ms"], "hold_ms": readings["hold_ms"],
          "decode_launches_per_batch": readings["launches"], "timed": N_TIMED,
          "bytes_per_batch": int(sum(a.nbytes for a in host)),
          "wire_fields_per_batch": len(host), "grouping": [list(g) for g in packer.groups],
          "packer_last_batch": packer.last_batch_stats,
          "packer_seconds": packer.last_batch_seconds})


def wire_planes(pipe, leaves):
    """The Y and CbCr planes of one batch's leaves: decoded by
    WirePlaneUnpacker when the pipeline packs them, else as they are."""
    from accvlab_tpu_torch.pipeline.processing_steps import WirePlaneUnpacker

    sdg = pipe._host_out_blueprint.get_empty_like_self()
    sdg.set_data(list(leaves))
    if any(isinstance(s, WirePlaneUnpacker) for s in pipe._device_steps):
        sdg = WirePlaneUnpacker(["image", "image_cbcr"])._process(sdg)
    return {n: v for n, v in zip(sdg.field_names_flat, sdg.get_data())
            if n.endswith(".image") or n.endswith(".image_cbcr")}


def wire_phase(dev, card: str):
    from accvlab_tpu_torch.bench_pipeline import build_pipeline
    from accvlab_tpu_torch.color import ycbcr420_to_rgb
    from accvlab_tpu_torch.pipeline.processing_steps import WirePlaneUnpacker, YCbCrToRGBConverter

    kw = dict(batch_size=8, device=dev, cache_dir=CACHE_DIR, affine_prob=0.0,
              photometric_prob=0.0, wire="yuv", decoder=WIRE_DECODER)
    packed, raw = build_pipeline(**kw), build_pipeline(wire_pack=False, **kw)
    try:
        host_packed = packed._produce_host_batch()[3]
        host_raw = raw._produce_host_batch()[3]
        on_card = wire_planes(packed, packed._transfer(host_packed))
        on_cpu = wire_planes(packed, [torch.from_numpy(a) for a in host_packed])
        unpacked = wire_planes(raw, [torch.from_numpy(a) for a in host_raw])
        torch.cuda.synchronize()
        for name, want in unpacked.items():
            if not (torch.equal(on_card[name].cpu(), want) and torch.equal(on_cpu[name], want)):
                fail(f"wire: the decoded plane {name} differs from the unpacked plane")

        # the colour conversion on the card against its CPU run
        n_diff = n_all = worst = 0
        for c in range(6):
            y, cbcr = (unpacked[f"cameras.[{c}].{f}"] for f in ("image", "image_cbcr"))
            got = ycbcr420_to_rgb(y.to(dev), cbcr.to(dev)).cpu().to(torch.int32)
            want = ycbcr420_to_rgb(y, cbcr).to(torch.int32)
            d = (got - want).abs()
            worst, n_diff, n_all = max(worst, int(d.max())), n_diff + int((d > 0).sum()), \
                n_all + d.numel()
        if worst > 1:
            fail(f"wire: the colour conversion on the card is {worst} from the CPU's")

        # one unpack + convert pass makes no copy or wait between host and card
        leaves = packed._transfer(host_packed)
        torch.cuda.synchronize()
        sdg = packed._host_out_blueprint.get_empty_like_self()
        sdg.set_data(list(leaves))
        torch.cuda.set_sync_debug_mode("error")
        try:
            sdg = WirePlaneUnpacker(["image", "image_cbcr"])._process(sdg)
            YCbCrToRGBConverter("image")._process(sdg)
        except RuntimeError as e:
            fail(f"wire: unpack + convert synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()

        # the packed and the unpacked wire deliver the same batch, bit for bit
        a, b = packed.run(), raw.run()
        torch.cuda.synchronize()
        for name, v in a.items():
            if not torch.equal(v, b[name]):
                fail(f"wire: {name} differs between the packed and the unpacked wire")
    finally:
        packed.stop()
        raw.stop()
    emit({"phase": "wire", "card": card, "decode_bitwise_vs_unpacked_and_cpu": True,
          "planes_checked": len(unpacked), "packed_vs_unpacked_outputs_bitwise": True,
          "color_max_abs_diff_vs_cpu": worst, "color_differing_share": n_diff / n_all,
          "sync_free_unpack_convert": True})


def echo_wire(dev, wire: str) -> dict:
    """echo_factor=2 on ``wire``: a timed window, the replays differ, a
    mid-echo resume continues bitwise."""
    from accvlab_tpu_torch.bench_pipeline import build_pipeline

    batch, num_cams = 8, 6
    kw = {"decoder": WIRE_DECODER} if wire == "yuv" else {}
    build = lambda: build_pipeline(batch_size=batch, device=dev, cache_dir=CACHE_DIR,  # noqa: E731
                                   echo_factor=2, wire=wire, **kw)
    pipe = build()
    try:
        first = [{k: v.clone() for k, v in pipe.run().items()} for _ in range(2)]
        torch.cuda.synchronize()
        same_source_differs = not torch.equal(first[0]["cameras.[0].image"],
                                              first[1]["cameras.[0].image"])
        (window_s, out), launches = count_launches(
            lambda: timed_windows(pipe, 1, ECHO_BATCHES))
        stats = pipe.stats()
    finally:
        pipe.stop()
    if not same_source_differs:
        fail(f"echo ({wire}): the two replays of a host batch are equal")
    if launches != ECHO_BATCHES:
        fail(f"echo ({wire}): draw_gaussians launched {launches} times for {ECHO_BATCHES} "
             "batches")
    if stats["consumed"] != 2 * stats["transfers"]:
        fail(f"echo ({wire}): {stats['consumed']} batches delivered from {stats['transfers']} "
             "transfers")
    check_outputs(out, num_cams, batch)

    # mid-echo resume: state after 3 deliveries (the first replay of host
    # batch 1), a fresh pipeline, the next batches bit for bit
    n = 3 + RESUME_BATCHES
    ref = build()
    try:
        stream = [{k: v.clone() for k, v in ref.run().items()} for _ in range(n)]
    finally:
        ref.stop()
    pipe = build()
    try:
        for _ in range(3):
            pipe.run()
        state = json.loads(json.dumps(pipe.get_state()))
    finally:
        pipe.stop()
    if state.get("echo") != {"factor": 2, "next": 1}:
        fail(f"echo ({wire}): unexpected mid-echo state {state}")
    fresh = build()
    try:
        fresh.set_state(state)
        for i in range(3, n):
            got = fresh.run()
            for k, v in got.items():
                if not torch.equal(v, stream[i][k]):
                    fail(f"echo ({wire}): after the resume, batch {i} field {k} differs")
    finally:
        fresh.stop()
    return {"delivered_frames_per_s": ECHO_BATCHES * batch * num_cams / window_s[0],
            "ms_per_delivered_batch": window_s[0] / ECHO_BATCHES * 1e3,
            "consumed": stats["consumed"], "transfers": stats["transfers"],
            "bytes_per_transfer": stats["bytes_per_batch"], "replays_differ": True,
            "state": state, "resumed_batches_bitwise": RESUME_BATCHES,
            "draw_gaussians_launches": launches,
            **({"decoded_by": stats["decoded_by"]} if wire == "yuv" else {})}


def echo_phase(dev, card: str):
    yuv = echo_wire(dev, "yuv")
    emit({"phase": "echo", "card": card, "echo_factor": 2, **yuv, "dct": echo_wire(dev, "dct")})


def affine_sizes_phase(dev, card: str):
    """AffineTransformer with each sample's size from ``image_hw``: a batch
    of 8 whose sources have four sizes, on the card under the sync check
    (the sizes stay on the card) and on the CPU."""
    from accvlab_tpu_torch.pipeline import DType, SampleDataGroup, ScriptedRandomContext
    from accvlab_tpu_torch.pipeline.processing_steps import AffineTransformer as A

    rng = np.random.default_rng(6)
    sizes = np.array([(372, 1024), (256, 704), (480, 640), (300, 900)] * 2, np.int32)
    pts = (rng.uniform(0, 1, (8, 32, 4)) * np.tile(sizes[:, None, ::-1], 2)).astype(np.float32)
    proj = (rng.normal(size=(8, 3, 4)) * 100).astype(np.float32)
    step = A(output_hw=(256, 704), resizing_mode=A.ResizingMode.PAD,
             resizing_anchor=A.ResizingAnchor.CENTER, image_hw_field_names="image_hw",
             projection_matrix_field_names="proj", point_field_names="pts",
             transformation_steps=[A.UniformScaling(1.0, 1.05), A.Translation(1.0, [3.0, -2.0])])
    step.set_random_context(ScriptedRandomContext())  # fixed steps: no draw
    out = {}
    for d in (torch.device("cpu"), dev):
        sdg = SampleDataGroup()
        for name, dtype in (("image_hw", DType.INT32), ("pts", DType.FLOAT), ("proj", DType.FLOAT)):
            sdg.add_data_field(name, dtype)
        sdg.set_data([torch.from_numpy(a).to(d) for a in (sizes, pts, proj)])
        torch.cuda.synchronize()
        if d.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            res = step._process(sdg)
        except RuntimeError as e:
            fail(f"affine_sizes: the step synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out[d.type] = {k: res[k].cpu() for k in ("image_hw", "pts", "proj")}
    errors = {k: rel_to_max(out["cuda"][k], out["cpu"][k]) for k in ("pts", "proj")}
    if max(errors.values()) > 1e-5 or not torch.equal(out["cuda"]["image_hw"],
                                                    out["cpu"]["image_hw"]):
        fail(f"affine_sizes: the card differs from the CPU: {errors}")
    moved = out["cuda"]["pts"] - torch.from_numpy(pts)
    if torch.allclose(moved[0], moved[1]):
        fail("affine_sizes: two sizes got one transform")
    emit({"phase": "affine_sizes", "card": card, "sizes": sizes[:4].tolist(),
          "errors_rel_to_max_vs_cpu": errors, "image_hw_out": out["cuda"]["image_hw"][0].tolist(),
          "sync_free": True})


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

    batches = 1 + 2 * IDLE_ITERS  # the first, the warm-up window, the timed window
    readings = {}
    for wire in ("yuv", "frames", "dct"):
        kw = {"decoder": WIRE_DECODER} if wire == "yuv" else {}
        pipe = build_pipeline(batch_size=8, device=dev, wire=wire, cache_dir=CACHE_DIR, **kw)
        try:
            res, launches = count_launches(
                lambda: measure_input_idle(pipe, 6, n_iters=IDLE_ITERS, width=64))
            stats = pipe.stats()
        finally:
            pipe.stop()
        if launches != batches:
            fail(f"input_idle ({wire}): draw_gaussians launched {launches} times for "
                 f"{batches} batches")
        readings[wire] = {"t_e2e_ms": res["t_e2e_s"] * 1e3, "t_comp_ms": res["t_comp_s"] * 1e3,
                          "idle": res["idle"], "input_bound_frac": stats["input_bound_frac"],
                          "draw_gaussians_launches": launches,
                          **({"decoder": WIRE_DECODER, "decoded_by": stats["decoded_by"]}
                             if wire == "yuv" else {})}
    emit({"phase": "input_idle", "card": card, "n_iters": IDLE_ITERS, **readings["yuv"],
          "frames": readings["frames"], "dct": readings["dct"]})


# --------------------------------------------------------------------- #
# the 2-D detection example, the 2-D steps, the process workers         #
# --------------------------------------------------------------------- #


def trace_check(doc: dict, phase: str) -> dict:
    """Every span name of the executor's trace present, each span's start
    before its end; returns the count of each event name."""
    counts = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "M":
            continue
        counts[e["name"]] = counts.get(e["name"], 0) + 1
        if e["ph"] == "X" and not (e["ts"] >= 0.0 and e["dur"] >= 0.0):
            fail(f"{phase}: span {e['name']} has start {e['ts']} and duration {e['dur']}")
    missing = set(TRACE_NAMES) - set(counts)
    if missing:
        fail(f"{phase}: the trace lacks {sorted(missing)} (has {counts})")
    return counts


def levels_vs(got: torch.Tensor, want: torch.Tensor, std) -> dict:
    """Normalized images as uint8 levels (times each channel's std): the
    largest difference and the share of values that differ."""
    d = (got.cpu().double() - want.double()).abs() * torch.tensor(std, dtype=torch.float64)
    return {"max_levels": float(d.max()), "differing_share": float((d > 1e-3).double().mean())}


def det2d_phase(dev, card: str):
    """The 2-D detection example's counterpart at bench.py's full width,
    through its StructuredOutputIterator (DataLoader-masked), on its DCT
    wire: 2 warm-up batches, one timed window of DET2D_BATCHES, the epoch's
    end and the next epoch's first batch, with the Stopwatch and the trace;
    batch 0 recomputed on the CPU."""
    from accvlab_tpu_torch.heatmap import LAUNCHES, reset_launch_counts
    from accvlab_tpu_torch.object_detection_2d_pipeline import (
        BenchNuScenesProvider,
        build_pipeline,
    )
    from accvlab_tpu_torch.tools import Stopwatch

    batch, cams = WIDTH["batch"], WIDTH["cams"]
    n_epoch = 2 + DET2D_BATCHES  # the warm-up batches, then the window: one epoch
    kw = dict(batch_size=batch, wire="dct", image_hw=WIDTH["hw"], out_hw=WIDTH["out_hw"],
              heatmap_hw=WIDTH["heatmap_hw"], num_threads=os.cpu_count() or 8)
    provider = BenchNuScenesProvider(num_samples=n_epoch * batch, image_hw=WIDTH["hw"],
                                     num_cameras=cams, cache_dir=CACHE_DIR)
    t0 = time.perf_counter()
    loader, pipe = build_pipeline(device=dev, provider=provider, **kw)
    setup_s = time.perf_counter() - t0
    if not isinstance(loader, torch.utils.data.DataLoader) or len(loader) != n_epoch:
        fail(f"det2d: the loader is not a DataLoader of {n_epoch} batches")
    Stopwatch._reset_singleton()
    sw = Stopwatch()
    sw.enable(num_warmup_iters=2, print_every_n_iters=None, do_device_sync=True)
    trace_path = os.path.join(os.path.dirname(CACHE_DIR), "det2d_trace.json")
    torch.cuda.synchronize()
    reset_launch_counts()
    pipe.start_trace()
    try:
        it = iter(loader)
        first = None
        for i in range(n_epoch):
            if i == 2:
                torch.cuda.synchronize()
                t_win = time.perf_counter()
            sw.start_meas("batch")
            b = next(it)
            sw.end_meas("batch")
            sw.finish_iter()
            if i == 0:
                first = {k: v.clone() for k, v in flat_outputs(b).items()}
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t_win
        last = flat_outputs(b)
        try:
            next(it)
            fail("det2d: the epoch did not end after its batches")
        except StopIteration:
            pass
        next(iter(loader))  # the iterator front resets: the next epoch's first batch
        torch.cuda.synchronize()
        launches = LAUNCHES["draw_gaussians"]
        trace = pipe.stop_trace()
        stats = pipe.stats()
    finally:
        pipe.stop()
    trace.save(trace_path)
    counts = trace_check(trace.to_dict(), "det2d")
    delivered = n_epoch + 1
    if launches != delivered:
        fail(f"det2d: draw_gaussians launched {launches} times for {delivered} batches")
    if counts["device_dispatch"] != delivered or counts["consumer_wait"] != delivered:
        fail(f"det2d: the trace has {counts} for {delivered} delivered batches")
    check_det2d_outputs(last, cams, batch)

    # batch 0 on the CPU: the same host batch, the same draws (the device
    # context's generator is a CPU one)
    cpu_loader, cpu_pipe = build_pipeline(device="cpu", provider=provider, **kw)
    try:
        ref = flat_outputs(next(iter(cpu_loader)))
    finally:
        cpu_pipe.stop()
    std = [57.4, 57.1, 58.4]
    images, worst = {}, {}
    for name, want in ref.items():
        got = first[name]
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"det2d: {name} is {tuple(got.shape)} {got.dtype} on the card, "
                 f"{tuple(want.shape)} {want.dtype} on the CPU")
        if name.endswith(".image"):
            images[name] = levels_vs(got, want, std)
            if (images[name]["max_levels"] > DET2D_IMAGE_LEVELS + 1e-3
                    or images[name]["differing_share"] > DET2D_IMAGE_SHARE):
                fail(f"det2d: {name} differs from the CPU by {images[name]}")
        elif name.endswith("heatmap"):
            if not torch.allclose(got.cpu(), want, rtol=1e-6, atol=0.0):
                fail(f"det2d: {name} differs from the CPU beyond rtol 1e-6")
            worst["heatmap"] = max(worst.get("heatmap", 0.0),
                                   float((got.cpu() - want).abs().max()))
        elif got.dtype.is_floating_point:
            err = float((got.cpu() - want).abs().max())
            worst[name.split(".")[-1]] = max(worst.get(name.split(".")[-1], 0.0), err)
            if err > 1e-5:
                fail(f"det2d: {name} differs from the CPU by {err}")
        elif not torch.equal(got.cpu(), want):
            fail(f"det2d: {name} differs from the CPU")
    fps = DET2D_BATCHES * batch * cams / window_s
    emit({"phase": "det2d", "card": card, "frames_per_s": fps,
          "ms_per_batch": window_s / DET2D_BATCHES * 1e3, "batches": DET2D_BATCHES,
          "stopwatch_batch_ms": sw.get_mean_time("batch") * 1e3,
          "stopwatch_batches": sw.get_num_nonwarmup_iters_measured(),
          "draw_gaussians_launches": launches, "delivered": delivered,
          "trace_events": counts, "trace": os.path.relpath(trace_path),
          "bytes_per_batch": stats["bytes_per_batch"], "producer_busy_s": stats["producer_busy_s"],
          "consumer_wait_s": stats["consumer_wait_s"], "device_stage_s": stats["device_stage_s"],
          "input_bound_frac": stats["input_bound_frac"], "setup_s": setup_s,
          "cpu_recompute": {"images_levels": max(v["max_levels"] for v in images.values()),
                            "images_differing_share": max(v["differing_share"]
                                                          for v in images.values()),
                            "max_abs_err": worst},
          "config": "object_detection_2d_pipeline at bench width: 6 cams x 372x1024 q90 JPEG "
                    "(bench.py's 16 sets, 32 boxes of 10 classes), DCT wire (dp16 over 3 "
                    "JPEGs), batch 8 -> 256x704, heatmap 10x64x176, StructuredOutputIterator"})
    return launches


def flat_outputs(batch) -> dict:
    """A structured (nested dict) batch as ``{"cameras.0.image": tensor}``."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            out[prefix[:-1]] = node

    walk(batch, "")
    return out


def check_det2d_outputs(out: dict, cams: int, batch: int) -> None:
    h, w = WIDTH["hw"]
    for c in range(cams):
        p = f"cameras.{c}."
        img, hm = out[p + "image"], out[p + "annotations.heatmap"]
        if tuple(img.shape) != (batch, *WIDTH["out_hw"], 3) or img.device.type != "cuda":
            fail(f"det2d: {p}image is {tuple(img.shape)} on {img.device}")
        if tuple(hm.shape) != (batch, 10, *WIDTH["heatmap_hw"]) or float(hm.max()) != 1.0:
            fail(f"det2d: {p}heatmap is {tuple(hm.shape)}, max {float(hm.max())}")
        if not torch.isfinite(img).all():
            fail(f"det2d: {p}image has non-finite values")
        hw = out[p + "image_hw"]
        if hw.shape != (batch, 2) or not bool((hw[:, 0] == h).all() & (hw[:, 1] == w).all()):
            fail(f"det2d: {p}image_hw is {hw[0].tolist()}, not the JPEG's {h}x{w}")


def steps_2d_provider(num_samples: int):
    """bench.py's raw frames (6 cameras of 372x1024, 32 boxes of 10 classes)
    with a depth per box, for the ``steps_2d`` pipeline."""
    from accvlab_tpu_torch.pipeline import DType, SampleDataGroup
    from accvlab_tpu_torch.pipeline.inputs import MultiCameraSyntheticProvider

    class WithDepths(MultiCameraSyntheticProvider):
        @property
        def sample_data_structure(self):
            cam = SampleDataGroup()
            cam.add_data_field("image", DType.UINT8)
            cam.add_data_field("image_hw", DType.INT32)
            ann = SampleDataGroup()
            for name, t in (("bboxes", DType.FLOAT), ("categories", DType.INT32),
                            ("depths", DType.FLOAT)):
                ann.add_data_field(name, t)
            cam.add_data_group_field("annotations", ann)
            root = SampleDataGroup()
            root.add_data_group_field_array("cameras", cam, WIDTH["cams"])
            return root

        def get_data(self, sample_index):
            sdg = super().get_data(sample_index)
            rng = np.random.default_rng(10_000 + sample_index)
            for c in range(WIDTH["cams"]):
                sdg["cameras"][c]["annotations"]["depths"] = \
                    rng.uniform(1.0, 80.0, 32).astype(np.float32)
            return sdg

    return WithDepths(num_samples=num_samples, num_unique=2, hw=WIDTH["hw"],
                      num_cams=WIDTH["cams"])


def steps_2d_definition(provider, buckets):
    """The pipeline of ``steps_2d``: every step this slice ported."""
    from accvlab_tpu_torch.pipeline import PipelineDefinition
    from accvlab_tpu_torch.pipeline.inputs import ShuffledShardedInputCallable
    from accvlab_tpu_torch.pipeline.processing_steps import (
        AffineTransformer as A,
        AnnotationElementConditionEval,
        AxesLayoutSetter,
        ConditionalElementRemover,
        CoordinateCropper,
        DataGroupArrayWithNameElementsAppliedStep,
        ImageToTileSizePadder,
        PaddingToUniform,
        PointsInRangeCheck,
        TensorSizeAdder,
        UnneededFieldRemover,
        VisibleBboxSelector,
    )

    border = A.ShiftToAlignWithOriginalImageBorder
    out_x, out_y = WIDTH["out_hw"][1] - 1.0, WIDTH["out_hw"][0] - 1.0
    steps = [
        # host, per sample
        DataGroupArrayWithNameElementsAppliedStep(VisibleBboxSelector(
            "bboxes", ("annotations", "visible"), image_hw_field_name="image_hw",
            depths_field_name="depths", minimum_bbox_size=12.0), "cameras"),
        AnnotationElementConditionEval("annotations", "keep = visible and depths < 70", False),
        ConditionalElementRemover("annotations", "keep",
                                  ["bboxes", "categories", "depths", "visible"], [0, 0, 0, 0],
                                  remove_mask_field=True),
        ImageToTileSizePadder("image", 32),
        # host, batch level
        PaddingToUniform(["bboxes", "categories", "depths", "visible"], fill_value=0,
                         size_buckets=buckets, bucket_dims=(0,)),
        # device: the wrapped AffineTransformer is the first device step, so
        # the "any" steps after it run on the batch's tensors
        DataGroupArrayWithNameElementsAppliedStep(A(
            output_hw=WIDTH["out_hw"], resizing_mode=A.ResizingMode.STRETCH,
            image_field_names="image", point_field_names="bboxes",
            transformation_steps=[
                A.NonUniformScaling(0.5, [0.9, 0.9], [1.25, 1.2]),
                A.ShiftInsideOriginalImage(0.5, True, True),
                border(0.3, border.Border.BOTTOM),
                A.Selection(1.0, [0.4, 0.3, 0.3], [
                    A.Rotation(1.0, -10.0, 10.0),
                    A.Shearing(1.0, [-6.0, -6.0], [6.0, 6.0]),
                    [A.NonUniformScaling(1.0, [0.8, 0.9], [1.1, 1.2]),
                     border(1.0, border.Border.LEFT)]]),
            ]), "cameras"),
        TensorSizeAdder("image", "_out_hw"),
        PointsInRangeCheck("bboxes", "in_view", [0.0] * 4, [out_x, out_y, out_x, out_y]),
        CoordinateCropper("bboxes", [0.0] * 4, [out_x, out_y, out_x, out_y]),
        AnnotationElementConditionEval("annotations", "usable = in_view and categories < 8",
                                       False),
        AxesLayoutSetter("image", "CHW"),
        UnneededFieldRemover(["depths"]),
    ]
    inp = ShuffledShardedInputCallable(provider, batch_size=WIDTH["batch"], shuffle=True)
    return PipelineDefinition(inp, steps, check_data_format=False,
                              copy_external_source_passthrough_outputs=False)


def steps_2d_phase(dev, card: str):
    """One full-width pipeline through every step of this slice: its host
    steps in the producer for STEPS_2D_BATCHES batches; its device stage on
    one host batch on the card (under the sync check) and on the CPU."""
    from accvlab_tpu_torch.pipeline.processing_steps import optimize_size_buckets

    batch, cams = WIDTH["batch"], WIDTH["cams"]
    provider = steps_2d_provider(num_samples=batch * (STEPS_2D_BATCHES + 4))
    # buckets from the kept-box counts of a probe of 16 samples
    probe_def = steps_2d_definition(provider, None)
    probe = probe_def.get_pipeline(batch_size=batch, num_threads=os.cpu_count() or 8,
                                   device="cpu")
    try:
        counts = []
        for _ in range(2):
            host = probe._produce_host_batch()[3]
            names = probe._host_out_blueprint.field_names_flat
            counts += [int(host[names.index(f"cameras.[{c}].annotations.visible")].shape[1])
                       for c in range(cams)]
    finally:
        probe.stop()
    buckets = optimize_size_buckets(counts + [32], 3)
    definition = steps_2d_definition(provider, buckets)
    threads = os.cpu_count() or 8
    pipe = definition.get_pipeline(batch_size=batch, num_threads=threads, device=dev, seed=2)
    try:
        t0 = time.perf_counter()
        outs = [pipe.run() for _ in range(STEPS_2D_BATCHES)]
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        stats = pipe.stats()
    finally:
        pipe.stop()
    # one host batch (a pipeline whose producer never started) through the
    # device steps on the card and on the CPU
    pipe = definition.get_pipeline(batch_size=batch, num_threads=threads, device=dev, seed=2)
    cpu = definition.get_pipeline(batch_size=batch, num_threads=threads, device="cpu", seed=2)
    try:
        batch_idx, _, _, host = pipe._produce_host_batch()
        leaves = pipe._transfer(host)
        pipe.run_device_stage(leaves, batch_idx)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = pipe.run_device_stage(leaves, batch_idx)
        except RuntimeError as e:
            fail(f"steps_2d: the device steps synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        want = cpu.run_device_stage([torch.from_numpy(a) for a in host], batch_idx)
        readings = decode_readings(lambda: pipe.run_device_stage(leaves, batch_idx), reps=10,
                                   sleep_cycles=STEPS_2D_SLEEP_CYCLES)
    finally:
        pipe.stop()
        cpu.stop()
    names = pipe.output_names
    errors = {"image_levels": 0, "image_differing_share": 0.0, "bboxes_rel": 0.0}
    for name, g, w in zip(names, got, want):
        g = g.cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"steps_2d: {name} is {tuple(g.shape)} {g.dtype} on the card, "
                 f"{tuple(w.shape)} {w.dtype} on the CPU")
        if name.endswith(".image"):
            d = (g.to(torch.int32) - w.to(torch.int32)).abs()
            errors["image_levels"] = max(errors["image_levels"], int(d.max()))
            errors["image_differing_share"] = max(errors["image_differing_share"],
                                                  float((d > 0).double().mean()))
        elif name.endswith("bboxes"):
            rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            errors["bboxes_rel"] = max(errors["bboxes_rel"], rel)
        elif not torch.equal(g, w):
            fail(f"steps_2d: {name} differs between the card and the CPU")
    if errors["image_levels"] > 1 or errors["image_differing_share"] > 0.02 \
            or errors["bboxes_rel"] > 1e-6:
        fail(f"steps_2d: the card differs from the CPU beyond the CPU tests' tolerances: {errors}")
    out = outs[-1]
    img = out["cameras.[0].image"]
    if tuple(img.shape) != (batch, 3, *WIDTH["out_hw"]) or "cameras.[0].annotations.depths" in out:
        fail(f"steps_2d: unexpected outputs {tuple(img.shape)}, {sorted(out)[:6]}")
    if out["cameras.[0].image_out_hw"].cpu().tolist() != [list(WIDTH["out_hw"])] * batch:
        fail(f"steps_2d: TensorSizeAdder did not record the warped {WIDTH['out_hw']}")
    emit({"phase": "steps_2d", "card": card, "buckets": buckets,
          "kept_boxes_probe": sorted(counts),
          "boxes_per_camera": int(out["cameras.[0].annotations.bboxes"].shape[1]),
          "batches": STEPS_2D_BATCHES, "ms_per_batch": run_s / STEPS_2D_BATCHES * 1e3,
          "producer_busy_ms_per_batch": stats["producer_busy_s"] / max(stats["produced"], 1) * 1e3,
          "device_ms_per_batch": readings["device_ms"],
          "device_ms_min_max": [readings["device_ms_min"], readings["device_ms_max"]],
          "device_busy_ms_per_batch": readings["launches"]["busy_ms"],
          "enqueue_host_ms": readings["enqueue_host_ms"], "hold_ms": readings["hold_ms"],
          "launches_per_batch": readings["launches"], "vs_cpu": errors,
          "sync_free_device_steps": True,
          "config": "raw frames 6 cams x 372x1024 (32 boxes + depths), batch 8: host "
                    "VisibleBboxSelector (per camera), condition eval + remover, tile pad to 32, "
                    "PaddingToUniform (DP buckets); device AffineTransformer per camera (shifts, "
                    "Selection of rotation / shear / scaling) -> 256x704, TensorSizeAdder, "
                    "PointsInRangeCheck, CoordinateCropper, condition eval, CHW, field remover"})


def workers_wire(dev, wire: str) -> dict:
    """``wire`` with thread and with process workers: one timed window
    each; the process batch 0 bitwise the thread batch 0; a process-mode
    get_state after the window, a fresh process pipeline and set_state
    continue bitwise for RESUME_BATCHES batches."""
    from accvlab_tpu_torch.bench_pipeline import build_pipeline

    batch, cams = WIDTH["batch"], WIDTH["cams"]
    kw = dict(batch_size=batch, device=dev, cache_dir=CACHE_DIR, wire=wire, hw=WIDTH["hw"],
              num_cams=cams, out_hw=WIDTH["out_hw"], heatmap_hw=WIDTH["heatmap_hw"],
              **({"decoder": WIRE_DECODER} if wire == "yuv" else {}))
    res, kept = {}, {}
    for mode in ("thread", "process"):
        t0 = time.perf_counter()
        pipe = build_pipeline(worker_mode=mode, **kw)
        try:
            kept[mode] = {k: v.clone() for k, v in pipe.run().items()}
            pipe.run()
            torch.cuda.synchronize()
            start_s = time.perf_counter() - t0
            stats0 = pipe.stats()
            (window_s, out), launches = count_launches(
                lambda: timed_windows(pipe, 1, WORKER_BATCHES))
            stats = pipe.stats()
            if mode == "thread":
                kept["after"] = [{k: v.clone() for k, v in pipe.run().items()}
                                 for _ in range(RESUME_BATCHES)]
            else:
                state = json.loads(json.dumps(pipe.get_state()))
        finally:
            pipe.stop()
        if launches != WORKER_BATCHES:
            fail(f"workers ({wire}, {mode}): draw_gaussians launched {launches} times for "
                 f"{WORKER_BATCHES} batches")
        check_outputs(out, cams, batch)
        n = stats["consumed"] - stats0["consumed"]
        busy = stats["producer_busy_s"] - stats0["producer_busy_s"]
        res[mode] = {
            "frames_per_s": WORKER_BATCHES * batch * cams / window_s[0],
            "ms_per_batch": window_s[0] / WORKER_BATCHES * 1e3,
            "consumer_ms_per_batch": (stats["device_stage_s"] - stats0["device_stage_s"]) / n * 1e3,
            "consumer_wait_ms_per_batch":
                (stats["consumer_wait_s"] - stats0["consumer_wait_s"]) / n * 1e3,
            "producer_busy_ms_per_batch": busy / (stats["produced"] - stats0["produced"]) * 1e3,
            "input_bound_frac": stats["input_bound_frac"], "start_s": start_s,
            "draw_gaussians_launches": launches}
    for k, v in kept["thread"].items():
        if not torch.equal(v, kept["process"][k]):
            fail(f"workers ({wire}): process-mode batch 0 field {k} differs from thread mode")
    fresh = build_pipeline(worker_mode="process", **kw)
    try:
        fresh.set_state(state)
        for i in range(RESUME_BATCHES):
            for k, v in fresh.run().items():
                if not torch.equal(v, kept["after"][i][k]):
                    fail(f"workers ({wire}): after the process-mode resume, batch {i} field {k} "
                         "differs")
    finally:
        fresh.stop()
    return {**res, "process_batch0_bitwise_thread": True, "state": state,
            "resumed_batches_bitwise": RESUME_BATCHES}


def workers_phase(dev, card: str):
    emit({"phase": "workers", "card": card, "batches": WORKER_BATCHES,
          "workers": os.cpu_count(), "yuv": workers_wire(dev, "yuv"),
          "dct": workers_wire(dev, "dct"), "decoder": WIRE_DECODER})


# --------------------------------------------------------------------- #
# StreamPETR and matching                                               #
# --------------------------------------------------------------------- #


def stream_petr_model():
    """The full-width motion-aware streaming PETR of the ``petr`` phase:
    128 queries, 64 memory slots, dim 128, 3 layers, 4 heads, 10 classes."""
    from accvlab_tpu_torch.models.petr import PETRDetector

    return PETRDetector(num_memory=64, motion_aware=True)


def petr_parity_inputs(seed: int = 0):
    """numpy inputs of the parity step: make_petr_example_batch's draws (2
    samples of 6 cameras of 64x176, 32 boxes, matches over all 192 slots)
    plus a memory, its reference points and the example's ego motion."""
    rng = np.random.default_rng(seed)
    memory = (rng.normal(size=(2, 64, 128)) * 0.1).astype(np.float32)
    memory_ref = rng.normal(size=(2, 64, 3)).astype(np.float32)
    ego = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    ego[:, 0, 3] = 0.5
    return memory, memory_ref, ego


def topk_agreement(out_a, out_b, k: int):
    """Propagation of two runs of one model: the top-k query sets by
    existence score, and the propagated features and centres of the queries
    both runs chose. Returns ``(queries chosen by one run only, the largest
    score gap of such a query to the other run's k-th score, max relative
    error of the common features, of the common centres)``; a query near
    the cut may fall on either side when the scores differ by rounding."""
    from accvlab_tpu_torch.models.petr import _select_topk_queries, propagate_queries_with_motion

    res = []
    for out in (out_a, out_b):
        out = {k_: v.detach().cpu() for k_, v in out.items()}
        feats, centers = propagate_queries_with_motion(out, k)
        _, idx, top = _select_topk_queries(out, k)
        res.append((feats, centers, idx, top, torch.sigmoid(out["existence"])))
    only, gap, feat_err, cen_err = 0, 0.0, 0.0, 0.0
    for s in range(res[0][2].shape[0]):
        pos = [{int(q): j for j, q in enumerate(r[2][s])} for r in res]
        for side in (0, 1):
            for q in set(pos[side]) - set(pos[1 - side]):
                only += 1
                gap = max(gap, float(res[1 - side][3][s, -1] - res[1 - side][4][s, q]))
        common = sorted(set(pos[0]) & set(pos[1]))
        ia = torch.tensor([pos[0][q] for q in common])
        ib = torch.tensor([pos[1][q] for q in common])
        feat_err = max(feat_err, rel_to_max(res[0][0][s, ia], res[1][0][s, ib]))
        cen_err = max(cen_err, rel_to_max(res[0][1][s, ia], res[1][1][s, ib]))
    return only, gap, feat_err, cen_err


def petr_parity_phase(dev):
    """Card against CPU for the full-width PETR with the same weights (numpy
    arrays through load_jax_params) and batch: forward outputs, loss, the
    gradients of one step and the propagated (memory, memory_ref)."""
    from accvlab_tpu_torch.models.params import jax_params_of, load_jax_params
    from accvlab_tpu_torch.models.petr import (_batch_loss, init_params,
                                               make_petr_example_batch)

    weights = jax_params_of(init_params(stream_petr_model(), torch.Generator().manual_seed(0)))
    memory, memory_ref, ego = petr_parity_inputs()
    res = {}
    for name, d in (("cpu", torch.device("cpu")), ("gpu", dev)):
        model = load_jax_params(stream_petr_model(), weights).to(d)
        batch = make_petr_example_batch(batch_size=2, num_cams=6, hw=(64, 176), max_gt=32,
                                        num_queries=192, device=d)
        t = lambda a: torch.from_numpy(a).to(d)  # noqa: E731
        out = model(batch["images"], t(memory), t(memory_ref), t(ego))
        loss = _batch_loss(out, batch)["loss"]
        loss.backward()
        res[name] = (loss.detach(), out, {n: p.grad for n, p in model.named_parameters()})
    loss_err = abs(float(res["gpu"][0]) - float(res["cpu"][0])) / abs(float(res["cpu"][0]))
    out_err = max(rel_to_max(res["gpu"][1][k], res["cpu"][1][k]) for k in res["cpu"][1])
    grad_err, grad_max_err, cosine, worst, key_bias = 0.0, 0.0, 1.0, None, 0.0
    for n, g_cpu in res["cpu"][2].items():
        g_gpu = res["gpu"][2][n].cpu()
        if n.endswith("attn.key.bias"):
            # the softmax is invariant to a shift shared by all keys of a
            # query, so this gradient is zero up to rounding on both sides
            key_bias = max(key_bias, float(g_gpu.abs().max()), float(g_cpu.abs().max()))
            continue
        grad_max_err = max(grad_max_err, rel_to_max(g_gpu, g_cpu))
        err = float((g_gpu.double() - g_cpu.double()).norm() / g_cpu.double().norm().clamp(
            min=1e-30))
        if err > grad_err:
            grad_err, worst = err, n
        cosine = min(cosine, float(torch.nn.functional.cosine_similarity(
            g_gpu.double().flatten(), g_cpu.double().flatten(), dim=0)))
    only, gap, feat_err, cen_err = topk_agreement(res["gpu"][1], res["cpu"][1], 64)
    errors = {"loss": loss_err, "outputs": out_err, "grads": grad_err, "grad_cosine": cosine,
              "memory": feat_err, "memory_ref": cen_err, "topk_gap": gap}
    reading = {"phase": "petr_parity", "model": "PETRDetector(num_memory=64, motion_aware=True) "
               "(128 queries, dim 128, 3 layers), 2 x 6 cameras of 64x176, 32 boxes",
               "errors": errors, "tolerance": PETR_TOL, "worst_grad": worst,
               "grads_max_entry_rel_to_max": grad_max_err,
               "key_bias_grad_max_abs": key_bias, "topk_queries_on_one_side_only": only,
               "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
               "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    for k, tol in PETR_TOL.items():
        bad = errors[k] < tol if k == "grad_cosine" else errors[k] > tol
        if bad:
            emit(reading)
            fail(f"petr_parity: {k} {errors[k]} against the CPU (tolerance {tol})")
    emit(reading)


def petr_phase(dev, card: str):
    """The full-width motion-aware streaming loop of train_petr_e2e fed by the
    YUV-wire pipeline in drive order."""
    from accvlab_tpu_torch.train_petr_e2e import (StreamTrainer, build_stream_pipeline,
                                                  run_stream_training)

    batches = PETR_FRESH_STEPS + PETR_TIMED_STEPS + 1
    pipe = build_stream_pipeline(batch_size=8, device=dev, cache_dir=CACHE_DIR,
                                 sampler_iterations=batches, decoder=WIRE_DECODER)
    trainer = StreamTrainer(stream_petr_model(), seed=0)

    def fed():
        # the example's loop, one loss read back per step (the first step
        # builds the model and warms the libraries up: not timed)
        _, losses = run_stream_training(pipe, 1, trainer)
        ref_after_1 = float(trainer.memory_ref.abs().sum())
        t0 = time.perf_counter()
        _, more = run_stream_training(pipe, PETR_FRESH_STEPS - 1, trainer)
        wall = (time.perf_counter() - t0) / (PETR_FRESH_STEPS - 1)
        # the same, timed per step on the card
        events, timed, host = [], [], time.perf_counter()
        for _ in range(PETR_TIMED_STEPS):
            batch = trainer.make_batch(pipe.run())
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            metrics = trainer.step(batch)
            e1.record()
            events.append((e0, e1))
            timed.append(float(metrics["loss"]))
        host = (time.perf_counter() - host) / PETR_TIMED_STEPS
        return losses + more + timed, ref_after_1, wall, events, host

    torch.cuda.reset_peak_memory_stats()
    (losses, ref_after_1, wall, events, fed_host_s), launches = count_launches(fed)
    fed_ms = [a.elapsed_time(b) for a, b in events]
    if launches != PETR_FRESH_STEPS + PETR_TIMED_STEPS:
        fail(f"petr: draw_gaussians launched {launches} times for "
             f"{PETR_FRESH_STEPS + PETR_TIMED_STEPS} batches")
    if not all(np.isfinite(losses)):
        fail(f"petr: non-finite loss: {losses}")
    if not ref_after_1 > 0.0:
        fail("petr: memory_ref is zero after the first step")
    images = trainer.batch["images"]
    if tuple(images.shape) != (8, 6, 256, 704, 3) or images.dtype != torch.float32:
        fail(f"petr: images of shape {tuple(images.shape)} {images.dtype}")

    # one step under the sync check: adapting the batch, labels, forward,
    # loss, backward, AdamW and the propagation
    out = pipe.run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.step(trainer.make_batch(out))
    except RuntimeError as e:
        fail(f"petr: the step synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    decoded = pipe.stats()["decoded_by"]
    pipe.stop()

    cached = trainer.batch
    cached_events = []
    for _ in range(PETR_CACHED_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        trainer.step(cached)
        e1.record()
        cached_events.append((e0, e1))
    torch.cuda.synchronize()
    cached_ms = [a.elapsed_time(b) for a, b in cached_events]
    peak_bytes = torch.cuda.max_memory_allocated()
    res = trainer.evaluate()
    if not (np.isfinite(res["mAP"]) and 0.0 <= res["mAP"] <= 1.0):
        fail(f"petr: mAP {res['mAP']} is not a finite value in [0, 1]")
    emit({
        "phase": "petr", "card": card,
        "config": "PETRDetector(num_memory=64, motion_aware=True): 128 queries + 64 memory, dim "
                  "128, 3 layers, 4 heads, 10 classes; 8 x 6 cams x 256x704 from the YUV wire "
                  f"(decoder {WIRE_DECODER!r}) in drive order (SequenceSampler, 160 drives x 40 frames); AdamW lr 2e-4 wd 1e-4; "
                  "max_gt 32",
        "losses": losses, "fed_step_device_ms": float(np.median(fed_ms)),
        "fed_step_device_ms_all": fed_ms, "fed_step_host_ms": fed_host_s * 1e3,
        "fed_loop_ms_per_step": wall * 1e3,
        "cached_step_device_ms": float(np.median(cached_ms)), "cached_step_device_ms_all": cached_ms,
        "peak_memory_bytes": peak_bytes, "memory_ref_abs_sum_after_step_1": ref_after_1,
        "mAP": res["mAP"], "mAP_by_threshold": {k: v for k, v in res.items() if k.startswith("mAP@")},
        "draw_gaussians_launches": launches, "sync_free_step": True, "decoded_by": decoded,
    })
    return trainer


def example_matching_cost(dev, seed: int = 0):
    """examples/batched_loss_computation.py's data (make_data: 8 samples, 48
    GT rows sized {16, 32, 48}, 300 predictions, 10 classes, in its draw
    order) and its cost class_cost + iou_cost, oriented (B, gt, pred) as its
    device_matching_comparison does. Returns (cost, num_valid) on ``dev``."""
    rng = np.random.default_rng(seed)
    b, max_gt, num_pred, ncls = 8, 48, 300, 10
    sizes = rng.choice([16, 32, 48], size=(b,)).astype(np.int32)
    xy = rng.uniform(0, 500, (b, max_gt, 2))
    wh = rng.uniform(20, 120, (b, max_gt, 2))
    xy_p = rng.uniform(0, 500, (b, num_pred, 2))
    wh_p = rng.uniform(20, 120, (b, num_pred, 2))
    classes = rng.integers(0, ncls, (b, max_gt)).astype(np.float32)
    rng.uniform(0.5, 1.5, (b, max_gt))  # weights_gt: drawn, unused here
    logits = rng.normal(size=(b, num_pred, ncls)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    gt = t(np.concatenate([xy, xy + wh], 2).astype(np.float32))[:, None, :, :]
    pr = t(np.concatenate([xy_p, xy_p + wh_p], 2).astype(np.float32))[:, :, None, :]
    x1, y1 = torch.maximum(gt[..., 0], pr[..., 0]), torch.maximum(gt[..., 1], pr[..., 1])
    x2, y2 = torch.minimum(gt[..., 2], pr[..., 2]), torch.minimum(gt[..., 3], pr[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area_g = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
    area_p = (pr[..., 2] - pr[..., 0]) * (pr[..., 3] - pr[..., 1])
    iou_cost = -(inter / torch.clamp(area_g + area_p - inter, min=1e-6))  # (B, pred, gt)
    probs = torch.softmax(t(logits), dim=-1)
    idx = t(classes).to(torch.int64)[:, None, :].expand(b, num_pred, max_gt)
    class_cost = -torch.gather(probs, 2, idx)
    return (class_cost + iou_cost).transpose(1, 2).contiguous(), t(sizes)


def petr_matching_cost(trainer):
    """The petr phase's shape (8, 32, 192) as test data: from the last step's
    outputs, -softmax(logits)[gt class] + L1(boxes3d, gt boxes)."""
    batch = trainer.batch
    with torch.no_grad():
        out = trainer.model(batch["images"], trainer.eval_memory, trainer.eval_memory_ref,
                            batch["ego_transform"])
    probs = torch.softmax(out["logits"], dim=-1)  # (B, Q, C)
    cls = batch["gt_classes"].tensor.to(torch.int64)  # (B, T)
    b, q, _ = probs.shape
    class_cost = -torch.gather(probs, 2, cls[:, None, :].expand(b, q, cls.shape[1]))
    l1 = (out["boxes3d"][:, :, None, :] - batch["gt_boxes"].tensor[:, None, :, :]).abs().sum(-1)
    cost = (class_cost + l1).transpose(1, 2).contiguous()  # (B, T, Q)
    return cost, batch["gt_boxes"].sample_sizes.to(torch.int32)


def matching_edge_cases(dev):
    """(name, cost, num_valid, max_iters, eps) at the auction's edges (eps
    None: the default, from the cost's span)."""
    rng = np.random.default_rng(5)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return [
        ("c1", t(rng.normal(size=(3, 1, 1)).astype(np.float32)), t(np.array([1, 0, 1], np.int32)),
         40, None),
        ("no_valid_rows", t(rng.normal(size=(2, 5, 9)).astype(np.float32)),
         t(np.zeros(2, np.int32)), 20000, None),
        ("integer_ties", t(rng.integers(0, 3, (4, 20, 25)).astype(np.float32)),
         t(np.array([20, 5, 0, 13], np.int32)), 20000, None),
        ("unconverged", t(rng.normal(size=(2, 6, 8)).astype(np.float32)),
         t(np.array([6, 4], np.int32)), 1, None),
        ("r_eq_c", t(rng.uniform(0, 10, (4, 16, 16)).astype(np.float32)),
         t(np.array([16, 16, 7, 1], np.int32)), 20000, None),
        ("cost_through_l2", t(rng.uniform(0, 1, (2, 300, 400)).astype(np.float32)),
         t(np.array([300, 150], np.int32)), 20000, None),
        # a diverging loss: NaN entries and an all-NaN valid row. argmax order
        # puts a NaN first, and a NaN bid holds its column with no winner; with
        # a fixed eps the other rows are still assigned, while the default eps
        # is NaN (the span of a cost with a NaN) and no row ever is
        ("nan_costs", t(nan_costs(rng)), t(np.array([24, 24, 10], np.int32)), 60, 0.02),
        ("nan_costs_default_eps", t(nan_costs(rng)), t(np.array([24, 24, 10], np.int32)), 20,
         None),
        # the list-driven round's risks: one bidder in a block of 8 warps; more
        # bidders than warps and than lanes; equal bids on one column (the
        # lowest row wins, the others bid again); R = C with more rows than
        # lanes; zero values of both signs (equal floats, different bits)
        ("lone_bidder", t(rng.normal(size=(2, 6, 70)).astype(np.float32)),
         t(np.array([1, 1], np.int32)), 20000, None),
        ("all_rows_bid", t(rng.normal(size=(2, 100, 120)).astype(np.float32)),
         t(np.array([100, 77], np.int32)), 20000, None),
        ("equal_bids_one_column",
         t(np.tile(rng.normal(size=(2, 1, 12)).astype(np.float32), (1, 8, 1))),
         t(np.array([8, 5], np.int32)), 20000, None),
        ("r_eq_c_wide", t(rng.uniform(0, 10, (2, 96, 96)).astype(np.float32)),
         t(np.array([96, 50], np.int32)), 20000, None),
        ("signed_zeros", t(np.where(rng.random((2, 6, 9)) < 0.5, 0.0, -0.0).astype(np.float32)),
         t(np.array([6, 4], np.int32)), 200, None),
    ]


def nan_costs(rng):
    cost = rng.uniform(0, 1, (3, 24, 64)).astype(np.float32)
    cost[rng.uniform(size=cost.shape) < 0.005] = np.nan
    cost[1, 3] = np.nan
    return cost


def matching_agrees(cost, nv, max_iters: int, eps=None, batched=None):
    """Kernel against the plain version: col_of_row, rounds and bids
    bitwise, and ``batched`` (the entry point's two RaggedBatches on the
    kernel; made here when None) equal to the plain columns compacted.
    Returns (agrees, max |col_of_row difference|, the kernel's (col_of_row,
    rounds, bids))."""
    from accvlab_tpu_torch.ragged.matching import (_compact, auction_assignment,
                                                   batched_auction_matching)

    got = auction_assignment(cost, nv, eps, max_iters, "kernel")
    want = auction_assignment(cost, nv, eps, max_iters, "torch")
    if batched is None:
        batched = batched_auction_matching(cost, nv, eps, max_iters, implementation="kernel")
    rows, cols, sizes = _compact(want[0], nv)
    torch.cuda.synchronize()
    err = float((got[0] - want[0]).abs().max()) if got[0].numel() else 0.0
    same = all(torch.equal(a, b) for a, b in zip(got, want)) and all(
        torch.equal(rb.tensor, t) and torch.equal(rb.sample_sizes, sizes)
        for rb, t in zip(batched, (rows, cols)))
    return same, err, got


def matching_phase(dev, flush, card: str, trainer):
    from scipy.optimize import linear_sum_assignment

    from accvlab_tpu_torch.ragged import _auction_kernel, batched_auction_matching
    from accvlab_tpu_torch.ragged.matching import _eps_per_sample, auction_assignment, auction_plain

    cases = {"example_48x300": example_matching_cost(dev),
             "petr_32x192": petr_matching_cost(trainer)}
    edges = matching_edge_cases(dev)
    # the entry point's own launches: one batched_auction_matching per case;
    # their outputs are the ones checked below
    torch.cuda.synchronize()
    _auction_kernel.reset_launch_counts()
    drive = {name: batched_auction_matching(cost, nv) for name, (cost, nv) in cases.items()}
    for name, cost, nv, iters, eps in edges:
        drive[name] = batched_auction_matching(cost, nv, eps, iters)
    torch.cuda.synchronize()
    launches = _auction_kernel.LAUNCHES["batched_auction_matching"]
    if launches != len(cases) + len(edges):
        fail(f"matching: the kernel launched {launches} times for {len(cases) + len(edges)} calls")

    for name, cost, nv, iters, eps in edges:
        if not matching_agrees(cost, nv, iters, eps, drive[name])[0]:
            fail(f"matching: edge case {name}: the kernel differs from the plain version")
    readings = {}
    for name, (cost, nv) in cases.items():
        same, err, (cols, rounds, bids) = matching_agrees(cost, nv, 20000, None, drive[name])
        if not same:
            fail(f"matching: {name}: the kernel differs from the plain version")
        eps = _eps_per_sample(cost, None)
        # the kernel alone (eps made beforehand), and the entry point with its
        # eps reduction
        ms = device_ms(lambda: _auction_kernel.launch_auction(cost, nv, eps, 20000), N_TIMED,
                       flush)
        entry_ms = device_ms(lambda: auction_assignment(cost, nv, implementation="kernel"),
                             N_TIMED, flush)
        plain_ms = device_ms(lambda: auction_plain(cost, nv, eps, 20000), N_TIMED_PLAIN, flush)
        b, r, c = cost.shape
        # what these inputs need: the valid rows of the cost, nv and eps read
        # once; col_of_row, rounds and bids written once; one subtraction per
        # cost entry a bid reads (a bid reads its row's C entries)
        valid_rows = int(nv.clamp(0, r).sum())
        nbytes = valid_rows * c * 4 + b * (4 + 4) + b * r * 4 + b * (4 + 4)
        ops = float(bids.sum()) * c
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
        # scipy's Hungarian on the host, for the reader, and the gap to it
        host_cost, host_nv, host_cols = cost.cpu().numpy(), nv.cpu().numpy(), cols.cpu().numpy()
        host_eps = eps.cpu().numpy()
        t0 = time.perf_counter()
        opts = [linear_sum_assignment(host_cost[s][:int(host_nv[s])]) for s in range(b)]
        scipy_ms = (time.perf_counter() - t0) * 1e3
        worst_gap, worst_bound = 0.0, 0.0
        for s, (ri, ci) in enumerate(opts):
            n = int(host_nv[s])
            if n == 0:
                continue
            mine = float(host_cost[s][np.arange(n), host_cols[s, :n]].astype(np.float64).sum())
            opt = float(host_cost[s][ri, ci].astype(np.float64).sum())
            if len(set(host_cols[s, :n].tolist())) != n or (host_cols[s, :n] < 0).any():
                fail(f"matching: {name} sample {s} is not a full one-to-one assignment")
            bound = n * float(host_eps[s])
            if mine - opt > bound + 1e-6 * abs(opt):
                fail(f"matching: {name} sample {s}: cost {mine} exceeds the optimum {opt} by more "
                     f"than R * eps = {bound}")
            worst_gap = max(worst_gap, (mine - opt) / max(abs(opt), 1e-6))
            worst_bound = max(worst_bound, bound / max(abs(opt), 1e-6))
        readings[name] = dict(
            shape=[b, r, c], rounds=rounds.cpu().tolist(), bids=bids.cpu().tolist(), ms=ms,
            us_per_round=ms * 1e3 / max(int(rounds.max()), 1),
            ns_per_bid=ms * 1e6 / max(int(bids.sum()), 1),
            entry_ms=entry_ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations", bytes=nbytes,
            operations=ops, scipy_host_ms=scipy_ms, gap_to_hungarian=worst_gap,
            gap_bound_r_eps=worst_bound, max_abs_err=err)

    # one call on card tensors makes no copy or wait between host and card
    cost, nv = cases["example_48x300"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batched_auction_matching(cost, nv, implementation="kernel")
    except RuntimeError as e:
        fail(f"matching: the kernel path synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    emit({"phase": "matching", "card": card, "cases": readings,
          "edge_cases": [c[0] for c in edges],
          "kernel_vs_plain": "bitwise (col_of_row, rounds, bids, both RaggedBatches)",
          "entry_launches": launches, "sync_free_call": True})
    return readings, launches


def matched_loss_phase(dev, card: str):
    """batched_loss_computation's full iteration at the example's width, with
    matches from the CUDA auction inside the step and from the host loop."""
    from accvlab_tpu_torch import batched_loss_computation as bl
    from accvlab_tpu_torch.ragged import _auction_kernel

    data = bl.make_data(device=dev)
    head = bl.make_head(256, 10, seed=0, device=dev)
    feat = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 300, 256))
                            .astype(np.float32)).to(dev)
    args = (data["bboxes_gt"], data["classes_gt"], data["bboxes_pred"], data["logits_pred"])

    def host_step():
        return bl.train_step(head, feat, data, bl.match(*args))

    def device_step():
        return bl.train_step(head, feat, data)

    # the device form's matches against the plain auction's, bitwise
    got, want = bl.match_on_device(*args), bl.match_on_device(*args, implementation="torch")
    torch.cuda.synchronize()
    if not all(torch.equal(a.tensor, b.tensor) and torch.equal(a.sample_sizes, b.sample_sizes)
               for a, b in zip(got, want)):
        fail("matched_loss: the device form's matches differ from the plain auction's")
    loss_host, loss_dev = float(host_step()[1]), float(device_step()[1])
    if not abs(loss_dev - loss_host) <= 1e-5 * abs(loss_host):
        fail(f"matched_loss: device-matched loss {loss_dev} against host-matched {loss_host}")

    def timed(fn):
        events, t0 = [], time.perf_counter()
        for _ in range(MATCHED_STEPS):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            events.append((e0, e1))
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / MATCHED_STEPS * 1e3
        return [a.elapsed_time(b) for a, b in events], host_ms

    host_ms, host_wall = timed(host_step)
    torch.cuda.synchronize()
    _auction_kernel.reset_launch_counts()
    dev_ms, dev_wall = timed(device_step)
    launches = _auction_kernel.LAUNCHES["batched_auction_matching"]
    if launches != MATCHED_STEPS:
        fail(f"matched_loss: the auction launched {launches} times for {MATCHED_STEPS} steps")

    # the device form makes no copy or wait between host and card; the host
    # form reads the cost back
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        device_step()
    except RuntimeError as e:
        fail(f"matched_loss: the device-matched step synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        host_step()
        host_syncs = False
    except RuntimeError:
        host_syncs = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    emit({"phase": "matched_loss", "card": card,
          "config": "examples/batched_loss_computation.py make_data(seed=0): 8 x 48 GT x 300 "
                    "predictions, 10 classes; linear head dim 256; SGD lr 1e-3",
          "loss_device_matched": loss_dev, "loss_host_matched": loss_host,
          "device_step_ms": float(np.median(dev_ms)), "device_step_ms_all": dev_ms,
          "device_step_host_ms": dev_wall, "host_step_ms": float(np.median(host_ms)),
          "host_step_ms_all": host_ms, "host_step_host_ms": host_wall,
          "auction_launches": launches, "device_form_sync_free": True,
          "host_form_synchronises": host_syncs})
    return launches


# serving: the buckets and timing of bench_serving.py, and its server load
SERVE_BUCKETS = (1, 2, 4, 8)
SERVE_ITERS = 20
SERVE_CLIENTS, SERVE_PER_CLIENT = 4, 25
SERVE_MAX_DELAY_MS, SERVE_DEPTH = 3.0, 2
# the int8 artifact against the float module: tests/test_quantize.py:71-85
QUANT_TOL = {"max_abs_over_max": 0.12, "corrcoef": 0.99}
# int4 (group 64) is held to its own in-process model and its drift from the
# float module reported: the JAX package's int4 drifts beyond QUANT_TOL at
# this width too (scripts/torch_quantize_drift.py, CPU, both packages)
INT4_NOTE = "reported, not held to QUANT_TOL: scripts/torch_quantize_drift.py"
# the exported and the eager device stage: about 300 ms of the card's clock
# holds the stream while the host enqueues either (36-130 ms on an H100 host:
# with the stream held no pinned block of the draws is free for reuse)
EXPORT_SLEEP_CYCLES = 600_000_000
EXPORT_TIMED = 10
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
SERVING_ARTIFACT = os.path.join(BUILD_DIR, "serving_float.accvserve")
PREPROCESS_ARTIFACT = os.path.join(BUILD_DIR, "preprocess.accvserve")


def trees_equal(a, b) -> bool:
    import torch.utils._pytree as pytree

    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    return sa == sb and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def heads_rel(got: dict, want: dict) -> float:
    return max(rel_to_max(got[k].float(), want[k].float()) for k in ("heatmap", "offset", "size"))


def event_ms(fn, reps: int) -> list:
    """Device ms of ``fn()`` per call (CUDA events), ``reps`` calls after one
    warm-up call."""
    fn()
    out = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def serving_phase(dev, card: str):
    """The serving path at full width: checkpoints, the float/int8/int4
    artifacts, the artifact per bucket, and the InferenceServer."""
    import shutil
    import threading

    from accvlab_tpu_torch.detection_serving import detection_fn, seeded_detector
    from accvlab_tpu_torch.models import InferenceServer
    from accvlab_tpu_torch.models.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
        save_checkpoint,
        wait_for_checkpoints,
    )
    from accvlab_tpu_torch.models.quantize import params_nbytes, quantize_params
    from accvlab_tpu_torch.models.serving import _atomic_write, export_inference, load_inference

    t_phase = time.perf_counter()
    out_hw = WIDTH["out_hw"]
    model = seeded_detector(10, 64, seed=0, device=dev)
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(0, 1, (8, *out_hw, 3)).astype(np.float32)).to(dev)

    # 1. checkpoints: two asynchronous saves with keep=2, then a restore
    ckpt_dir = os.path.join(BUILD_DIR, "serving_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    state = model.state_dict()
    save_ms = []
    for step in (1, 2):
        t0 = time.perf_counter()
        save_checkpoint(ckpt_dir, step, state, None, {"step": step}, asynchronous=True, keep=2)
        save_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    wait_for_checkpoints()
    wait_ms = (time.perf_counter() - t0) * 1e3
    path = latest_checkpoint(ckpt_dir)
    restored, _, meta = restore_checkpoint(path, {"params": state, "opt_state": None})
    if not path.endswith("step_00000002") or meta["step"] != 2:
        fail(f"serving: latest checkpoint {path} (meta {meta}), not step 2")
    if not all(v.device == state[k].device and torch.equal(v, state[k])
               for k, v in restored.items()):
        fail("serving: the restored parameters are not bitwise the saved ones")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # 2. the batch-polymorphic artifacts against the live module at batch 8
    with torch.no_grad():
        live = model(images)
    artifacts = {}
    for name, q in (("float", None), ("int8", quantize_params(model)),
                    ("int4", quantize_params(model, bits=4, group_size=64))):
        t0 = time.perf_counter()
        data = export_inference(detection_fn(model, quantized=q), (images[:2],),
                                batch_polymorphic=True)
        export_s = time.perf_counter() - t0
        path = SERVING_ARTIFACT if name == "float" else SERVING_ARTIFACT.replace("float", name)
        _atomic_write(path, data)
        serve = load_inference(path)
        got = serve(images)
        torch.cuda.synchronize()
        rel = heads_rel(got, live)
        rec = {"file_bytes": os.path.getsize(path),
               "params_nbytes": params_nbytes(model if q is None else q),
               "export_s": export_s, "heads_rel_to_max": rel,
               "heads_bitwise": all(torch.equal(got[k], live[k])
                                    for k in ("heatmap", "offset", "size"))}
        if q is None:
            if rel > TRAIN_TOL["heads"]:
                fail(f"serving: the float artifact's heads are {rel} of their max from the "
                     "module's")
            float_serve = serve
        else:
            # the artifact computes what its quantized weights say: against the
            # same dequantization in process
            with torch.no_grad():
                inproc = detection_fn(model, quantized=q)(images)
            rec["heads_rel_to_max_vs_in_process"] = heads_rel(got, inproc)
            if rec["heads_rel_to_max_vs_in_process"] > TRAIN_TOL["heads"]:
                fail(f"serving: the {name} artifact is {rec} from its in-process model")
            g, w = got["heatmap"].double().cpu().numpy(), live["heatmap"].double().cpu().numpy()
            rec["heatmap_max_abs_over_max"] = float(np.abs(g - w).max() / np.abs(w).max())
            rec["heatmap_corrcoef"] = float(np.corrcoef(g.ravel(), w.ravel())[0, 1])
            rec["within_quant_tol"] = bool(
                rec["heatmap_max_abs_over_max"] <= QUANT_TOL["max_abs_over_max"]
                and rec["heatmap_corrcoef"] > QUANT_TOL["corrcoef"])
            # the JAX test holds int8 to these bounds; int4 is reported (the JAX
            # package's own int4 misses them at this width: INT4_NOTE)
            if name == "int8" and not rec["within_quant_tol"]:
                fail(f"serving: the {name} artifact is {rec} from the float module")
            if name == "int4":
                rec["note"] = INT4_NOTE
        artifacts[name] = rec

    # 3. the artifact with decode_detections per bucket
    per_bucket = {}
    with torch.no_grad():
        for b in SERVE_BUCKETS:
            x = images[:b]
            ms = event_ms(lambda: float_serve(x), SERVE_ITERS)
            med = float(np.median(ms))
            per_bucket[b] = {"ms_per_batch": med, "ms_min_max": [min(ms), max(ms)],
                             "img_per_s": b / med * 1e3}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            float_serve(images)
        except RuntimeError as e:
            fail(f"serving: the artifact's call synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    amortization = per_bucket[8]["img_per_s"] / per_bucket[1]["img_per_s"]

    # 4. the InferenceServer: every request's detections bitwise a direct
    # call of the artifact at its bucket on the same stacked batch
    n = SERVE_CLIENTS * SERVE_PER_CLIENT
    requests = torch.from_numpy(rng.uniform(0, 1, (n, *out_hw, 3)).astype(np.float32))
    requests[:, 0, 0, 0] = torch.arange(n, dtype=torch.float32)  # each request's tag
    batches = []

    def recorded(x):
        out = float_serve(x)
        batches.append((x, out))
        return out

    server = InferenceServer(recorded, batch_sizes=SERVE_BUCKETS, max_delay_ms=SERVE_MAX_DELAY_MS,
                             pipeline_depth=SERVE_DEPTH, device=dev)
    server.warmup(requests[0])
    batches.clear()
    results, lat = [None] * n, []

    def client(cid):
        for i in range(SERVE_PER_CLIENT):
            r = cid * SERVE_PER_CLIENT + i
            t = time.perf_counter()
            results[r] = server.infer(requests[r], timeout=120)
            lat.append((time.perf_counter() - t) * 1e3)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    st = server.stats()
    server.close()
    if st["requests"] != n or st["errors"]:
        fail(f"serving: the server answered {st['requests']} of {n} requests, "
             f"{st['errors']} errors")
    where = {}
    with torch.no_grad():
        for x, out in batches:
            direct = float_serve(x)
            if not trees_equal(out, direct):
                fail(f"serving: a served batch of {x.shape[0]} differs from a direct call")
            for j in range(x.shape[0]):
                where.setdefault(int(x[j, 0, 0, 0]), (direct, j))
        worst_b1, b1_bitwise = 0.0, True
        for r in range(n):
            direct, j = where[r]
            want = {k: v[j: j + 1] for k, v in direct.items() if k != "detections"}
            got = results[r]
            dets_ok = all(torch.equal(got["detections"][k].tensor,
                                      direct["detections"][k].tensor[j: j + 1])
                          and torch.equal(got["detections"][k].sample_sizes,
                                          direct["detections"][k].sample_sizes[j: j + 1])
                          for k in ("boxes", "scores", "classes"))
            if not dets_ok or not all(torch.equal(got[k], want[k]) for k in want):
                fail(f"serving: request {r} differs from its bucket's direct call")
            one = float_serve(requests[r: r + 1].to(dev))
            worst_b1 = max(worst_b1, heads_rel(got, one))
            b1_bitwise = b1_bitwise and all(torch.equal(got[k], one[k]) for k in want)
    if worst_b1 > TRAIN_TOL["heads"]:
        fail(f"serving: a served request's heads are {worst_b1} of their max from batch 1")
    emit({"phase": "serving", "card": card,
          "config": "CenterNetDetector(10, width=64) + decode_detections(max 100, threshold "
                    "0.1) at 256x704, seeded weights; batch-polymorphic torch.export artifacts",
          "checkpoint": {"async_save_return_ms": save_ms, "wait_ms": wait_ms,
                         "restore_bitwise": True, "kept": 2},
          "artifacts": artifacts, "per_bucket": per_bucket,
          "amortization_8_over_1": amortization, "sync_free_call": True,
          "server": {"requests": n, "wall_s": wall, "requests_per_s": n / wall,
                     "client_p50_ms": float(np.percentile(lat, 50)),
                     "client_p95_ms": float(np.percentile(lat, 95)),
                     "bucket_histogram": {str(k): v for k, v in st["batch_size_counts"].items()},
                     "padded_samples": st["padded_samples"], "batches": st["batches"],
                     "queue_wait_p95_ms": st["queue_wait"].get("p95_ms"),
                     "pipeline_depth": SERVE_DEPTH, "max_delay_ms": SERVE_MAX_DELAY_MS,
                     "bitwise_vs_bucket_call": True,
                     "heads_rel_to_max_vs_batch1": worst_b1,
                     "bitwise_vs_batch1": b1_bitwise},
          "phase_s": time.perf_counter() - t_phase})


def export_phase(dev, card: str) -> int:
    """bench.py's device stage on the DCT wire exported, reloaded and run on
    the last host batch; the chained artifacts. Returns the rasterizer's
    launches of the pipeline's batches and the artifact's call."""
    from accvlab_tpu_torch.bench_pipeline import build_pipeline, model_inputs
    from accvlab_tpu_torch.detection_serving import detection_fn, seeded_detector
    from accvlab_tpu_torch.heatmap import LAUNCHES, reset_launch_counts
    from accvlab_tpu_torch.models.serving import load_inference

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    reset_launch_counts()
    pipe = build_pipeline(batch_size=8, device=dev, cache_dir=CACHE_DIR)
    try:
        pipe.run()
        pipe.run()
        pipe._halt_producer()
        idx, _, _, host = pipe._produce_host_batch()  # the last host batch
        leaves = pipe._transfer(host)
        want = pipe.run_device_stage(leaves, idx)
        key = (0, idx)
        torch.cuda.synchronize()
        if LAUNCHES["draw_gaussians"] != 3:
            fail(f"export: draw_gaussians launched {LAUNCHES['draw_gaussians']} times for 2 "
                 "batches and one device stage")
        t0 = time.perf_counter()
        header = pipe.export_device_program(PREPROCESS_ARTIFACT)
        export_s = time.perf_counter() - t0
        serve = load_inference(PREPROCESS_ARTIFACT)
        torch.cuda.synchronize()
        before = LAUNCHES["draw_gaussians"]
        got = serve(leaves, key)
        torch.cuda.synchronize()
        if LAUNCHES["draw_gaussians"] != before + 1:
            fail(f"export: the artifact's call launched the rasterizer "
                 f"{LAUNCHES['draw_gaussians'] - before} times, not once")
        launches = LAUNCHES["draw_gaussians"]
        names = header["pipeline_output_fields"]
        bad = [n for n, g, w in zip(names, got, want) if not torch.equal(g, w)]
        if len(got) != len(want) or bad:
            fail(f"export: the artifact's outputs {bad} differ from run_device_stage")

        artifact = decode_readings(lambda: serve(leaves, key), EXPORT_TIMED,
                                   EXPORT_SLEEP_CYCLES)
        eager = decode_readings(lambda: pipe.run_device_stage(leaves, idx), EXPORT_TIMED,
                                EXPORT_SLEEP_CYCLES)

        # the chained path on the two files alone against the in-process one
        model_serve = load_inference(SERVING_ARTIFACT)
        images, _ = model_inputs(dict(zip(names, serve(leaves, key))), 6)
        chained = model_serve(images)
        model = seeded_detector(10, 64, seed=0, device=dev)
        with torch.no_grad():
            composed = detection_fn(model)(model_inputs(dict(zip(names, want)), 6)[0])
        torch.cuda.synchronize()
        if tuple(images.shape) != (48, *WIDTH["out_hw"], 3):
            fail(f"export: preprocessed images of shape {tuple(images.shape)}")
        if not trees_equal(chained, composed):
            fail("export: the chained artifacts differ from the in-process composition")
        text = pipe.device_program_text()
        missing = [f"{type(s).__name__}_{i}" for i, s in enumerate(pipe._device_steps)
                   if f"# {type(s).__name__}_{i}" not in text]
        if missing:
            fail(f"export: device_program_text() names no node of {missing}")
    finally:
        pipe.stop()
    emit({"phase": "export", "card": card,
          "config": "bench_pipeline.build_pipeline() on the DCT wire: 6 cams x batch 8 of "
                    "372x1024 q90 JPEG -> 256x704, heatmaps 10x64x176",
          "file_bytes": os.path.getsize(PREPROCESS_ARTIFACT), "export_s": export_s,
          "leaves_in": len(leaves), "leaves_out": len(names),
          "draws": len(header["draw_schedule"]), "custom_ops": header["custom_ops"],
          "bitwise_vs_run_device_stage": True, "draw_gaussians_per_call": 1,
          "artifact_device_ms": artifact["device_ms"],
          "artifact_device_ms_min_max": [artifact["device_ms_min"], artifact["device_ms_max"]],
          "artifact_enqueue_host_ms": artifact["enqueue_host_ms"],
          "artifact_launches": artifact["launches"],
          "eager_device_ms": eager["device_ms"],
          "eager_device_ms_min_max": [eager["device_ms_min"], eager["device_ms_max"]],
          "eager_enqueue_host_ms": eager["enqueue_host_ms"], "eager_launches": eager["launches"],
          "hold_ms": artifact["hold_ms"], "timed": EXPORT_TIMED,
          "chained_images": list(images.shape), "chained_bitwise": True,
          "program_text_lines": text.count("\n") + 1, "draw_gaussians_launches": launches,
          "phase_s": time.perf_counter() - t_phase})
    return launches


# --------------------------------------------------------------------- #
# polyline, lane, bev, elastic, tools                                   #
# --------------------------------------------------------------------- #

ROOT = os.path.dirname(os.path.abspath(__file__))
F32_EPS = float(np.finfo(np.float32).eps)
POLY_K = 64  # calls per timed chain
POLY_REPS = 5
POLY_RAGGED = {"polylines": 64, "points": (2, 1000), "dists": 100}
LANE_STEPS = 150
LANE_BATCH = 32
LANE_PARITY_STEPS = 5
# card against CPU, the same parameters and batches: float32 products and
# sums in another order on each side, carried forward by Adam
LANE_TOL = 1e-4
BEV_BATCH = 8
BEV_BOXES = 64
BEV_CAMS = 6
BEV_BATCHES = 5
# StreamPETR's nuScenes GlobalRotScaleTransImage: rot_range, scale_ratio_range
BEV_ROTATION = (-0.3925, 0.3925)
BEV_SCALING = (0.95, 1.05)
# z at 0: the constant (lo == hi) path draws nothing
BEV_TRANSLATION = (0.5, 0.5, 0.0)
BEV_TOL = 1e-5  # card against CPU, relative to each output's largest magnitude
BEV_ARTIFACT = os.path.join(BUILD_DIR, "bev_stage.accvserve")
ELASTIC = {"samples": 32, "batch": 4, "seed": 11, "hw": (24, 32)}
TOOLS_BATCHES = 3
TOOLS_RANGES = ("tools.batch", "tools.forward", "tools.backward")
TOOLS_EPS = 1e-6
TOOLS_DUMP = os.path.join(BUILD_DIR, "tools_dump")


def script_module(name: str):
    """``scripts/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sync_free(what: str, fn):
    """``fn()`` under torch.cuda.set_sync_debug_mode("error"); fails the
    run on any host synchronisation."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = fn()
    except RuntimeError as e:
        fail(f"{what} synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return res


def poly_tol(points: np.ndarray, sizes=None) -> float:
    """``8 * eps_f32 * max total length``: the float32 prefix sum's rounding."""
    p = np.asarray(points, np.float64)
    seg = np.linalg.norm(np.diff(p, axis=1), axis=2)
    if sizes is not None:
        seg = np.where(np.arange(seg.shape[1])[None] < np.asarray(sizes)[:, None] - 1, seg, 0)
    return 8 * F32_EPS * max(float(seg.sum(axis=1).max()), 1.0)


def max_abs(a, b) -> float:
    a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
    if a.shape != b.shape or bool((a.isnan() != b.isnan()).any()):
        return float("inf")
    fin = ~a.isnan()
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def polyline_ragged_case(seed: int = 11):
    rng = np.random.default_rng(seed)
    n, (lo, hi), m = POLY_RAGGED["polylines"], POLY_RAGGED["points"], POLY_RAGGED["dists"]
    sizes = rng.integers(lo, hi + 1, n).astype(np.int32)
    pts = np.cumsum(rng.uniform(-1, 1, (n, hi, 2)), axis=1).astype(np.float32)
    pts[np.arange(hi)[None] >= sizes[:, None]] = 0.0
    dsz = rng.integers(1, m + 1, n).astype(np.int32)
    rel = rng.uniform(0, 1, (n, m)).astype(np.float32)
    return pts, sizes, rel, dsz


def polyline_phase(dev, card: str):
    """bench_polyline's grid on the card: each case against the port on the
    CPU and the float64 numpy restatement, its chained ms per call beside
    numpy's host ms, and its launches; the var-size forms on a ragged batch;
    one call of each under the sync check."""
    from accvlab_tpu_torch.polyline import (interpolate, interpolate_var_size_batch, lengths,
                                            lengths_var_size_batch)
    from accvlab_tpu_torch.ragged import RaggedBatch

    t_phase = time.perf_counter()
    bench = script_module("torch_bench_polyline")
    rows = []
    for (b, n, m), (pts, rel) in bench.cases():
        p, r = torch.from_numpy(pts).to(dev), torch.from_numpy(rel).to(dev)
        got = interpolate(p, r, relative=True)
        cpu = interpolate(torch.from_numpy(pts), torch.from_numpy(rel), relative=True)
        tol = poly_tol(pts)
        err_cpu, err_f64 = max_abs(got, cpu), max_abs(got, bench.numpy_relative(pts, rel))
        err_len = max_abs(lengths(p), lengths(torch.from_numpy(pts)))
        if not bool(torch.isfinite(got).all()) or max(err_cpu, err_f64, err_len) > tol:
            fail(f"polyline: case {(b, n, m)} off by {err_cpu} (CPU), {err_f64} (float64), "
                 f"{err_len} (lengths) against the tolerance {tol}")
        ms = bench.chained_ms(p, r, POLY_K, POLY_REPS)
        np_ms = bench.numpy_ms(pts, rel, budget_s=0.25)
        rows.append({"batch": b, "points": n, "dists": m, "ms": ms, "numpy_ms": np_ms,
                     "vs_numpy": np_ms / ms, "max_abs_err_cpu": err_cpu,
                     "max_abs_err_f64": err_f64, "tol": tol,
                     "launches_per_call": kernel_counts(
                         lambda: interpolate(p, r, relative=True))})
    pts, sizes, rel, dsz = polyline_ragged_case()

    def ragged(device):
        t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        rp = RaggedBatch(t(pts), sample_sizes=t(sizes))
        rd = RaggedBatch(t(rel), sample_sizes=t(dsz))
        return lambda: (interpolate_var_size_batch(rp, rd, relative=True),
                        lengths_var_size_batch(rp))

    (got, got_len), (cpu, cpu_len) = ragged(dev)(), ragged(torch.device("cpu"))()
    tol = poly_tol(pts, sizes)
    err_cpu = max(max_abs(got.tensor, cpu.tensor), max_abs(got_len, cpu_len))
    err_f64 = 0.0
    out = got.tensor.cpu().numpy()
    for s in range(len(sizes)):
        want = bench.numpy_relative(pts[s:s + 1, :sizes[s]], rel[s:s + 1, :dsz[s]])[0]
        err_f64 = max(err_f64, float(np.abs(out[s, :dsz[s]] - want).max()))
    if max(err_cpu, err_f64) > tol or not bool((got.tensor.cpu()[~got.mask.cpu()] == 0).all()):
        fail(f"polyline: the ragged batch off by {err_cpu} (CPU), {err_f64} (float64) against "
             f"{tol}, or a distance past its sample's count is not 0")
    p, r = torch.from_numpy(pts).to(dev), torch.from_numpy(rel).to(dev)
    sync_free("polyline: interpolate", lambda: interpolate(p, r, relative=True))
    sync_free("polyline: the var-size forms", ragged(dev))
    emit({"phase": "polyline", "card": card, "k": POLY_K, "reps": POLY_REPS, "cases": rows,
          "ragged": {**POLY_RAGGED, "max_abs_err_cpu": err_cpu, "max_abs_err_f64": err_f64,
                     "tol": tol, "launches_per_call": kernel_counts(ragged(dev))},
          "sync_free": True, "phase_s": time.perf_counter() - t_phase})


def lane_phase(dev, card: str):
    """lane_regression_training's run at the example's width on the card:
    the loss halves, the first steps agree with a CPU run from the same
    parameters; device ms and launches per step; one step sync-free."""
    from accvlab_tpu_torch import lane_regression_training as L
    from accvlab_tpu_torch.models.params import jax_params_of

    t_phase = time.perf_counter()
    params = jax_params_of(L.LaneRegressor(seed=0))
    t0 = time.perf_counter()
    model, losses = L.train(LANE_STEPS, LANE_BATCH, 0, device=dev, params=params)
    run_s = time.perf_counter() - t0
    _, cpu_losses = L.train(LANE_PARITY_STEPS, LANE_BATCH, 0, device="cpu", params=params)
    if not all(np.isfinite(losses)) or not losses[-1] < 0.5 * losses[0]:
        fail(f"lane: the loss went {losses[0]} -> {losses[-1]}, not below half")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)]
    if max(rel) > LANE_TOL:
        fail(f"lane: the first {LANE_PARITY_STEPS} losses {losses[:LANE_PARITY_STEPS]} differ "
             f"from the CPU's {cpu_losses} by up to {max(rel)} (relative)")
    step, _ = L.make_train_step(model)
    rasters, gt = L.batch_to_device(*L.make_lane_batch(LANE_BATCH, np.random.default_rng(1)),
                                    dev)
    step(rasters, gt)
    sync_free("lane: a train step", lambda: step(rasters, gt))
    readings = decode_readings(lambda: step(rasters, gt), reps=20)
    emit({"phase": "lane", "card": card,
          "config": "examples/lane_regression_training.py: MLP 1024-128-128-16 on 32x32 "
                    "rasters, batch 32, 8 control points, 16 arc-length samples, Adam 3e-3",
          "steps": LANE_STEPS, "first_loss": losses[0], "last_loss": losses[-1],
          "losses_every_25": losses[::25], "cpu_losses": cpu_losses,
          "max_rel_vs_cpu": max(rel), "tol": LANE_TOL,
          "ms_per_step_wall": run_s / LANE_STEPS * 1e3,
          "device_ms_per_step": readings["device_ms"],
          "device_ms_min_max": [readings["device_ms_min"], readings["device_ms_max"]],
          "enqueue_host_ms": readings["enqueue_host_ms"], "hold_ms": readings["hold_ms"],
          "launches_per_step": readings["launches"], "sync_free_step": True,
          "phase_s": time.perf_counter() - t_phase})


def bev_provider(num_samples: int, boxes: int = BEV_BOXES, cams: int = BEV_CAMS):
    """Seeded 3-D samples: ``boxes`` boxes (centres, velocities, sizes,
    yaw) in the ego frame, ``cams`` cameras' 4x4 projection @ extrinsics,
    ``ego_to_world`` and its inverse ``world_to_ego``."""
    from accvlab_tpu_torch.pipeline import DType, SampleDataGroup
    from accvlab_tpu_torch.pipeline.inputs import DataProvider

    def rot_z(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    class BEVProvider(DataProvider):
        @property
        def sample_data_structure(self):
            ann = SampleDataGroup()
            for name in ("centers3d", "velocities", "sizes3d", "yaw"):
                ann.add_data_field(name, DType.FLOAT)
            sdg = SampleDataGroup()
            sdg.add_data_group_field("annotations", ann)
            for name in ("cam_proj", "ego_to_world", "world_to_ego"):
                sdg.add_data_field(name, DType.FLOAT)
            return sdg

        def get_data(self, i):
            rng = np.random.default_rng(20_000 + i)
            sdg = self.sample_data_structure
            ann = sdg["annotations"]
            ann["centers3d"] = np.concatenate(
                [rng.uniform(-51.2, 51.2, (boxes, 2)), rng.uniform(-5.0, 3.0, (boxes, 1))],
                1).astype(np.float32)
            ann["velocities"] = np.concatenate(
                [rng.normal(0.0, 3.0, (boxes, 2)), np.zeros((boxes, 1))], 1).astype(np.float32)
            ann["sizes3d"] = rng.uniform(0.5, 5.0, (boxes, 3)).astype(np.float32)
            ann["yaw"] = rng.uniform(-np.pi, np.pi, boxes).astype(np.float32)
            intr = np.array([[1266.4, 0.0, 816.3, 0.0], [0.0, 1266.4, 491.5, 0.0],
                             [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
            to_cam = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
            projs = []
            for c in range(cams):
                ext = np.eye(4)
                ext[:3, :3] = to_cam @ rot_z(-2 * np.pi * c / cams + rng.normal(0.0, 0.02))
                ext[:3, 3] = ext[:3, :3] @ -np.array([1.5, 0.0, 1.6]) + rng.normal(0, 0.05, 3)
                projs.append(intr @ ext)
            sdg["cam_proj"] = np.stack(projs).astype(np.float32)
            e2w = np.eye(4)
            e2w[:3, :3] = rot_z(rng.uniform(-np.pi, np.pi))
            e2w[:3, 3] = rng.uniform(-50.0, 50.0, 3) * np.array([1.0, 1.0, 0.05])
            sdg["ego_to_world"] = e2w.astype(np.float32)
            sdg["world_to_ego"] = np.linalg.inv(e2w).astype(np.float32)
            return sdg

        def get_number_of_samples(self):
            return num_samples

    return BEVProvider()


def bev_step(rotation=BEV_ROTATION, scaling=BEV_SCALING, translation=BEV_TRANSLATION):
    from accvlab_tpu_torch.pipeline.processing_steps import BEVBBoxesTransformer3D

    return BEVBBoxesTransformer3D(
        data_field_names_points="centers3d", data_field_names_velocities="velocities",
        data_field_names_sizes="sizes3d", data_field_names_orientation="yaw",
        data_field_names_proj_matrices_and_extrinsics="cam_proj",
        data_field_names_ego_to_world="ego_to_world",
        data_field_names_world_to_ego="world_to_ego",
        rotation_range=rotation, rotation_axis=2 if rotation else None,
        scaling_range=scaling, translation_max_abs=translation)


def bev_definition(provider, batch: int = BEV_BATCH):
    from accvlab_tpu_torch.pipeline import PipelineDefinition
    from accvlab_tpu_torch.pipeline.inputs import ShuffledShardedInputCallable

    return PipelineDefinition(ShuffledShardedInputCallable(provider, batch, shuffle=True),
                              [bev_step()], copy_external_source_passthrough_outputs=False)


def bev_invariants(names, before, after) -> dict:
    """The JAX test's invariants (tests/test_bev_transformer.py:110-157) on a
    batch: ``world_to_ego @ ego_to_world`` the identity (max |error|), and
    each camera's projection of the moved centres that of the original
    centres (max of ``|error| / (1e-3 + 1e-3 |original|)``; at most 1)."""
    b = {n: torch.as_tensor(v).double().cpu() for n, v in zip(names, before)}
    a = {n: torch.as_tensor(v).double().cpu() for n, v in zip(names, after)}
    ident = (a["world_to_ego"] @ a["ego_to_world"] - torch.eye(4, dtype=torch.float64)).abs()

    def project(d):
        c = d["annotations.centers3d"]
        h = torch.cat([c, torch.ones_like(c[..., :1])], -1)  # (B, N, 4)
        return d["cam_proj"] @ h.transpose(-1, -2)[:, None]  # (B, cams, 4, N)

    want = project(b)
    proj = ((project(a) - want).abs() / (1e-3 + 1e-3 * want.abs())).max()
    return {"w2e_e2w_identity_max_abs": float(ident.max()), "projection_rel": float(proj)}


def bev_phase(dev, card: str):
    """The 3-D BEV step on the card: a few batches through run(); one host
    batch's stage on the card (sync-free) and on the CPU; the invariants;
    the exported stage bitwise the eager one; device ms and launches."""
    from accvlab_tpu_torch.models.serving import load_inference

    t_phase = time.perf_counter()
    threads = os.cpu_count() or 8
    definition = bev_definition(bev_provider(BEV_BATCH * (BEV_BATCHES + 4)))
    pipe = definition.get_pipeline(batch_size=BEV_BATCH, num_threads=threads, device=dev,
                                   seed=3)
    try:
        outs = [pipe.run() for _ in range(BEV_BATCHES)]
        torch.cuda.synchronize()
        for out in outs:
            bad = [k for k, v in out.items() if not (v.is_cuda and bool(torch.isfinite(v).all()))]
            if bad or tuple(out["cam_proj"].shape) != (BEV_BATCH, BEV_CAMS, 4, 4) \
                    or tuple(out["annotations.centers3d"].shape) != (BEV_BATCH, BEV_BOXES, 3):
                fail(f"bev: unexpected outputs (not finite on the card: {bad})")
    finally:
        pipe.stop()
    pipe = definition.get_pipeline(batch_size=BEV_BATCH, num_threads=threads, device=dev, seed=3)
    cpu = definition.get_pipeline(batch_size=BEV_BATCH, num_threads=threads, device="cpu",
                                  seed=3)
    try:
        idx, _, _, host = pipe._produce_host_batch()
        leaves = pipe._transfer(host)
        pipe.run_device_stage(leaves, idx)  # warm-up
        got = sync_free("bev: the device stage", lambda: pipe.run_device_stage(leaves, idx))
        want = cpu.run_device_stage([torch.from_numpy(a) for a in host], idx)
        names = list(pipe.output_names)
        rel = max(max_abs(g, w) / max(float(w.abs().max()), 1e-30) for g, w in zip(got, want))
        if rel > BEV_TOL:
            fail(f"bev: the card differs from the CPU by {rel} (relative), beyond {BEV_TOL}")
        inv = bev_invariants(names, [torch.from_numpy(a) for a in host], got)
        if inv["w2e_e2w_identity_max_abs"] > 1e-4 or inv["projection_rel"] > 1.0:
            fail(f"bev: the invariants do not hold: {inv}")
        os.makedirs(BUILD_DIR, exist_ok=True)
        header = pipe.export_device_program(BEV_ARTIFACT)
        serve = load_inference(BEV_ARTIFACT)
        replay = serve(leaves, (3, idx))
        if len(replay) != len(got) or not all(torch.equal(a, b) for a, b in zip(replay, got)):
            fail("bev: the exported stage differs from the eager stage")
        readings = decode_readings(lambda: pipe.run_device_stage(leaves, idx), reps=20)
    finally:
        pipe.stop()
        cpu.stop()
    emit({"phase": "bev", "card": card,
          "config": f"BEVBBoxesTransformer3D, batch {BEV_BATCH} x {BEV_BOXES} boxes, "
                    f"{BEV_CAMS} cameras' projection @ extrinsics, ego<->world; rotation "
                    f"{BEV_ROTATION} about z, scaling {BEV_SCALING} (StreamPETR's nuScenes "
                    f"GlobalRotScaleTransImage), translation max {BEV_TRANSLATION}",
          "batches": BEV_BATCHES, "max_rel_vs_cpu": rel, "tol": BEV_TOL, "invariants": inv,
          "draws": [e["kind"] for e in header["draw_schedule"]],
          "export_bitwise": True, "sync_free_stage": True,
          "device_ms_per_batch": readings["device_ms"],
          "device_ms_min_max": [readings["device_ms_min"], readings["device_ms_max"]],
          "enqueue_host_ms": readings["enqueue_host_ms"], "hold_ms": readings["hold_ms"],
          "launches_per_batch": readings["launches"],
          "phase_s": time.perf_counter() - t_phase})


def elastic_provider(n: int):
    """examples/preemptible_training.py's JPEG dataset (24x32, seed 7) with
    the label set to the sample index."""
    import io

    from PIL import Image

    from accvlab_tpu_torch.pipeline import DType, SampleDataGroup
    from accvlab_tpu_torch.pipeline.inputs import DataProvider

    rng = np.random.default_rng(7)
    jpegs = []
    for _ in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (*ELASTIC["hw"], 3), np.uint8)).save(
            buf, format="JPEG", quality=92)
        jpegs.append(np.frombuffer(buf.getvalue(), np.uint8).copy())

    class UniqueLabelProvider(DataProvider):
        @property
        def sample_data_structure(self):
            sdg = SampleDataGroup()
            sdg.add_data_field("image", DType.UINT8)
            sdg.add_data_field("label", DType.INT32)
            return sdg

        def get_data(self, i):
            sdg = self.sample_data_structure
            sdg["image"] = jpegs[i]
            sdg["label"] = i
            return sdg

        def get_number_of_samples(self):
            return n

    return UniqueLabelProvider()


def elastic_fleet(provider, num_shards: int, dev, extra=None):
    from accvlab_tpu_torch.pipeline import PipelineDefinition
    from accvlab_tpu_torch.pipeline.inputs import ElasticShardedInputCallable
    from accvlab_tpu_torch.pipeline.processing_steps import ImageDecoder, ImageRange01Normalizer

    fleet = []
    for s in range(num_shards):
        inp = ElasticShardedInputCallable(provider, ELASTIC["batch"], shard_id=s,
                                          num_shards=num_shards, shuffle=True,
                                          seed=ELASTIC["seed"], **(extra or {}))
        definition = PipelineDefinition(inp, [ImageDecoder("image"),
                                              ImageRange01Normalizer("image")])
        fleet.append(definition.get_pipeline(batch_size=ELASTIC["batch"], num_threads=1,
                                             seed=3, device=dev))
    return fleet


def elastic_steps(fleet, steps=None) -> list:
    """Lockstep steps of every shard (all of the epoch when ``steps`` is
    None); the delivered labels, checking each image on the card."""
    labels, done = [], [False] * len(fleet)
    while not all(done) and (steps is None or steps > 0):
        for i, p in enumerate(fleet):
            if done[i]:
                continue
            try:
                out = p.run()
            except StopIteration:
                done[i] = True
                continue
            img = out["image"]
            if not img.is_cuda or tuple(img.shape) != (ELASTIC["batch"], *ELASTIC["hw"], 3):
                fail(f"elastic: a delivered image is {tuple(img.shape)} on {img.device}")
            labels += out["label"].cpu().reshape(-1).tolist()
        steps = None if steps is None else steps - 1
    return labels


def elastic_phase(dev, card: str):
    """The elastic stanza of examples/preemptible_training.py on the port
    (2 shards x 2 steps, reshard to 3 shards, drain the epoch: 28 distinct
    samples), then a chained reshard 2 -> 3 -> 1 (all 32, each once)."""
    from accvlab_tpu_torch.pipeline.inputs import elastic_reshard

    t_phase = time.perf_counter()
    provider = elastic_provider(ELASTIC["samples"])

    def run_fleets(plan):
        """``plan``: (num_shards, steps or None to drain) per fleet; each
        later fleet resumes from the one before through elastic_reshard."""
        labels, extra, state = [], None, None
        for num_shards, steps in plan:
            fleet = elastic_fleet(provider, num_shards, dev, extra)
            try:
                for p in fleet:
                    if state is not None:
                        p.set_state(dict(state))
                labels += elastic_steps(fleet, steps)
                snapshot = fleet[0].get_state()
            finally:
                for p in fleet:
                    p.stop()
            extra, state = elastic_reshard(json.loads(json.dumps(snapshot)))
        return labels

    stanza = run_fleets([(2, 2), (3, None)])
    if len(stanza) != 28 or len(set(stanza)) != 28:
        fail(f"elastic: the stanza delivered {len(stanza)} samples, {len(set(stanza))} distinct"
             " (28 of each expected)")
    chained = run_fleets([(2, 1), (3, 1), (1, None)])
    if sorted(chained) != list(range(ELASTIC["samples"])):
        fail(f"elastic: the chained reshard 2 -> 3 -> 1 delivered {sorted(chained)}")
    emit({"phase": "elastic", "card": card,
          "config": "examples/preemptible_training.py's elastic stanza: 32 JPEGs of 24x32, "
                    "batch 4 per shard, shuffled (seed 11); ImageDecoder on the host, "
                    "ImageRange01Normalizer on the card",
          "stanza_2_to_3": {"delivered": len(stanza), "distinct": len(set(stanza))},
          "chained_2_3_1": {"delivered": len(chained), "distinct": len(set(chained))},
          "phase_s": time.perf_counter() - t_phase})


def trace_ranges_check(doc: dict) -> dict:
    """Every TOOLS_RANGES name TOOLS_BATCHES times among the trace's
    annotations; each range closes after the device work it launched (the
    kernels, copies and memsets whose runtime call lies inside it, on its
    thread). Returns counts and the smallest margin (µs, range end minus
    the last such kernel's end)."""
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] in TOOLS_RANGES]
    counts = {n: sum(e["name"] == n for e in ranges) for n in TOOLS_RANGES}
    if any(c != TOOLS_BATCHES for c in counts.values()):
        fail(f"tools: the trace's ranges {counts}, not {TOOLS_BATCHES} of each")
    device = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "correlation" in e.get("args", {})}
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"
               and e.get("args", {}).get("correlation") in device]
    margin, with_work = float("inf"), 0
    for r in ranges:
        end = r["ts"] + r["dur"]
        ends = [device[e["args"]["correlation"]]["ts"] + device[e["args"]["correlation"]]["dur"]
                for e in runtime if e["tid"] == r["tid"] and r["ts"] <= e["ts"] <= end]
        if ends:
            with_work += 1
            margin = min(margin, end - max(ends))
    if with_work == 0 or margin < 0:
        fail(f"tools: a sync_on_pop range closed {-margin} µs before its device work "
             f"({with_work} ranges with device work)")
    return {"ranges": counts, "ranges_with_device_work": with_work, "min_margin_us": margin}


def tools_phase(dev, card: str) -> int:
    """bench.py's main path (DCT wire, full width) with TraceRangeWrapper
    ranges around the consumer's steps under torch.profiler; TensorDumper
    dumps one delivered batch and its CenterNet step's gradients and
    compares them again. Returns the rasterizer's launches."""
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from accvlab_tpu_torch.bench_pipeline import build_pipeline, dense_focal_loss, model_inputs
    from accvlab_tpu_torch.heatmap import LAUNCHES, reset_launch_counts
    from accvlab_tpu_torch.models.centernet import CenterNetDetector, init_params
    from accvlab_tpu_torch.tools import TensorDumper, TraceRangeWrapper

    t_phase = time.perf_counter()
    num_cams = WIDTH["cams"]
    model = CenterNetDetector(num_classes=10, width=64)
    init_params(model, torch.Generator().manual_seed(0)).to(dev)
    params = dict(model.named_parameters())
    TraceRangeWrapper._reset_singleton()
    ranges = TraceRangeWrapper()
    ranges.enable(sync_on_pop=True, keep_track_of_range_order=True, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    pipe = build_pipeline(batch_size=WIDTH["batch"], device=dev, cache_dir=CACHE_DIR)
    try:
        pipe.run()  # outside the trace: the ring filled, the constants on the card
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(TOOLS_BATCHES):
                ranges.range_push("tools.batch")
                out = pipe.run()
                ranges.range_pop("tools.batch")
                ranges.range_push("tools.forward")
                images, heat = model_inputs(out, num_cams)
                loss = dense_focal_loss(model(images), heat)
                ranges.range_pop("tools.forward")
                ranges.range_push("tools.backward")
                grads = torch.autograd.grad(loss, list(params.values()))
                ranges.range_pop("tools.backward")
        torch.cuda.synchronize()
        launches = LAUNCHES["draw_gaussians"]
    finally:
        pipe.stop()
        ranges.disable()
    if launches != TOOLS_BATCHES + 1:
        fail(f"tools: draw_gaussians launched {launches} times for {TOOLS_BATCHES + 1} batches")
    os.makedirs(BUILD_DIR, exist_ok=True)
    trace_path = os.path.join(BUILD_DIR, "tools_trace.json")
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        trace = trace_ranges_check(json.load(f))

    # the last batch and its step's gradients, dumped, then compared
    shutil.rmtree(TOOLS_DUMP, ignore_errors=True)
    TensorDumper._reset_singleton()
    td = TensorDumper()
    td.enable(TOOLS_DUMP)

    def collect(grads_):
        td.push_range("batch")
        td.add_tensor_data("pipeline", out, TensorDumper.Type.BINARY)
        td.pop_range()
        td.add_grad_data("centernet", params, TensorDumper.Type.BINARY)
        td.set_gradients(list(grads_))

    t0 = time.perf_counter()
    collect(grads)
    td.dump()
    dump_s = time.perf_counter() - t0
    dump_bytes = sum(os.path.getsize(os.path.join(TOOLS_DUMP, f)) for f in os.listdir(TOOLS_DUMP))
    td.set_dump_is_compare(eps_numerical_data=TOOLS_EPS, compare_dir=TOOLS_DUMP)
    # the first gradient's first entry moved to the last float32 within eps,
    # then to the first one past it
    name0 = next(iter(params))
    x = np.float32(grads[0].reshape(-1)[0].item())
    past = np.float32(x + np.float32(TOOLS_EPS))
    while float(past) - float(x) <= TOOLS_EPS:
        past = np.nextafter(past, np.float32(np.inf))
    within = np.nextafter(past, np.float32(-np.inf))

    def moved(value):
        g = grads[0].clone(memory_format=torch.contiguous_format)
        g.view(-1)[0] = float(value)
        return (g, *grads[1:])

    t0 = time.perf_counter()
    for case in (grads, moved(within)):
        td.set_dump_count(0)
        collect(case)
        try:
            td.dump()
        except ValueError as e:
            fail(f"tools: TensorDumper reports the same data as different: {str(e)[:500]}")
    compare_s = time.perf_counter() - t0
    td.set_dump_count(0)
    collect(moved(past))
    try:
        td.dump()
        fail("tools: TensorDumper did not report a change of one ulp past eps_numerical_data")
    except ValueError as e:
        key = f"grads/centernet/{name0}"
        if f"'{key}': 1 mismatching elements" not in str(e):
            fail(f"tools: TensorDumper's report does not name {key}: {str(e)[:500]}")
    finally:
        td.disable()
        TensorDumper._reset_singleton()
    emit({"phase": "tools", "card": card,
          "config": "bench_pipeline.build_pipeline() on the DCT wire (6 cams x batch 8, "
                    "372x1024 -> 256x704), CenterNet(10, width 64) forward and gradients",
          "batches": TOOLS_BATCHES, "trace": trace, "draw_gaussians_launches": launches,
          "dump_bytes": dump_bytes, "dump_s": dump_s, "compare_s_two": compare_s,
          "dump_entries": len(out) + len(params), "eps": TOOLS_EPS,
          "ulp_past_eps_reported": True, "within_eps_clean": True,
          "phase_s": time.perf_counter() - t_phase})
    return launches


# two pairs of windows in turns, unsharded and mesh, then mesh and
# unsharded, each on its own pipeline after MESH_CHECK_BATCHES batches
# (main's 3 x 100 cut in depth; widths not cut)
MESH_BATCHES = 10
MESH_CHECK_BATCHES = 3  # delivered by the first pipeline of each kind and compared bitwise
MESH_WRAP_CALLS = 50  # shard_batch of one delivered batch, timed (median)
# __graft_entry__.py's pipeline-parallel stanza at one stage and one data
# shard: dim 32, 6 microbatches of 2
MESH_PP = {"dim": 32, "micro": 6, "mb": 2}
# pipeline_loss and pipeline_apply against the plain sequential application
# on the card: the same float32 operations in the same order (expected
# bitwise), held to this tolerance relative to the largest magnitude
MESH_PP_RTOL = 1e-6


def mesh_pipeline_parallel(dev) -> dict:
    """pipeline_loss and pipeline_apply on a (data 1, pipe 1) mesh against
    the plain sequential application of the one stage, on the card."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from accvlab_tpu_torch.parallel import make_mesh_nd, pipeline_apply, pipeline_loss

    mesh = make_mesh_nd((1, 1), ("data", "pipe"))
    dim, n_micro, mb = MESH_PP["dim"], MESH_PP["micro"], MESH_PP["mb"]
    gen = torch.Generator().manual_seed(2)
    host = {"w": torch.randn(1, dim, dim, generator=gen) * 0.2,
            "b": torch.randn(1, dim, generator=gen) * 0.05,
            "xs": torch.randn(n_micro, mb, dim, generator=gen),
            "tgts": torch.randn(n_micro, mb, dim, generator=gen)}
    xs, tgts = host["xs"].to(dev), host["tgts"].to(dev)

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def mse(y, t):
        return ((y - t) ** 2).mean()

    params = {k: distribute_tensor(host[k].to(dev), mesh, (Replicate(), Shard(0)))
              .requires_grad_() for k in ("w", "b")}
    loss = pipeline_loss(params, xs, tgts, stage, mse, mesh=mesh, data_spec=("data",))
    loss.backward()
    grads = {k: p.grad.to_local()[0] for k, p in params.items()}
    with torch.no_grad():
        outs = pipeline_apply(params, xs, stage, mesh=mesh)

    plain = {k: host[k][0].to(dev).requires_grad_() for k in ("w", "b")}
    want = torch.stack([mse(stage(plain, xs[i]), tgts[i]) for i in range(n_micro)]).sum() / n_micro
    want.backward()
    with torch.no_grad():
        want_outs = torch.stack([stage(plain, xs[i]) for i in range(n_micro)])
    pairs = {"loss": (loss.detach(), want.detach()), "outputs": (outs, want_outs),
             **{f"grad_{k}": (grads[k], plain[k].grad) for k in grads}}
    res = {}
    for name, (got, ref) in pairs.items():
        if not (got.is_cuda and bool(torch.isfinite(got).all())):
            fail(f"mesh: pipeline {name} is not finite on the card")
        err = float((got - ref).abs().max())
        if err > MESH_PP_RTOL * float(ref.abs().max()):
            fail(f"mesh: pipeline {name} differs from the sequential application by {err}")
        res[name] = {"max_abs_err": err, "bitwise": bool(torch.equal(got, ref))}
    return res


def mesh_phase(dev, card: str, main_fps: float) -> int:
    """bench.py's main path on a one-rank NCCL mesh (get_pipeline(mesh=)):
    every leaf a DTensor whose full tensor is bitwise the unsharded
    pipeline's batch; frames/s in windows that alternate with unsharded
    windows of the same depth, beside main's; pipeline_loss and
    pipeline_apply on (data 1, pipe 1); the preemptible trainer's bitwise
    resume; checkpoints restored onto DTensor templates. Returns the
    rasterizer's launches on the mesh main path."""
    import shutil

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from accvlab_tpu_torch.bench_pipeline import build_pipeline
    from accvlab_tpu_torch.heatmap import LAUNCHES, reset_launch_counts
    from accvlab_tpu_torch.models.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
        save_checkpoint,
    )
    from accvlab_tpu_torch.parallel import host_shard_info, make_mesh, shard_batch
    from accvlab_tpu_torch.parallel import shard_like_batch
    from accvlab_tpu_torch.preemptible_training import elastic_restore
    from accvlab_tpu_torch.preemptible_training import main as preemptible_main

    t_phase = time.perf_counter()
    mesh = make_mesh()
    backend = dist.get_backend()
    if (tuple(mesh.shape), host_shard_info(mesh), backend) != ((1, 1), (0, 1), "nccl"):
        fail(f"mesh: make_mesh() gave {tuple(mesh.shape)}, host_shard_info "
             f"{host_shard_info(mesh)}, backend {backend}")
    kw = dict(batch_size=WIDTH["batch"], device=dev, cache_dir=CACHE_DIR)
    fps = {"unsharded": [], "mesh": []}

    def window(kind, first=None):
        """A fresh pipeline of ``kind``: MESH_CHECK_BATCHES batches (each
        passed to ``first``), then a timed window; returns its last batch."""
        pipe = build_pipeline(mesh=mesh if kind == "mesh" else None, **kw)
        try:
            for i in range(MESH_CHECK_BATCHES):
                out = pipe.run()
                if first is not None:
                    first(i, out)
            s, out = timed_windows(pipe, 1, MESH_BATCHES)
        finally:
            pipe.stop()
        fps[kind].append(MESH_BATCHES * WIDTH["batch"] * WIDTH["cams"] / s[0])
        return out

    def check(i, out):
        for name, want in ref[i].items():
            leaf = out[name]
            if not isinstance(leaf, DTensor) or leaf.placements != (Shard(0), Replicate()):
                fail(f"mesh: {name} is not a DTensor sharded over data")
            if not torch.equal(leaf.full_tensor(), want):
                fail(f"mesh: batch {i}'s {name} differs from the unsharded pipeline's")

    # pair 0, unsharded first: its first batches are the reference
    ref = []
    window("unsharded", lambda i, out: ref.append({k: v.clone() for k, v in out.items()}))
    # shard_batch and shard_like_batch on the main path's leaves: no copy
    for name, leaf in ref[0].items():
        sharded = shard_batch({name: leaf}, mesh)[name]
        if (sharded.placements != shard_like_batch(mesh, leaf.ndim)
                or sharded.to_local().data_ptr() != leaf.data_ptr()
                or not torch.equal(sharded.full_tensor(), leaf)):
            fail(f"mesh: shard_batch of {name} is not the leaf itself, Shard(0) over data")
    leaves = list(ref[0].values())
    wrap_s = []
    for _ in range(MESH_WRAP_CALLS):
        t0 = time.perf_counter()
        shard_batch(leaves, mesh)
        wrap_s.append(time.perf_counter() - t0)

    # the mesh main path: pair 0's mesh window (its first batches checked),
    # then pair 1's, mesh first
    torch.cuda.synchronize()
    reset_launch_counts()
    window("mesh", check)
    out = window("mesh")
    launches = LAUNCHES["draw_gaussians"]
    delivered = 2 * (MESH_CHECK_BATCHES + MESH_BATCHES)
    if launches != delivered:
        fail(f"mesh: draw_gaussians launched {launches} times for {delivered} batches")
    if not all(isinstance(v, DTensor) for v in out.values()):
        fail("mesh: a leaf of the last window's last batch is not a DTensor")
    check_outputs({k: v.to_local() for k, v in out.items()}, WIDTH["cams"], WIDTH["batch"])
    window("unsharded")

    t0 = time.perf_counter()
    pp = mesh_pipeline_parallel(dev)
    pp_s = time.perf_counter() - t0

    # the preemptible trainer on the one-rank mesh (main asserts the
    # bitwise resume), then its step-3 checkpoint restored onto DTensors
    workdir = os.path.join(os.path.dirname(CACHE_DIR), "mesh_checkpoints")
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        res = preemptible_main(workdir=os.path.join(workdir, "preempt"))
        restored, meta = elastic_restore(mesh, latest_checkpoint(os.path.join(workdir, "preempt")))
        if meta["step"] != 3 or sorted(restored) != sorted(res["pre_params"]):
            fail(f"mesh: the trainer's checkpoint restored step {meta['step']}")
        for k, v in res["pre_params"].items():
            if restored[k].placements != (Replicate(), Replicate()) or not torch.equal(
                    restored[k].full_tensor(), v):
                fail(f"mesh: {k} restored onto the mesh differs from the saved parameter")
        w = torch.arange(8 * 6, dtype=torch.float32, device=dev).reshape(8, 6)
        path = save_checkpoint(os.path.join(workdir, "sharded"), 1, {"w": w}, {})
        template = DTensor.from_local(torch.empty((8, 6), device="meta"), mesh,
                                      (Shard(0), Replicate()), shape=w.shape, stride=w.stride())
        rp, _, _ = restore_checkpoint(path, {"params": {"w": template}, "opt_state": None})
        if (rp["w"].placements != (Shard(0), Replicate()) or not rp["w"].to_local().is_cuda
                or not torch.equal(rp["w"].full_tensor(), w)):
            fail("mesh: a checkpoint restored onto a Shard(0) template is not bitwise")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    trainer_s = time.perf_counter() - t0
    dist.destroy_process_group()

    ratios = [m / u for m, u in zip(fps["mesh"], fps["unsharded"])]
    spread = [min(fps["unsharded"]), max(fps["unsharded"])]
    emit({"phase": "mesh", "card": card, "mesh": "make_mesh(): (data 1, model 1), NCCL",
          "config": "bench.py's main path, DCT wire, 6 cams x 372x1024 -> 256x704, batch 8, "
                    f"through get_pipeline(mesh=); 2 pairs of {MESH_BATCHES}-batch "
                    "windows in turns (unsharded, mesh, mesh, unsharded), each on a fresh "
                    f"pipeline after {MESH_CHECK_BATCHES} batches, the first mesh pipeline's "
                    "checked bitwise against the first unsharded one's",
          "frames_per_s": fps["mesh"], "unsharded_frames_per_s": fps["unsharded"],
          "mesh_over_unsharded_per_pair": ratios,
          "mesh_over_unsharded": float(np.median(ratios)),
          "mesh_median_inside_unsharded_spread":
              spread[0] <= float(np.median(fps["mesh"])) <= spread[1],
          "shard_batch_ms_per_batch": float(np.median(wrap_s)) * 1e3,
          "shard_batch_leaves": len(leaves), "main_frames_per_s": main_fps,
          "draw_gaussians_launches": launches, "pipeline_parallel": pp,
          "pipeline_parallel_s": pp_s,
          "preemptible": {"losses": [float(x) for x in res["ref_losses"]],
                          "resumed_bitwise": True, "restored_onto_mesh_bitwise": True},
          "trainer_and_restore_s": trainer_s, "phase_s": time.perf_counter() - t_phase})
    return launches


# sharded serving: the serving phase's detector at 8 x 256x704, exported on a
# one-rank mesh with its batch Shard(0) over data; per-batch ms of the sharded
# and the unsharded artifact in turns (unsharded, sharded, sharded, unsharded)
SHARDED_TURNS = 4
SHARDED_ITERS = 10
SHARDED_ARTIFACT = os.path.join(BUILD_DIR, "serving_sharded.accvserve")
MESH_PREPROCESS_ARTIFACT = os.path.join(BUILD_DIR, "preprocess_mesh.accvserve")
# moe: the example's widths (8 experts, dim 32, batch 8 x 16 x 12), both
# routings, 40 steps each; the first loss on the card against the CPU from
# the same init, relative (the bf16 expert products round differently)
MOE_TIMED = 20
MOE_CPU_RTOL = 2e-3
# dryrun: each stanza on a one-rank NCCL mesh against the same step
# unsharded on the card, through the port's own trainers, relative
DRYRUN_RTOL = 1e-4


def sharded_serving_phase(dev, card: str) -> int:
    """The sharded serving side on a one-rank NCCL mesh: the detector's
    sharded artifact rebound onto a fresh mesh, bitwise the unsharded
    artifact; the InferenceServer on it; the mesh pipeline's device program
    replayed bitwise its eager stage. Returns the rasterizer's launches."""
    import threading

    from torch.distributed.tensor import DTensor, Replicate, Shard

    from accvlab_tpu_torch.bench_pipeline import build_pipeline
    from accvlab_tpu_torch.detection_serving import seeded_detector
    from accvlab_tpu_torch.heatmap import LAUNCHES, reset_launch_counts
    from accvlab_tpu_torch.models import InferenceServer
    from accvlab_tpu_torch.models.serving import (
        _atomic_write,
        export_inference,
        load_inference,
        read_artifact_info,
    )
    from accvlab_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    model = seeded_detector(10, 64, seed=0, device=dev)
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(0, 1, (8, *WIDTH["out_hw"], 3)).astype(np.float32)
                              ).to(dev)
    mesh = make_mesh()
    batch_pl = (Shard(0), Replicate())
    plain = load_inference(export_inference(model, (images,)))
    t0 = time.perf_counter()
    data = export_inference(model, (images,), mesh=mesh, in_shardings=(batch_pl,))
    export_s = time.perf_counter() - t0
    _atomic_write(SHARDED_ARTIFACT, data)
    info = read_artifact_info(SHARDED_ARTIFACT)
    fresh = make_mesh()
    if fresh is mesh:
        fail("sharded_serving: make_mesh() returned the exporting mesh")
    sharded = load_inference(SHARDED_ARTIFACT, mesh=fresh)
    with torch.no_grad():
        want = plain(images)
        got = sharded(images)
    for k, v in got.items():
        if not (isinstance(v, DTensor) and v.placements == batch_pl and v.to_local().is_cuda):
            fail(f"sharded_serving: output {k} is not a DTensor Shard(0) over data on the card")
        if not torch.equal(v.to_local(), want[k]):
            fail(f"sharded_serving: output {k} differs from the unsharded artifact's")

    # ms per batch at bucket 8, in turns
    ms = {"unsharded": [], "sharded": []}
    with torch.no_grad():
        for turn in range(SHARDED_TURNS):
            kind = "sharded" if turn in (1, 2) else "unsharded"
            fn = sharded if kind == "sharded" else plain
            ms[kind] += event_ms(lambda: fn(images), SHARDED_ITERS)

    # the server on the sharded artifact: every request bitwise its batch row
    n = SERVE_CLIENTS * SERVE_PER_CLIENT
    requests = torch.from_numpy(rng.uniform(0, 1, (n, *WIDTH["out_hw"], 3)).astype(np.float32))
    requests[:, 0, 0, 0] = torch.arange(n, dtype=torch.float32)  # each request's tag
    server = InferenceServer.from_artifact(SHARDED_ARTIFACT, mesh=fresh,
                                           max_delay_ms=SERVE_MAX_DELAY_MS,
                                           pipeline_depth=SERVE_DEPTH)
    if server._buckets != (8,):
        fail(f"sharded_serving: the server's buckets are {server._buckets}, not the export's 8")
    batches = []
    loaded = server._fn

    def recorded(x):
        out = loaded(x)
        batches.append((x, out))
        return out

    server._fn = recorded
    results, lat = [None] * n, []

    def client(cid):
        for i in range(SERVE_PER_CLIENT):
            r = cid * SERVE_PER_CLIENT + i
            t = time.perf_counter()
            results[r] = server.infer(requests[r], timeout=120)
            lat.append((time.perf_counter() - t) * 1e3)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    st = server.stats()
    server.close()
    if st["requests"] != n or st["errors"]:
        fail(f"sharded_serving: the server answered {st['requests']} of {n}, {st['errors']} "
             "errors")
    where = {}
    for x, out in batches:
        for j in range(x.shape[0]):
            where.setdefault(int(x[j, 0, 0, 0]), (out, j))
    for r in range(n):
        out, j = where[r]
        if not all(not isinstance(results[r][k], DTensor)
                   and torch.equal(results[r][k], out[k].full_tensor()[j: j + 1]) for k in out):
            fail(f"sharded_serving: request {r} differs from its batch's row")

    # the mesh pipeline's device program, replayed through load_inference(mesh=)
    torch.cuda.synchronize()
    reset_launch_counts()
    pipe = build_pipeline(batch_size=WIDTH["batch"], device=dev, cache_dir=CACHE_DIR, mesh=mesh)
    try:
        pipe.run()
        pipe.run()
        pipe._halt_producer()
        idx, _, _, host = pipe._produce_host_batch()
        leaves = pipe._transfer(host)
        eager = pipe.run_device_stage(leaves, idx)
        header = pipe.export_device_program(MESH_PREPROCESS_ARTIFACT)
        replay = load_inference(MESH_PREPROCESS_ARTIFACT, mesh=fresh)
        torch.cuda.synchronize()
        before = LAUNCHES["draw_gaussians"]
        out = replay(leaves, (0, idx))
        torch.cuda.synchronize()
        if LAUNCHES["draw_gaussians"] != before + 1:
            fail("sharded_serving: the mesh stage's artifact did not launch the rasterizer once")
        for name, g, w in zip(header["pipeline_output_fields"], out, eager):
            if not (isinstance(g, DTensor) and g.placements == batch_pl
                    and torch.equal(g.to_local(), w)):
                fail(f"sharded_serving: the replayed {name} differs from the eager mesh stage")
    finally:
        pipe.stop()
    launches = LAUNCHES["draw_gaussians"]
    if launches != 4:
        fail(f"sharded_serving: draw_gaussians launched {launches} times for 2 batches, one "
             "eager stage and one replay")
    import torch.distributed as dist

    dist.destroy_process_group()
    emit({"phase": "sharded_serving", "card": card,
          "config": "seeded_detector(10, 64) at 8 x 256x704, exported on make_mesh() "
                    "(data 1, model 1, NCCL) with the batch Shard(0) over data, loaded on a "
                    "fresh mesh; bench.py's mesh pipeline (DCT wire, batch 8 x 6 cams) "
                    "exported through export_device_program",
          "header": {k: info[k] for k in ("nr_devices", "mesh", "in_placements",
                                          "out_placements")},
          "export_s": export_s, "bitwise_vs_unsharded": True,
          "sharded_ms_per_batch": float(np.median(ms["sharded"])),
          "unsharded_ms_per_batch": float(np.median(ms["unsharded"])),
          "sharded_over_unsharded": float(np.median(ms["sharded"]) / np.median(ms["unsharded"])),
          "ms_min_max": {k: [min(v), max(v)] for k, v in ms.items()},
          "turns": "unsharded, sharded, sharded, unsharded", "calls_per_turn": SHARDED_ITERS,
          "server": {"requests": n, "wall_s": wall, "requests_per_s": n / wall,
                     "client_p50_ms": float(np.percentile(lat, 50)),
                     "client_p95_ms": float(np.percentile(lat, 95)),
                     "batches": st["batches"], "padded_samples": st["padded_samples"],
                     "bitwise_vs_batch_row": True},
          "mesh_stage": {"leaves_in": len(leaves), "leaves_out": len(eager),
                         "bitwise_vs_eager": True, "draw_gaussians_per_call": 1},
          "draw_gaussians_launches": launches, "phase_s": time.perf_counter() - t_phase})
    return launches


def moe_phase(dev, card: str) -> None:
    """The expert-parallel MoE example on a one-rank NCCL mesh, both
    routings; step ms, launches, the first loss against the CPU, one step
    under the sync check."""
    import torch.distributed as dist

    from accvlab_tpu_torch import moe_expert_parallel_training as ex
    from accvlab_tpu_torch.models.moe import MoEClassifier, init_params, moe_loss
    from accvlab_tpu_torch.models.moe import make_moe_example_batch
    from accvlab_tpu_torch.tools.launch_counts import kernel_counts, launches

    t_phase = time.perf_counter()
    res = {}
    for k in (1, 2):
        mesh, last, losses = ex.train(k)
        if tuple(mesh.shape) != (1, 1) or not last < losses[0]:
            fail(f"moe: top-{k} on a {tuple(mesh.shape)} mesh, loss {losses[0]} -> {last}")
        model, batch, step, _ = ex.build(k, mesh=mesh)
        ms = event_ms(lambda: step(model, batch, ex.LR), MOE_TIMED)
        counts = kernel_counts(lambda: step(model, batch, ex.LR))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(model, batch, ex.LR)
        except RuntimeError as e:
            fail(f"moe: a top-{k} step synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        # the first loss: card against CPU from the same init and batch
        cpu = MoEClassifier(ex.NUM_EXPERTS, ex.DIM, ex.NUM_CLASSES, k, in_dim=ex.IN_DIM)
        init_params(cpu, torch.Generator().manual_seed(0))
        cpu_batch = make_moe_example_batch(ex.BATCH, ex.TOKENS, ex.IN_DIM, ex.NUM_CLASSES,
                                           device="cpu")
        with torch.no_grad():
            cpu_first = float(moe_loss(cpu, cpu_batch))
        rel = abs(losses[0] - cpu_first) / abs(cpu_first)
        if not np.isfinite(losses).all() or rel > MOE_CPU_RTOL:
            fail(f"moe: top-{k} first loss {losses[0]} on the card, {cpu_first} on the CPU")
        res[f"top{k}"] = {"losses_first_last": [losses[0], last], "cpu_first_loss": cpu_first,
                          "first_loss_rel_err": rel, "step_ms": float(np.median(ms)),
                          "step_ms_min_max": [min(ms), max(ms)],
                          "launches_per_step": launches(counts),
                          "launch_readings": counts["readings"],
                          "busy_ms_per_step": counts["busy_ms"], "sync_free_step": True,
                          "experts_per_rank": int(model.switch.w_in.to_local().shape[0])}
    dist.destroy_process_group()
    emit({"phase": "moe", "card": card,
          "config": "moe_expert_parallel_training: MoEClassifier(8 experts, dim 32, 5 "
                    "classes), batch 8 x 16 x 12, 40 SGD steps at lr 5e-2, on (data 1, "
                    "expert 1) over NCCL", "results": res, "cpu_rtol": MOE_CPU_RTOL,
          "phase_s": time.perf_counter() - t_phase})


def dryrun_phase(dev, card: str) -> None:
    """dryrun_multichip's six stanzas and the FSDP step on one-rank NCCL
    meshes, each against the same step unsharded on the card."""
    import torch.distributed as dist

    from accvlab_tpu_torch import dryrun_multichip as dr

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    res = dr.run_stanzas("cuda")
    sharded_s = time.perf_counter() - t0
    dist.destroy_process_group()
    out = {}
    for name, r in res.items():
        ref = dr.reference_loss(name, 1, dev)
        rel = abs(r["loss"] - ref) / abs(ref)
        if not (np.isfinite(r["loss"]) and rel <= DRYRUN_RTOL):
            fail(f"dryrun: {name}'s loss {r['loss']} on the mesh, {ref} unsharded")
        out[name] = {"loss": r["loss"], "unsharded_loss": ref, "rel_err": rel,
                     "mesh": r["mesh"], "local_shapes": r["local_shapes"]}
    emit({"phase": "dryrun", "card": card,
          "config": "accvlab_tpu_torch.dryrun_multichip.run_stanzas on one NCCL rank (every "
                    "mesh axis of size 1, the batches of 8 devices), each loss against "
                    "reference_loss (the port's unsharded trainers) on the card",
          "stanzas": out, "rtol": DRYRUN_RTOL, "sharded_s": sharded_s,
          "phase_s": time.perf_counter() - t_phase})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    import accvlab_tpu_torch  # noqa: F401  (fails outside a checkout of the repository)
    from accvlab_tpu_torch import _native_build
    from accvlab_tpu_torch.heatmap import _kernel
    from accvlab_tpu_torch.hostcopy import native as hostcopy_native
    from accvlab_tpu_torch.pipeline import dct_native, native_jpeg, wire_native
    from accvlab_tpu_torch.ragged import _auction_kernel

    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    card = f"{smi} (nvidia-smi name, power.limit)"
    emit({"phase": "header", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    builds = [_kernel.library_path, _auction_kernel.library_path, hostcopy_native.library_path,
              wire_native.library_path, native_jpeg.library_path, dct_native.library_path]
    with ThreadPoolExecutor(max_workers=len(builds)) as ex:  # one compiler per source, together
        libs = list(ex.map(lambda f: f(), builds))
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "libraries": libs,
          "compiler_seconds": _native_build.build_seconds, "libjpeg": native_jpeg.LINKED})

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    replaces, results, entry_launches, n_golden = kernel_phase(dev, flush)
    emit({"phase": "goldens", "bitwise_groups": n_golden})
    main_launches, main_fps = main_phase(dev, card)
    main_phase(dev, card, wire="yuv")
    main_frames_phase(dev, card)
    dct_wire_phase(dev, card)
    wire_phase(dev, card)
    echo_phase(dev, card)
    det2d_launches = det2d_phase(dev, card)
    steps_2d_phase(dev, card)
    workers_phase(dev, card)
    affine_sizes_phase(dev, card)
    train_parity_phase(dev)
    train_phase(dev, card)
    input_idle_phase(dev, card)
    petr_parity_phase(dev)
    trainer = petr_phase(dev, card)
    matching, matching_launches = matching_phase(dev, flush, card, trainer)
    loss_launches = matched_loss_phase(dev, card)
    serving_phase(dev, card)
    export_launches = export_phase(dev, card)
    polyline_phase(dev, card)
    lane_phase(dev, card)
    bev_phase(dev, card)
    elastic_phase(dev, card)
    tools_launches = tools_phase(dev, card)
    mesh_launches = mesh_phase(dev, card, main_fps)
    sharded_launches = sharded_serving_phase(dev, card)
    moe_phase(dev, card)
    dryrun_phase(dev, card)

    kernels = []
    for k in KINDS:
        r = results[(k, "main", False)]
        rx = results[(k, "main", True)]
        kernels.append({
            "name": ENTRY[k], "route": "cuda", "source": SOURCE, "replaces": replaces[k],
            "launches": (main_launches[ENTRY[k]] + det2d_launches + export_launches
                         + tools_launches + mesh_launches + sharded_launches
                         if k == "gaussians"
                         else entry_launches[ENTRY[k]]),
            "max_abs_err": max(r["max_abs_err"], rx["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "entry_ms": r["entry_ms"],
            "exact_ms": rx["ms"], "exact_plain_ms": rx["plain_ms"],
            "exact_bound_ms": rx["bound_ms"], "exact_entry_ms": rx["entry_ms"],
            "launches_from": (f"main path ({main_launches[ENTRY[k]]}), det2d "
                              f"({det2d_launches}), export ({export_launches}: the "
                              "pipeline's batches and the exported stage's call through the "
                              f"registered operator), tools ({tools_launches}), the "
                              f"main path on a mesh ({mesh_launches}) and the mesh "
                              f"pipeline's exported stage ({sharded_launches}: 2 batches, "
                              "the eager stage and its replay)"
                              if k == "gaussians"
                              else "entry-point drive"),
        })
    m = matching["example_48x300"]
    kernels.append({
        "name": "batched_auction_matching", "route": "cuda", "source": AUCTION_SOURCE,
        "replaces": "accvlab_tpu/ragged/matching.py:29 (auction_matching under vmap in "
                    "batched_auction_matching, an XLA while_loop; no Pallas kernel)",
        "launches": matching_launches + loss_launches,
        "max_abs_err": max(x["max_abs_err"] for x in matching.values()), "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
        "library_ms": None, "entry_ms": m["entry_ms"], "rounds": m["rounds"], "bids": m["bids"],
        "shape": m["shape"],
        "us_per_round": m["us_per_round"], "ns_per_bid": m["ns_per_bid"],
        "petr_shape_ms": matching["petr_32x192"]["ms"],
        "petr_shape_us_per_round": matching["petr_32x192"]["us_per_round"],
        "launches_from": f"matching phase (entry-point drive, {matching_launches}) and "
                         f"matched_loss (device-matched steps, {loss_launches})",
    })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
