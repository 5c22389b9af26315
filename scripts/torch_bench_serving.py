"""Serving benchmark of the PyTorch port: batched calls per bucket + server latency.

The port's counterpart of ``scripts/bench_serving.py``, with its arguments
and its one JSON line:

1. **Batch amortization**: ms per batch of the served program (CenterNet at
   width 64 + ``decode_detections``, a batch-polymorphic ``torch.export``
   artifact loaded with ``models.serving.load_inference``) at each bucket
   size, timed with CUDA events (median of ``--iters``); images/s at batch 1
   against the largest bucket.
2. **InferenceServer end to end**: ``--clients`` threads each submit
   ``--per-client`` single images through the micro-batching server;
   requests/s, the bucket histogram, client-observed p50/p95 latency.

``--quantize int8|int4`` serves quantized weights (dequantized inside the
program). Runs on the card; ``--device cpu`` is a smoke run:
``python scripts/torch_bench_serving.py --device cpu --hw 64 96 --iters 3``.
Prints one JSON line on stdout (with the card's name and power limit);
diagnostics on stderr.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def card_name_and_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not available"


def time_call(fn, x, iters: int, cuda: bool) -> float:
    """Median ms of ``fn(x)`` over ``iters`` calls (CUDA events on the card)."""
    fn(x)
    times = []
    for _ in range(iters):
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn(x)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t = time.perf_counter()
            fn(x)
            times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", type=int, nargs=2, default=(256, 320))
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--buckets", type=int, nargs="+", default=(1, 2, 4, 8))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--per-client", type=int, default=25)
    ap.add_argument("--max-delay-ms", type=float, default=3.0)
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="in-flight dispatch window (2 overlaps host batching with the card)")
    ap.add_argument("--quantize", choices=("none", "int8", "int4"), default="none",
                    help="serve quantized weights (dequantized inside the program)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    from accvlab_tpu_torch._device import resolve_device
    from accvlab_tpu_torch.detection_serving import detection_fn, seeded_detector
    from accvlab_tpu_torch.models import InferenceServer
    from accvlab_tpu_torch.models.quantize import params_nbytes, quantize_params
    from accvlab_tpu_torch.models.serving import export_inference, load_inference

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    hw = tuple(args.hw)
    model = seeded_detector(args.classes, device=dev)
    max_b = max(args.buckets)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(0, 1, (max_b, *hw, 3)).astype(np.float32)).to(dev)

    quantized = None
    if args.quantize != "none":
        full = params_nbytes(model)
        quantized = quantize_params(model, bits=8 if args.quantize == "int8" else 4,
                                    group_size=None if args.quantize == "int8" else 64)
        log(f"quantize={args.quantize}: params {full / 1e6:.2f} -> "
            f"{params_nbytes(quantized) / 1e6:.2f} MB")
    example = images[:2] if max_b >= 2 else images.repeat(2, 1, 1, 1)
    art = export_inference(detection_fn(model, quantized=quantized), (example,),
                           batch_polymorphic=True)
    serve_fn = load_inference(art, device=dev)
    log(f"device={dev}, hw={hw}, buckets={tuple(args.buckets)}, artifact {len(art)} bytes")

    # ---- 1. batch amortization per bucket size -------------------------- #
    per_bucket = {}
    with torch.no_grad():
        for b in sorted(args.buckets):
            ms = time_call(serve_fn, images[:b], args.iters, cuda)
            per_bucket[b] = {"ms_per_batch": round(ms, 3), "img_per_s": round(b / ms * 1e3, 1)}
            log(f"bucket {b}: {ms:.3f} ms/batch = {b / ms * 1e3:.0f} img/s")
    amortization = per_bucket[max_b]["img_per_s"] / per_bucket[min(args.buckets)]["img_per_s"]

    # ---- 2. InferenceServer under concurrent clients --------------------- #
    server = InferenceServer(serve_fn, batch_sizes=tuple(args.buckets),
                             max_delay_ms=args.max_delay_ms, pipeline_depth=args.pipeline_depth)
    host_images = images.cpu()
    server.warmup(host_images[0])
    n = args.clients * args.per_client
    req_lat = [[] for _ in range(args.clients)]

    def client(cid):
        for i in range(args.per_client):
            t = time.perf_counter()
            server.infer(host_images[(cid + i) % max_b])
            req_lat[cid].append(time.perf_counter() - t)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(args.clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    st = server.stats()
    server.close()
    served_rps = n / wall
    lat = np.asarray([x for per in req_lat for x in per]) * 1e3
    log(f"server: {n} requests in {wall:.2f}s = {served_rps:.1f} req/s; buckets "
        f"{st['batch_size_counts']}, padded {st['padded_samples']}, request p50/p95 "
        f"{np.percentile(lat, 50):.1f}/{np.percentile(lat, 95):.1f} ms")

    print(json.dumps({
        "metric": "serving_requests_per_s",
        "value": round(served_rps, 1),
        "unit": "req/s",
        "pipeline_depth": args.pipeline_depth,
        "quantize": args.quantize,
        "backend": dev.type,
        "card": card_name_and_limit() if cuda else None,
        "hw": list(hw),
        "per_bucket": per_bucket,
        "batch_amortization_x": round(amortization, 2),
        "server_bucket_hist": {str(k): v for k, v in st["batch_size_counts"].items()},
        "server_padded": st["padded_samples"],
        "request_p50_ms": round(float(np.percentile(lat, 50)), 2),
        "request_p95_ms": round(float(np.percentile(lat, 95)), 2),
        "queue_wait_p95_ms": round(st["queue_wait"].get("p95_ms", 0.0), 2),
    }), flush=True)


if __name__ == "__main__":
    main()
