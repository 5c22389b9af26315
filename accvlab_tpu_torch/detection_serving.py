"""Detection serving on the port: checkpoint -> artifact -> micro-batched requests.

The port's counterpart of ``examples/detection_serving.py``:

1. persist a CenterNet checkpoint (:mod:`.models.checkpoint`), restore it,
   and time one batched forward with ``decode_detections``;
2. export the forward and the decode as ONE batch-polymorphic serving
   artifact (:mod:`.models.serving`), reload it with no model code, serve an
   unseen batch size, and report its drift from the live module;
3. serve the artifact through the micro-batching
   :class:`~.models.server.InferenceServer` (4 clients x 6 requests) and
   print its ``stats()``.

Runs on the card unless ``device="cpu"`` is given::

    python -m accvlab_tpu_torch.detection_serving [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, Optional

import torch

from ._device import resolve_device
from .models.centernet import CenterNetDetector, decode_detections, init_params
from .models.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint


def detection_fn(model: torch.nn.Module, params: Optional[Dict] = None,
                 quantized: Optional[Dict] = None) -> Callable:
    """``fn(images) -> {"heatmap", "offset", "size", "detections"}``: the
    model's heads and their ``decode_detections`` (a dict of RaggedBatch).
    ``params`` replaces the model's own parameters; ``quantized`` (from
    :func:`.models.quantize.quantize_params`) serves quantized weights,
    dequantized inside the call."""
    if quantized is not None:
        from .models.quantize import freeze_params_quantized

        forward = freeze_params_quantized(model, quantized)
    elif params is not None:
        def forward(images):
            return torch.func.functional_call(model, params, (images,))
    else:
        forward = model

    def fn(images):
        heads = forward(images)
        return {**heads, "detections": decode_detections(heads)}

    return fn


def seeded_detector(num_classes: int = 10, width: int = 64, seed: int = 0,
                    device=None) -> CenterNetDetector:
    """A CenterNet with flax's initialisers drawn from ``seed`` on the CPU,
    on ``device`` (default the card), in eval mode, without gradients."""
    model = CenterNetDetector(num_classes=num_classes, width=width)
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device)).eval().requires_grad_(False)


def main(batch_size: int = 8, hw=(256, 320), num_classes: int = 10, device=None) -> float:
    """Run the three stages; returns the batched call's ms per batch."""
    from .models import InferenceServer
    from .models.serving import load_inference, save_inference

    dev = resolve_device(device)
    model = seeded_detector(num_classes, device=dev)
    images = torch.rand((batch_size, *hw, 3), generator=torch.Generator().manual_seed(0)).to(dev)

    # --- train side: persist a checkpoint (stand-in for a training run) ---- #
    ckpt_dir = tempfile.mkdtemp()
    state = model.state_dict()
    save_checkpoint(ckpt_dir, 1000, state, None, {"model_classes": num_classes})

    # --- serving side: restore, one batched forward + decode --------------- #
    path = latest_checkpoint(ckpt_dir)
    restored, _, meta = restore_checkpoint(path, {"params": state, "opt_state": None})
    print(f"restored step-{meta['step']} checkpoint (pipeline meta: {meta['pipeline']})")
    serve = detection_fn(model, params=restored)
    with torch.no_grad():
        out = serve(images)  # warm-up
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        sync()
        iters = 20
        t0 = time.perf_counter()
        for _ in range(iters):
            out = serve(images)
        sync()
    ms = (time.perf_counter() - t0) / iters * 1e3
    sizes = out["detections"]["boxes"].sample_sizes.tolist()
    print(f"serve({batch_size}x{hw[0]}x{hw[1]}): {ms:.2f} ms/batch "
          f"({batch_size / ms * 1e3:.0f} img/s), detections per image: {sizes} "
          "(random weights: every peak clears the threshold)")

    # --- deployment artifact: program + weights in one file ---------------- #
    art_path = os.path.join(ckpt_dir, "detector.accvserve")
    info = save_inference(art_path, serve, images, batch_polymorphic=True)
    served = load_inference(art_path, device=dev)
    art_out = served(images[:3])  # an unseen batch size, no re-export
    with torch.no_grad():
        ref_out = model(images[:3])
    drift = float((art_out["heatmap"] - ref_out["heatmap"]).abs().max())
    print(f"exported {os.path.getsize(art_path) / 1e6:.2f} MB artifact (format "
          f"v{info['format_version']}, platforms {info['platforms']}, batch-polymorphic); "
          f"reload drift against the live module: {drift:.2e}")

    # --- serving runtime: micro-batched requests ---------------------------- #
    server = InferenceServer.from_artifact(art_path, device=dev, batch_sizes=(1, 2, 4, 8),
                                           max_delay_ms=3.0)
    server.warmup(images[0])
    n_clients, per_client = 4, 6
    results = {}

    def client(cid):
        for i in range(per_client):
            results[(cid, i)] = server.infer(images[(cid + i) % batch_size])

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    st = server.stats()
    server.close()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    assert len(results) == n_clients * per_client
    print(f"served {st['requests']} concurrent requests in {wall * 1e3:.0f} ms as "
          f"{st['batches']} batches (bucket histogram {st['batch_size_counts']}, "
          f"{st['padded_samples']} padded); exec p50 {st['exec'].get('p50_ms', 0):.1f} ms, "
          f"queue-wait p95 {st['queue_wait'].get('p95_ms', 0):.1f} ms")
    return ms


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--hw", type=int, nargs=2, default=(256, 320))
    a = ap.parse_args()
    main(a.batch_size, tuple(a.hw), device=a.device)
