"""The DCT wire's device decode alone, per band grouping, on one CUDA card.

Run from the repository root:
  python3 scripts/torch_dct_device.py [--groupings dp16,split12,band,diag8] [--reps 50]

The port's counterpart of ``scripts/bench_dct_device.py``. For each grouping
it packs one headline batch on the host (bench.py's dataset: 8 samples x 6
cameras of 372x1024 q90 JPEG, out 256x704; ``dpN`` is
``optimize_band_groups`` over 3 of the provider's JPEGs with at most N
groups, as bench.py computes it), puts the stacked wire fields on the card
once, and times ``DCTWireUnpacker``'s step alone (the 6 cameras stacked, the
unpack, the exception patch, the DC predictor, the IDCT and the resize):
device ms per batch from CUDA events with the stream held by a sleep while
the host enqueues (median of ``--reps``, with the spread), the host's enqueue
ms, and the kernels per batch from ``torch.profiler``. It also holds 4
decoded luma and chroma planes against libjpeg's own pixel decode with the
JAX package's contract (luma within 2, chroma mean <= 6, p99 <= 24,
max <= 48).

Prints one JSON line per grouping, with the card's name and power limit.
Needs a card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC_HW, OUT_HW, BATCH = (372, 1024), (256, 704), 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groupings", default="dp16,split12,band,diag8")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 2
    from chip_smoke import CACHE_DIR, decode_readings
    from accvlab_tpu_torch.bench_pipeline import dct_grouping
    from accvlab_tpu_torch.pipeline import native_jpeg
    from accvlab_tpu_torch.pipeline.inputs import MultiCameraJpegProvider
    from accvlab_tpu_torch.pipeline.processing_steps import DCTWirePacker, DCTWireUnpacker

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    provider = MultiCameraJpegProvider(num_samples=BATCH, hw=SRC_HW, cache_dir=CACHE_DIR)
    ok = True
    for name in args.groupings.split(","):
        groups = dct_grouping(name, provider, SRC_HW, OUT_HW)
        packer = DCTWirePacker("image", SRC_HW, OUT_HW, grouping=groups)
        unpacker = DCTWireUnpacker("image", SRC_HW, OUT_HW, grouping=groups)
        samples = packer._process_batch([provider.get_data(i) for i in range(BATCH)])
        flat = [s.get_data() for s in samples]
        stacked = [np.stack([np.asarray(f[i]) for f in flat]) for i in range(len(flat[0]))]
        on_card = [torch.from_numpy(a).to(dev) for a in stacked]
        blueprint = samples[0].get_empty_like_self()

        def step():
            sdg = blueprint.get_empty_like_self()
            sdg.set_data(list(on_card))
            return unpacker._process(sdg)

        readings = decode_readings(step, args.reps)
        out = step()
        luma_max, chroma = 0, [0.0, 0.0, 0.0]
        for i in range(4):
            ref_y, ref_c = native_jpeg.decode_yuv420(provider.jpeg(i, 0), OUT_HW)
            cam = out["cameras"][0]
            y = cam["image"][i].cpu().numpy().astype(int)
            d = np.abs(cam["image_cbcr"][i].cpu().numpy().astype(int) - ref_c.astype(int))
            luma_max = max(luma_max, int(np.abs(y - ref_y.astype(int)).max()))
            chroma = [max(chroma[0], float(d.mean())), max(chroma[1], float(np.percentile(d, 99))),
                      max(chroma[2], float(d.max()))]
        goldens_ok = luma_max <= 2 and chroma[0] <= 6 and chroma[1] <= 24 and chroma[2] <= 48
        ok = ok and goldens_ok
        print(json.dumps({
            "metric": "DCT wire device decode (stack + unpack + IDCT + resize)", "card": smi,
            "grouping": name, "groups": len(packer.groups),
            "ms_per_batch": readings["device_ms"],
            "ms_min_max": [readings["device_ms_min"], readings["device_ms_max"]],
            "enqueue_host_ms": readings["enqueue_host_ms"], "launches": readings["launches"],
            "reps": args.reps, "frames_per_batch": BATCH * 6,
            "device_frames_per_s_ceiling": BATCH * 6 / readings["device_ms"] * 1e3,
            "wire_bytes_per_batch": int(sum(a.nbytes for a in stacked)),
            "widths": packer.last_batch_stats["widths"],
            "goldens_ok": goldens_ok, "luma_max_diff": luma_max,
            "chroma_mean_p99_max_diff": chroma,
        }), flush=True)
    return 0 if ok else 4


if __name__ == "__main__":
    sys.exit(main())
