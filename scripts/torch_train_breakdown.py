"""Where the PyTorch port's CenterNet train step spends its time, on one CUDA card.

Run from the repository root:  python3 scripts/torch_train_breakdown.py

The step of ``chip_smoke.py``'s ``train`` phase (``make_train_step`` of
``CenterNetDetector(10, width=64)``, 48 images of 256x704 from bench.py's
training pipeline) and the loop of ``bench_pipeline.measure_input_idle``,
each under ``torch.profiler``. Prints JSON lines:

* ``step``: device time per step by kind of kernel (convolutions; the
  elementwise and reduction kernels of GroupNorm, ReLU, casts and the loss;
  the optimizer; the rest) and the kernels that take the most time, over
  ``--steps`` steps on one cached batch;
* ``fed_loop``: the training loop fed by the pipeline (``pipe.run()`` then
  the dense step of ``measure_input_idle``, one synchronise at the end):
  ms per step and the device's busy share (kernel and copy time over wall
  time) over ``--steps`` steps.

Needs a card; prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from accvlab_tpu_torch.bench_pipeline import build_pipeline, dense_train_step  # noqa: E402
from accvlab_tpu_torch.models.centernet import (  # noqa: E402
    CenterNetDetector, adam, init_params, make_train_step)
from accvlab_tpu_torch.train_centernet_e2e import (  # noqa: E402
    batch_to_train_inputs, build_train_pipeline)

CAMS = list(range(6))
KINDS = [  # first match wins; names of the kernels cuDNN and PyTorch launch
    ("conv", ("conv", "cudnn", "xmma", "gemm", "wgrad", "dgrad", "cutlass", "nhwc")),
    ("optimizer", ("foreach", "multi_tensor", "adam")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy", "fill", "where")),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def device_rows(prof):
    """The profile's device events (kernels and copies): the host-side
    operator rows carry their kernels' time as well, and would count it
    twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def step_phase(steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    pipe = build_train_pipeline(batch_size=8)
    cached = batch_to_train_inputs(pipe.run(), cam=CAMS)
    pipe.stop()
    init_fn, step = make_train_step(CenterNetDetector(10, width=64))
    model, opt = init_fn(0, cached["images"])
    for _ in range(3):
        step(model, opt, cached)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(model, opt, cached)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    by_kind: dict = {}
    for e in rows:
        k = kind_of(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total / 1e3 / steps
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top = [{"name": e.key[:90], "kind": kind_of(e.key), "calls_per_step": e.count / steps,
            "device_ms_per_step": e.self_device_time_total / 1e3 / steps} for e in rows[:15]]
    return {"device_ms_per_step": sum(by_kind.values()), "by_kind_ms": by_kind, "top": top}


def fed_loop_phase(steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    pipe = build_pipeline(batch_size=8)
    model = init_params(CenterNetDetector(10, width=64), torch.Generator().manual_seed(0)).cuda()
    train = dense_train_step(model, adam(model.parameters()), len(CAMS))
    for _ in range(5):
        train(pipe.run())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = train(pipe.run())
        loss.item()
        wall = time.perf_counter() - t0
    pipe.stop()
    device_us = sum(e.self_device_time_total for e in device_rows(prof))
    return {"ms_per_step": wall / steps * 1e3, "device_ms_per_step": device_us / 1e3 / steps,
            "device_busy_share": device_us / 1e6 / wall, "note": "under the profiler"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = {"card": smi, "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    emit({"phase": "step", **card, **step_phase(args.steps)})
    emit({"phase": "fed_loop", **card, **fed_loop_phase(args.steps)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
