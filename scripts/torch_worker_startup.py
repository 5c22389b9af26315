"""Where the start of the port's process workers goes, on the card machine.

Times, for a pool of ``--workers`` spawned processes:

1. ``bare``: a spawn pool whose workers import nothing of the port, until
   every worker has answered one task;
2. ``port``: the pool that ``get_pipeline(worker_mode="process")`` makes
   (``worker_pool.ProcessSampleWorkers`` with bench.py's input callable and
   the YUV wire's per-sample host steps), until every worker has answered;
   ``port_spawn_pipe``: the same start arguments sent through the spawn
   pipe instead of the payload file, which starts the workers one after
   another;
3. ``pipeline``: ``bench_pipeline.build_pipeline(worker_mode="process")``
   on the card until its first batch (the pool's start plus one batch),
   beside the same in thread mode.

Run on the card:  python3 scripts/torch_worker_startup.py [--workers 8]
Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _init_from_args(*args):
    """An initializer whose start arguments travel through the spawn pipe."""
    import torch

    torch.set_num_threads(1)


def _pool_ready_s(n: int, initializer=None, initargs=()) -> float:
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(n, initializer=initializer, initargs=initargs) as pool:
        pool.map(abs, range(n), chunksize=1)
        return time.perf_counter() - t0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workers", type=int, default=os.cpu_count() or 8)
    args = parser.parse_args()

    import torch

    from accvlab_tpu_torch.bench_pipeline import build_pipeline
    from accvlab_tpu_torch.pipeline import worker_pool

    n = args.workers
    cache = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
                         "bench_cache")
    kw = dict(batch_size=8, cache_dir=cache, wire="yuv", decoder="native")
    cpu_pipe = build_pipeline(device="cpu", **kw)  # its input and steps, never run
    port_args = (cpu_pipe._definition._input, cpu_pipe._host_steps, cpu_pipe._input_blueprint,
                 False, 0)
    out = {"workers": n, "cores": os.cpu_count(),
           "payload_bytes": len(pickle.dumps(port_args))}
    out["bare_s"] = _pool_ready_s(n)
    t0 = time.perf_counter()
    workers = worker_pool.ProcessSampleWorkers(n, *port_args)
    try:
        workers._pool.map(abs, range(n), chunksize=1)
        out["port_s"] = time.perf_counter() - t0
    finally:
        workers.shutdown()
    out["port_spawn_pipe_s"] = _pool_ready_s(n, _init_from_args, port_args)
    if torch.cuda.is_available():
        for mode in ("thread", "process"):
            t0 = time.perf_counter()
            pipe = build_pipeline(device="cuda", num_threads=n, worker_mode=mode, **kw)
            try:
                pipe.run()
                torch.cuda.synchronize()
                out[f"pipeline_first_batch_{mode}_s"] = time.perf_counter() - t0
            finally:
                pipe.stop()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
