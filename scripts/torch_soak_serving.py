"""Randomized serving-runtime soak: the port's InferenceServer under hostile
traffic (the counterpart of ``scripts/soak_serving.py``).

The in-suite server tests pin each contract point briefly; this campaign
composes them at random for a wall-clock budget. Every trial builds a
server from a random CONFIG (bucket set x delay window x pipeline depth x
queue bound) and throws a random SCENARIO at it from concurrent client
threads:

* mixed traffic — several client threads submit bursts with think-time
  jitter; some requests are poisoned (the fn raises on them), some futures
  are cancelled while queued, one thread polls ``stats()`` concurrently.
* close modes — the trial ends with ``close(drain=True)`` or
  ``close(drain=False)`` racing the last submits, or via the context
  manager.

The served function has three modes (``make_fn``), and computes on the card
unless the trial is given ``device="cpu"``:

* ``plain`` — eager torch, with the data-dependent raise on a poisoned
  sample (a host read of the batch);
* ``jit`` — through :func:`accvlab_tpu_torch.tools.shared_jit`, the port's
  counterpart of ``jax.jit``: one traced program per input shape, built at
  its first call (on the card a CUDA graph, replayed);
* ``ragged`` — a structured output with the port's ``RaggedBatch``, eager
  or through ``shared_jit``.

Invariants asserted per trial:

1. EVERY submitted future terminates (result, documented exception, or
   cancellation) — no hang, bounded by a per-trial deadline.
2. Successful results are correct (``fn`` is deterministic per sample)
   and carry the leading batch dim of 1.
3. Poisoned requests fail with the injected error; only they and their
   batchmates may see it.
4. The dispatcher never dies silently: after a mid-trial error/cancel
   storm, a fresh request still completes (while the server is open).

Failures print the trial's config + seed (the repro key) and the campaign
continues; the exit code reflects whether any trial failed.

Usage::

    python scripts/torch_soak_serving.py --minutes 10 [--seed 0] [--device cpu]
"""

import argparse
import concurrent.futures
import os
import sys
import threading
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def log(*args):
    print(*args, file=sys.stderr, flush=True)


POISON = 1e6


def jit(fn):
    """``fn`` through ``shared_jit``, one program per input spec (shape,
    dtype, device) traced at its first call, as ``jax.jit`` specializes."""
    from accvlab_tpu_torch.tools import shared_jit

    programs = {}

    def call(x):
        key = (tuple(x.shape), x.dtype, x.device)
        program = programs.get(key)
        if program is None:
            program = programs[key] = shared_jit(fn, (x,))
        return program(x)

    return call


def make_fn(mode, jit_it, device):
    """The served batched function of ``mode``, computing on ``device``
    (the server hands it the batch on the host)."""
    from accvlab_tpu_torch.ragged import RaggedBatch

    def to_device(x):
        return x.to(device, non_blocking=True)

    if mode == "plain":
        def fn(x):
            if float(x.max()) >= POISON:
                raise ValueError("poisoned sample")
            return to_device(x) * 2.0 + 1.0
        return fn  # eager: the data-dependent raise reads the batch on the host

    if mode == "jit":
        program = jit(lambda x: x * 2.0 + 1.0)
        return lambda x: program(to_device(x))

    def ragged_fn(x):  # structured output
        sizes = torch.clamp(x[:, 0].to(torch.int32) % 4, 0, 3)
        return {
            "rb": RaggedBatch(x * 2.0 + 1.0, sample_sizes=sizes),
            "sum": torch.sum(x, dim=-1, keepdim=True),
        }

    body = jit(ragged_fn) if jit_it else ragged_fn
    return lambda x: body(to_device(x))


def expected(x):
    return np.asarray(x) * 2.0 + 1.0


def _host(t):
    return t.cpu().numpy()


def trial_config(seed):
    """The trial's random config: ``(cfg, dim, jit_it)``, drawn from
    ``seed`` in ``scripts/soak_serving.py``'s order."""
    rng = np.random.default_rng(seed)
    mode = rng.choice(["plain", "jit", "ragged"])
    cfg = {
        "mode": str(mode),
        "buckets": tuple(sorted(rng.choice([1, 2, 3, 4, 8], size=rng.integers(1, 4), replace=False).tolist())),
        "delay_ms": float(rng.choice([0.0, 1.0, 5.0, 25.0])),
        "depth": int(rng.integers(1, 4)),
        "max_queue": int(rng.choice([0, 0, 8])),
        "clients": int(rng.integers(1, 5)),
        "per_client": int(rng.integers(3, 15)),
        "poison_p": float(rng.choice([0.0, 0.15])) if mode == "plain" else 0.0,
        "cancel_p": float(rng.choice([0.0, 0.2])),
        "close": str(rng.choice(["drain", "nodrain", "context"])),
    }
    dim = int(rng.integers(1, 6))
    return cfg, dim, bool(rng.integers(0, 2))


def run_trial(seed, device=None) -> bool:
    from accvlab_tpu_torch._device import resolve_device
    from accvlab_tpu_torch.models.server import InferenceServer, ServerClosed

    dev = resolve_device(device)
    cfg, dim, jit_it = trial_config(seed)
    mode = cfg["mode"]
    fn = make_fn(mode, jit_it, dev)
    deadline = time.time() + 120.0

    def check_result(res, x, poisoned):
        if mode == "ragged":
            out = _host(res["rb"].tensor)
            np.testing.assert_allclose(out, expected(x)[None], rtol=1e-5)
            assert tuple(res["sum"].shape) == (1, 1)
        else:
            out = _host(res)
            assert out.shape == (1, dim), out.shape
            np.testing.assert_allclose(out, expected(x)[None], rtol=1e-5)

    server = InferenceServer(
        fn,
        batch_sizes=cfg["buckets"],
        max_delay_ms=cfg["delay_ms"],
        max_queue=cfg["max_queue"],
        pipeline_depth=cfg["depth"],
        device=dev,
    )
    records = []  # (future, x, poisoned, cancelled)
    rec_lock = threading.Lock()
    client_errors = []

    def client(cid):
        crng = np.random.default_rng((seed, cid))
        try:
            for i in range(cfg["per_client"]):
                poisoned = crng.uniform() < cfg["poison_p"]
                x = crng.uniform(0, 10, dim).astype(np.float32)
                if poisoned:
                    x[0] = POISON
                try:
                    fut = server.submit(x)
                except ServerClosed:
                    return  # raced the close — legal
                cancelled = False
                if crng.uniform() < cfg["cancel_p"]:
                    cancelled = fut.cancel()  # may fail if already running
                with rec_lock:
                    records.append((fut, x, poisoned, cancelled))
                if crng.uniform() < 0.3:
                    time.sleep(float(crng.uniform(0, 0.01)))
        except Exception:
            client_errors.append(traceback.format_exc())

    threads = [threading.Thread(target=client, args=(c,)) for c in range(cfg["clients"])]
    poller_stop = threading.Event()
    poller_errors = []

    def poller():
        try:
            while not poller_stop.is_set():
                st = server.stats()
                # errored batches don't enter the histogram -> <=
                assert sum(st["batch_size_counts"].values()) <= st["batches"]
                assert st["errors"] <= st["requests"]
                time.sleep(0.002)
        except Exception:
            poller_errors.append(traceback.format_exc())

    pt = threading.Thread(target=poller, daemon=True)
    # a raising trial must never leak the poller/server (a live non-daemon
    # thread blocks interpreter exit; an unclosed server leaks its queue)
    try:
        pt.start()
        for t in threads:
            t.start()
        # liveness probe mid-storm (invariant 4) — only while surely open.
        # The probe may get batched with a poisoned client request and eat
        # the documented batchmate-collateral error; retry through those.
        mid_x = np.full(dim, 3.0, np.float32)
        for _ in range(8):
            try:
                check_result(server.infer(mid_x, timeout=60), mid_x, False)
                break
            except ServerClosed:
                break
            except ValueError as e:
                assert "poisoned" in str(e) and cfg["poison_p"] > 0, e
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.time()))
            assert not t.is_alive(), "client thread hung"

        if cfg["close"] == "drain":
            server.close(drain=True)
        elif cfg["close"] == "nodrain":
            server.close(drain=False)
        else:
            with server:
                pass
    finally:
        poller_stop.set()
        pt.join(10)
        server.close(drain=False)  # idempotent; no-op after a cfg close

    ok = True
    for fut, x, poisoned, cancelled in records:
        timeout = max(0.0, deadline - time.time()) + 5.0
        try:
            res = fut.result(timeout=timeout)
            check_result(res, x, poisoned)
            if poisoned:
                log(f"  POISONED REQUEST RETURNED A RESULT (seed {seed})")
                ok = False
        except concurrent.futures.CancelledError:
            assert cancelled, "uncancelled future reported cancelled"
        except ValueError as e:
            # injected poison: the poisoned request and (plain mode batches
            # are bucket-padded) its batchmates may see it
            assert "poisoned" in str(e), e
        except ServerClosed:
            assert cfg["close"] == "nodrain", (
                "ServerClosed outside the nodrain close mode"
            )
        except concurrent.futures.TimeoutError:
            log(f"  FUTURE NEVER TERMINATED (seed {seed}, cfg {cfg})")
            ok = False
    if client_errors:
        log(f"  CLIENT THREAD ERROR (seed {seed}): {client_errors[0]}")
        ok = False
    if poller_errors:
        log(f"  STATS POLLER ERROR (seed {seed}): {poller_errors[0]}")
        ok = False
    if not ok:
        log(f"  TRIAL FAILED seed={seed} cfg={cfg}")
    return ok


def campaign(seconds, seed=0, device=None) -> dict:
    """Trials from ``seed`` on for ``seconds``: ``{"trials", "failures",
    "failed_seeds", "modes"}`` (a trial that raises counts as failed)."""
    end = time.time() + seconds
    trials = failures = 0
    failed, modes = [], {}
    while time.time() < end:
        mode = trial_config(seed)[0]["mode"]
        modes[mode] = modes.get(mode, 0) + 1
        trials += 1
        try:
            ok = run_trial(seed, device)
        except Exception:
            ok = False
            log(f"TRIAL EXCEPTION seed={seed}\n{traceback.format_exc()}")
        if not ok:
            failures += 1
            failed.append(seed)
        if trials % 20 == 0:
            log(f"[{time.strftime('%H:%M:%S')}] {trials} trials, {failures} failures")
        seed += 1
    return {"trials": trials, "failures": failures, "failed_seeds": failed, "modes": modes}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="'cpu' for the CPU (default: the card)")
    args = ap.parse_args()

    res = campaign(args.minutes * 60, args.seed, args.device)
    print(f"serving soak: {res['trials']} trials, {res['failures']} failures", flush=True)
    sys.exit(1 if res["failures"] else 0)


if __name__ == "__main__":
    main()
