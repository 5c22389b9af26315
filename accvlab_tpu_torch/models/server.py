"""Micro-batching inference server: the serving runtime on top of the serving
artifacts (:mod:`.serving`).

PyTorch port of ``accvlab_tpu/models/server.py``, rule for rule. The card
runs one batch about as fast as one request, so requests are gathered into
the largest batch the latency budget allows, padded to one of a few static
bucket sizes:

* requests arrive on a thread-safe queue (any number of client threads);
* a dispatcher thread collects them for at most ``max_delay_ms`` (or until
  the largest bucket fills), pads the group to the smallest bucket that
  holds it by replicating the last sample, runs ONE batched call, and fans
  the results back out to per-request futures;
* ``warmup()`` runs every bucket once before traffic.

The batch is stacked on the host, in pinned memory when ``fn`` serves on
the card, and the call's inputs are copied without blocking. After
dispatch the dispatcher records a CUDA event and completes the batch by
synchronising on it, so with ``pipeline_depth=2`` the host batches the next
requests while the card runs the previous batch.

Contract
--------
``fn`` is a *batched* function: every input and output leaf has a leading
batch dimension. ``submit(*args)`` takes ONE sample with *unbatched* leaves;
results keep the batched structure with leading dimension 1, so structured
outputs (a :class:`~accvlab_tpu_torch.ragged.RaggedBatch` of detections)
come back whole. Batch-level extra inputs (the key of a pipeline device
program) are the caller's to close over::

    serve = load_inference("preprocess.accvserve")
    server = InferenceServer(lambda *leaves: serve(leaves, FIXED_KEY))

Example::

    save_inference(path, model, example, batch_polymorphic=True)
    server = InferenceServer.from_artifact(path, batch_sizes=(1, 2, 4, 8))
    server.warmup(example_sample)                  # every bucket once
    fut = server.submit(sample)                    # from any thread
    out = fut.result()                             # leaves have leading dim 1
    ...
    server.close()                                 # drains by default
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor


class ServerClosed(RuntimeError):
    """The server no longer accepts (or will not complete) requests."""


_SENTINEL = object()


class _Request:
    __slots__ = ("args", "future", "t_enqueue")

    def __init__(self, args):
        self.args = args
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()


def _fail(req: _Request, exc: BaseException) -> None:
    """set_exception that tolerates a client-cancelled future: an
    InvalidStateError here must never escape into the dispatcher loop."""
    try:
        req.future.set_exception(exc)
    except Exception:
        pass


def _stack_samples(args_list, pad_to: int, pin: bool = False):
    """Stack per-sample arg trees into one batched arg tree of CPU tensors
    (pinned with ``pin``), padding by replicating the last sample
    (numerically safe filler for any program)."""
    reps = list(args_list) + [args_list[-1]] * (pad_to - len(args_list))

    def stack(*xs):
        out = torch.stack([x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
                           for x in xs])
        return out.pin_memory() if pin else out

    return pytree.tree_map(stack, *reps)


class InferenceServer:
    """Thread-safe micro-batching wrapper around a batched inference fn.

    Args:
        fn: batched callable, every input/output leaf with a leading batch
            dimension (a :class:`~.serving.LoadedInference` is one). Never
            called concurrently (dispatcher, warmup and post-close reaping
            serialize on a lock).
        batch_sizes: the static bucket sizes (sorted here); the largest is
            the per-dispatch batch cap.
        max_delay_ms: how long the dispatcher waits after the first queued
            request for the batch to fill before running a partial bucket.
        max_queue: queue bound (``submit`` blocks when full); 0 = unbounded.
        pipeline_depth: how many dispatched batches may be in flight before
            the dispatcher waits for the oldest. Kernel launches return
            before the card finishes, so depth 2 overlaps the host's batching
            (queue pull, stack, pad) with the card's run of the previous
            batch; 1 (default) completes each batch before collecting the
            next (lowest latency). Idle periods always flush the window.
        device: where ``fn`` computes; default ``fn.device`` when it has one
            (a LoadedInference), else the CPU. On a CUDA device the batch is
            stacked in pinned memory and completion waits on a CUDA event.

    When ``fn`` is a sharded artifact on a mesh of several ranks (its
    ``mesh``), see :meth:`from_artifact`.
    """

    def __init__(
        self,
        fn: Callable,
        *,
        batch_sizes: Sequence[int] = (1, 2, 4, 8),
        max_delay_ms: float = 2.0,
        max_queue: int = 0,
        pipeline_depth: int = 1,
        device=None,
    ):
        if not batch_sizes or any(int(b) < 1 for b in batch_sizes):
            raise ValueError(f"batch_sizes must be positive ints, got {batch_sizes!r}")
        if int(pipeline_depth) < 1:
            raise ValueError(f"pipeline_depth={pipeline_depth} must be >= 1")
        self._depth = int(pipeline_depth)
        self._fn = fn
        mesh = getattr(fn, "mesh", None)
        self._mesh = mesh if mesh is not None and mesh.size() > 1 else None
        if self._mesh is not None and self._depth > 1:
            raise ValueError("a sharded artifact serves with pipeline_depth=1: each batch's "
                             "gather must complete on every rank before the next is formed")
        dev = torch.device(device if device is not None else getattr(fn, "device", "cpu"))
        self._cuda = dev if dev.type == "cuda" else None
        self._buckets = tuple(sorted(set(int(b) for b in batch_sizes)))
        self._max_delay = float(max_delay_ms) / 1000.0
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._closed = False
        self._drain_on_close = True
        self._close_lock = threading.Lock()
        # serializes every self._fn call: the dispatcher owns the hot path,
        # but warmup() runs from the caller thread and must not overlap it
        self._fn_lock = threading.Lock()
        # serializes straggler reaping after the dispatcher has exited
        self._reap_lock = threading.Lock()

        # stats (dispatcher-thread writes; the lock is shared with stats()
        # readers because deque iteration concurrent with append raises)
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._n_batches = 0
        self._n_errors = 0
        self._n_padded = 0
        self._bucket_counts = collections.Counter()
        self._exec_s = collections.deque(maxlen=10_000)
        self._wait_s = collections.deque(maxlen=10_000)

        self._thread = threading.Thread(
            target=self._serve_loop if self._mesh is None else self._serve_loop_mesh,
            name="accvlab-inference-server", daemon=True
        )
        self._thread.start()

    @classmethod
    def from_artifact(cls, path_or_bytes, *, device=None, mesh=None,
                      **kwargs) -> "InferenceServer":
        """Serve a :mod:`.serving` artifact on ``device`` (default the card;
        raises without one unless ``device="cpu"``). No model code needed.

        An artifact exported without ``batch_polymorphic`` takes exactly its
        export-time batch size, so when no ``batch_sizes`` is given the
        server uses that single bucket.

        ``mesh``: serve a sharded artifact (``load_inference(mesh=)``). Each
        batch is placed on the mesh per the artifact's placements and its
        outputs are gathered to full tensors before the fan-out. Every rank
        of the mesh runs a server and is given the same requests in the same
        order, at whatever time each reaches it. On a mesh of several ranks
        the rank at mesh coordinate 0 forms each batch on its own
        ``max_delay_ms`` timer and broadcasts its size; every other rank
        takes that many requests from its queue, in order, so every rank
        runs the same batches and each row of the gathered outputs goes to
        its own request. Such a server runs one batch at a time
        (``pipeline_depth=1``), and ``close()`` always drains: a request
        that one rank has batched is run by all.
        """
        from . import serving

        loaded = serving.load_inference(path_or_bytes, device=device, mesh=mesh)
        shapes = loaded.input_shapes
        if "batch_sizes" not in kwargs and shapes is not None:
            batched = {int(s[0]) for s in shapes if len(s) >= 1}
            if len(batched) > 1:
                raise ValueError(
                    "cannot infer the bucket size: the artifact's inputs have differing "
                    f"leading dims {sorted(batched)} (a batch-level input?). Pass "
                    "batch_sizes= explicitly, or close batch-level inputs over the fn "
                    "before export."
                )
            if batched:
                kwargs["batch_sizes"] = (batched.pop(),)
        return cls(loaded, **kwargs)

    # ------------------------------------------------------------------ #
    # client API                                                         #
    # ------------------------------------------------------------------ #

    def submit(self, *args) -> Future:
        """Enqueue one sample (unbatched leaves); returns its Future, whose
        result keeps the batched structure with leading dim 1."""
        if self._closed:
            raise ServerClosed("submit() on a closed InferenceServer")
        req = _Request(args)
        self._q.put(req)
        # submit/close race: if close() finished its drain between our
        # closed-check and the put, nobody reads this queue again; reap it
        # here (completes or fails req per the drain flag)
        if self._closed and not self._thread.is_alive():
            self._reap_stragglers()
        return req.future

    def submit_many(self, samples: Sequence[tuple]) -> list:
        """Enqueue several samples (each an args tuple); list of Futures."""
        return [self.submit(*args) for args in samples]

    def infer(self, *args, timeout: Optional[float] = None):
        """Blocking convenience: ``submit(*args).result(timeout)``."""
        return self.submit(*args).result(timeout)

    def warmup(self, *example_args) -> None:
        """Run the batched fn once per bucket on replicas of
        ``example_args`` (blocking), so that no bucket's first call lands on
        traffic. Safe under live traffic: the calls serialize with the
        dispatcher's."""
        for b in self._buckets:
            with self._fn_lock:
                self._fn(*self._stack([example_args], b))
            if self._cuda is not None:
                torch.cuda.synchronize(self._cuda)

    def stats(self) -> dict:
        """Counters and latency percentiles over the last <= 10k requests.

        ``exec`` is dispatch -> fan-out per batch. With ``pipeline_depth >
        1`` completion is deferred while the next batch is collected, so it
        then includes up to one batching window of overlap: a pipeline
        residence time, not device latency. For the client's latency, time
        ``submit() -> result()`` at the call site."""

        def pct(xs):
            if not xs:
                return {}
            a = np.asarray(xs) * 1000.0
            return {
                "p50_ms": float(np.percentile(a, 50)),
                "p95_ms": float(np.percentile(a, 95)),
                "p99_ms": float(np.percentile(a, 99)),
            }

        with self._stats_lock:
            exec_s, wait_s = list(self._exec_s), list(self._wait_s)
            return {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "errors": self._n_errors,
                "padded_samples": self._n_padded,
                "batch_size_counts": dict(self._bucket_counts),
                "queue_depth": self._q.qsize(),
                "exec": pct(exec_s),
                "queue_wait": pct(wait_s),
            }

    def close(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop the server. ``drain=True`` completes queued requests first;
        ``drain=False`` fails them with :class:`ServerClosed`. Idempotent."""
        with self._close_lock:
            if not self._closed:
                self._closed = True
                self._drain_on_close = drain
                self._q.put(_SENTINEL)
        self._thread.join(timeout)
        if not self._thread.is_alive():
            # catch requests that raced past the closed-check into the
            # queue after the dispatcher finished draining
            self._reap_stragglers()

    def _reap_stragglers(self) -> None:
        with self._reap_lock:
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    return
                if item is _SENTINEL:
                    continue
                if self._mesh is not None:  # no dispatcher left to agree a batch with
                    _fail(item, ServerClosed("submit() raced close() of a sharded server"))
                elif self._drain_on_close:
                    self._run_batch([item])
                else:
                    _fail(item, ServerClosed("server closed with drain=False"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------ #
    # dispatcher                                                         #
    # ------------------------------------------------------------------ #

    def _stack(self, args_list, bucket: int):
        return _stack_samples(args_list, bucket, pin=self._cuda is not None)

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _serve_loop(self):
        max_bucket = self._buckets[-1]
        stopping = False
        inflight = collections.deque()
        while not stopping:
            if inflight and self._q.qsize() == 0:
                # no traffic waiting: resolve the overlap window before
                # blocking, so idle periods never delay completed results
                while inflight:
                    self._complete_batch(*inflight.popleft())
            first = self._q.get()
            if first is _SENTINEL:
                break
            if self._closed and not self._drain_on_close:
                _fail(first, ServerClosed("server closed with drain=False"))
                continue
            batch = [first]
            deadline = time.monotonic() + self._max_delay
            while len(batch) < max_bucket:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    stopping = True
                    break
                batch.append(nxt)
            rec = self._dispatch_batch(batch)
            if rec is not None:
                inflight.append(rec)
            while len(inflight) >= self._depth:
                self._complete_batch(*inflight.popleft())
        while inflight:
            self._complete_batch(*inflight.popleft())
        # shutdown: the queue may still hold requests enqueued before (or
        # racing with) close(); finish or fail them per the drain flag
        leftovers = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _SENTINEL:
                leftovers.append(item)
        if self._drain_on_close:
            for i in range(0, len(leftovers), max_bucket):
                self._run_batch(leftovers[i: i + max_bucket])
        else:
            for req in leftovers:
                _fail(req, ServerClosed("server closed with drain=False"))

    def _serve_loop_mesh(self):
        """The dispatcher on a mesh of several ranks (see
        :meth:`from_artifact`). A rank enters the broadcast of the batch size
        only once it holds a request, so an idle server waits in no
        collective."""
        leader = all(c == 0 for c in self._mesh.get_coordinate())
        max_bucket = self._buckets[-1]
        stopping = False
        while not stopping:
            first = self._q.get()
            if first is _SENTINEL:
                break
            batch = [first]
            if leader:
                deadline = time.monotonic() + self._max_delay
                while len(batch) < max_bucket:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if nxt is _SENTINEL:
                        stopping = True
                        break
                    batch.append(nxt)
                self._agree(len(batch))
            else:
                n = self._agree(0)
                while len(batch) < n:
                    nxt = self._q.get()
                    if nxt is _SENTINEL:  # the leader batched a request this rank never got
                        stopping = True
                        break
                    batch.append(nxt)
            self._run_batch(batch)

    def _agree(self, n: int) -> int:
        """The leader's ``n`` on every rank of the mesh: a broadcast from
        coordinate 0 along each mesh dim in turn."""
        import torch.distributed as dist

        from ..parallel.mesh import mesh_device

        mesh = self._mesh
        t = torch.tensor([n], dtype=torch.int64, device=mesh_device(mesh))
        coord = list(mesh.get_coordinate())
        for d in range(mesh.ndim):
            if mesh.size(d) > 1:
                src = coord[:d] + [0] + coord[d + 1:]
                dist.broadcast(t, src=int(mesh.mesh[tuple(src)]), group=mesh.get_group(d))
        return int(t.item())

    def _run_batch(self, batch):
        """Dispatch + complete in one blocking call (reap/drain paths)."""
        rec = self._dispatch_batch(batch)
        if rec is not None:
            self._complete_batch(*rec)

    def _dispatch_batch(self, batch):
        """Stack, pad and dispatch one batch; returns the in-flight record
        ``(batch, out, bucket, t0, event)`` or None if it already failed or
        emptied. Launches return before the card finishes, so the card
        computes while the dispatcher collects the next batch."""
        # transition futures to RUNNING; drop the ones the client cancelled
        # while they were queued (fulfilling a cancelled future raises
        # InvalidStateError, which would kill this thread). On a mesh every
        # rank runs the batch the leader formed, so a cancelled request keeps
        # its row there and only its result is dropped.
        live = [r.future.set_running_or_notify_cancel() for r in batch]
        if self._mesh is None:
            batch = [r for r, ok in zip(batch, live) if ok]
        if not batch:
            return None
        n = len(batch)
        bucket = self._bucket_for(n)
        t0 = time.monotonic()
        with self._stats_lock:
            for req in batch:
                self._wait_s.append(t0 - req.t_enqueue)
        try:
            with self._fn_lock:
                out = self._fn(*self._stack([r.args for r in batch], bucket))
            event = None
            if self._cuda is not None:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self._cuda))
        except BaseException as e:  # noqa: BLE001 (fan the error out)
            with self._stats_lock:
                self._n_errors += n
                self._n_requests += n
                self._n_batches += 1
            for req in batch:
                _fail(req, e)
            return None
        return batch, out, bucket, t0, event

    def _complete_batch(self, batch, out, bucket, t0, event):
        """Wait for the in-flight result and fan it out to the futures."""
        n = len(batch)
        try:
            if event is not None:
                event.synchronize()
        except BaseException as e:  # noqa: BLE001 (runtime error of the batch)
            with self._stats_lock:
                self._n_errors += n
                self._n_requests += n
                self._n_batches += 1
            for req in batch:
                _fail(req, e)
            return
        with self._stats_lock:
            self._exec_s.append(time.monotonic() - t0)
            self._n_requests += n
            self._n_batches += 1
            self._n_padded += bucket - n
            self._bucket_counts[bucket] += 1
        # fan out; any split failure must fail the futures, never kill the
        # dispatcher thread (which would hang every later request)
        try:
            # a sharded artifact's outputs are gathered first
            out = pytree.tree_map(
                lambda a: a.full_tensor() if isinstance(a, DTensor) else a, out)
            bad = [
                tuple(getattr(leaf, "shape", ()))
                for leaf in pytree.tree_leaves(out)
                if getattr(leaf, "ndim", 0) < 1 or leaf.shape[0] != bucket
            ]
            if bad:
                raise ValueError(
                    "InferenceServer fn contract violated: every output leaf needs leading "
                    f"batch dim {bucket}, got shapes {bad}"
                )
            results = [pytree.tree_map(lambda a, i=i: a[i: i + 1], out) for i in range(n)]
        except BaseException as e:  # noqa: BLE001
            for req in batch:
                _fail(req, e)
            with self._stats_lock:
                self._n_errors += n
            return
        for req, res in zip(batch, results):
            try:
                req.future.set_result(res)
            except Exception:
                pass  # a client cancel between RUNNING and here: never kill the dispatcher
