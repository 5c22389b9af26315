"""Process-based sample workers for the pipeline executor (port of
``accvlab_tpu/pipeline/worker_pool.py``).

``get_pipeline(worker_mode="process")``: the input callable and the
per-sample host steps run in spawned worker processes, so host stages held
by the interpreter lock run in parallel. Batch-level host steps (the wire
packers, ``PaddingToUniform``) stay in the producer thread. Thread workers
(the default) are cheaper and enough when the host stage releases the lock
(JPEG decode in C).

The callable and the per-sample steps are pickled once, at pool start: both
must pickle, as DALI's external-source callables must. The pickle goes to
the workers through a file in the temporary directory (``TMPDIR``, named
like the segments below, removed at shutdown), not through the spawn pipe: a worker that unpickles
its start arguments imports the port (and torch) midway, and a payload
larger than the pipe's buffer would hold the parent until that import is
done, so the workers would start one after another (68 s for 8 workers on
an 8-core H100 host with bench.py's 10.6 MB input,
``scripts/torch_worker_startup.py``) instead of together. The
workers import torch but only run numpy host steps: each keeps
``torch.set_num_threads(1)`` and never initialises CUDA.

Sample results avoid the pickle pipe for bulk data: leaves of 64 KiB and
more travel through POSIX shared memory (one segment per sample, written
once by the worker, copied once by the parent, then unlinked). Segment
names carry the pool parent's pid (``avtorch<pid>_...``); a pool sweeps the
segments of dead parents at start.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from multiprocessing import resource_tracker, shared_memory

import numpy as np

_SHM_THRESHOLD = 64 * 1024  # bytes; below this, pickling is cheaper than mmap
_SHM_PREFIX = "avtorch"  # the JAX package's pools use "accvlab"

# worker-process globals (set by the initializer)
_W_INPUT = None
_W_STEPS = None
_W_INPUT_BLUEPRINT = None
_W_CHECK = False
_W_SEED = 0
_W_POOL_PID = 0  # pool-parent pid, captured AT POOL INIT (os.getppid() at
# export time would report pid 1 for a worker orphaned by a crashed parent,
# shielding its segments from the orphan sweep forever)


def _init_worker(payload_path):
    """Load ``(input_callable, host_steps, input_blueprint, check, seed,
    pool_pid)`` from the pool's payload file."""
    global _W_INPUT, _W_STEPS, _W_INPUT_BLUEPRINT, _W_CHECK, _W_SEED, _W_POOL_PID
    import pickle

    import torch

    torch.set_num_threads(1)
    with open(payload_path, "rb") as f:
        (_W_INPUT, _W_STEPS, _W_INPUT_BLUEPRINT, _W_CHECK, _W_SEED,
         _W_POOL_PID) = pickle.load(f)


def _worker_process_sample(args):
    """Load one sample and run the per-sample host steps; returns the flat
    numpy leaf list (or the string 'EPOCH_END')."""
    from .inputs.base import SampleInfo
    from .random_context import HostRandomContext

    idx_in_batch, iteration, epoch, batch_size = args
    info = SampleInfo(
        idx_in_epoch=iteration * batch_size + idx_in_batch,
        idx_in_batch=idx_in_batch,
        iteration=iteration,
        epoch_idx=epoch,
    )
    # never let an exception escape to pool.map: a raising task makes map()
    # DISCARD the other samples' results — and with shm transport those
    # results own /dev/shm segments only the parent can unlink. Errors ride
    # back as values so the parent imports (and frees) every result first.
    try:
        try:
            flat = _W_INPUT(info)
        except StopIteration:
            return "EPOCH_END"
        sdg = _W_INPUT_BLUEPRINT.get_empty_like_self()
        sdg.set_data(list(flat))
        if _W_STEPS:
            rng = HostRandomContext(
                np.random.default_rng((_W_SEED, epoch, iteration, idx_in_batch))
            )
            for step in _W_STEPS:
                if step.is_batch_level:
                    continue
                step.set_random_context(rng)
                sdg = step(sdg) if _W_CHECK else step._process(sdg)
        return _export_flat([np.asarray(v) for v in sdg.get_data()])
    except BaseException as e:  # noqa: BLE001
        import traceback

        return ("error", f"{type(e).__name__}: {e}\n{traceback.format_exc()}")


def _export_flat(flat):
    """Pack large leaves into one shared-memory segment; return a transport
    descriptor list (small leaves ride the pickle pipe as-is).

    Segment names are tagged with the POOL PARENT's pid
    (``avtorch<ppid>_...``): the parent sweeps dead-parent orphans at pool
    start (see :func:`_sweep_orphan_segments`), so segments leaked by a
    hard-crashed worker/parent are reclaimed by the next run rather than
    accumulating in /dev/shm forever."""
    import uuid

    big = [
        (i, a) for i, a in enumerate(flat)
        if a.nbytes >= _SHM_THRESHOLD and a.dtype != object
    ]
    if not big:
        return ("pickle", flat)
    total = sum(int(np.ascontiguousarray(a).nbytes) for _, a in big)
    name = f"{_SHM_PREFIX}{_W_POOL_PID}_{uuid.uuid4().hex[:12]}"
    shm = shared_memory.SharedMemory(create=True, size=total, name=name)
    try:
        descriptors = list(flat)
        off = 0
        for i, a in big:
            a = np.ascontiguousarray(a)
            shm.buf[off : off + a.nbytes] = memoryview(a).cast("B")
            descriptors[i] = ("__shm__", off, a.shape, a.dtype.str)
            off += a.nbytes
    except BaseException:
        shm.close()
        shm.unlink()  # never orphan a half-written segment
        try:  # and drop it from this worker's tracker (already gone)
            resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
        except Exception:
            pass
        raise
    shm.close()
    # the parent owns the segment's lifetime (it unlinks after copying);
    # unregister so this worker's resource tracker doesn't also unlink it
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
    except Exception:
        pass
    return ("shm", shm.name, descriptors)


def _sweep_orphan_segments(directory="/dev/shm"):
    """Unlink the files in ``directory`` (the /dev/shm segments, or the
    payload files in the temporary directory) tagged with a pool-parent pid
    that is no longer alive (crashed parent / hard-killed worker left them
    behind)."""
    try:
        entries = os.listdir(directory)
    except OSError:
        return
    for entry in entries:
        if not entry.startswith(_SHM_PREFIX):
            continue
        pid_part = entry[len(_SHM_PREFIX):].split("_", 1)[0]
        if not pid_part.isdigit():
            continue
        pid = int(pid_part)
        if pid == os.getpid():
            continue  # may be in flight in this very process
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            try:
                os.unlink(os.path.join(directory, entry))
            except OSError:
                pass
        except PermissionError:
            pass  # alive under another uid — not ours to touch


def _import_result(result):
    """Parent-side inverse of ``_export_flat``."""
    if isinstance(result, str):
        return result
    kind = result[0]
    if kind == "error":
        return result  # handled (raised) by produce_batch AFTER all imports
    if kind == "pickle":
        return result[1]
    _, shm_name, descriptors = result
    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        flat = []
        for d in descriptors:
            if isinstance(d, tuple) and len(d) == 4 and d[0] == "__shm__":
                _, off, shape, dtype = d
                view = np.ndarray(shape, np.dtype(dtype), buffer=shm.buf, offset=off)
                flat.append(view.copy())  # one memcpy; segment freed below
            else:
                flat.append(d)
        return flat
    finally:
        shm.close()
        shm.unlink()


class ProcessSampleWorkers:
    """Spawned worker pool running input-callable + host steps per sample.

    ``host_steps`` are the per-sample host steps (batch-level steps are
    skipped in the workers)."""

    def __init__(self, num_workers, input_callable, host_steps, input_blueprint, check, seed):
        import pickle
        import tempfile

        _sweep_orphan_segments()  # reclaim dead-parent /dev/shm leftovers
        _sweep_orphan_segments(tempfile.gettempdir())  # and payload files
        payload = pickle.dumps((input_callable, [s for s in host_steps if not s.is_batch_level],
                                input_blueprint, check, seed, os.getpid()))
        fd, self._payload_path = tempfile.mkstemp(prefix=f"{_SHM_PREFIX}{os.getpid()}_init_")
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        ctx = mp.get_context("spawn")
        try:
            self._pool = ctx.Pool(processes=num_workers, initializer=_init_worker,
                                  initargs=(self._payload_path,))
        except BaseException:
            self._remove_payload()
            raise
        # liveness baseline for the produce_batch watchdog (reading the
        # private worker list is the only visibility mp.Pool offers; the
        # attribute has been stable across CPython 3.x)
        self._worker_pids = {w.pid for w in self._pool._pool}
        self._broken = False

    def _check_workers_alive(self):
        """Detect a hard-killed worker (OOM killer, SIGKILL). mp.Pool
        silently REPLACES a dead worker but the task it was running is
        lost, so a bare ``map`` blocks forever — the watchdog turns that
        into a loud error. Both signals are needed: ``exitcode`` catches a
        death the pool has not reaped yet; a changed pid set catches one
        it already replaced."""
        workers = list(self._pool._pool)
        dead = [w for w in workers if w.exitcode not in (None, 0)]
        now_pids = {w.pid for w in workers}
        if dead or now_pids != self._worker_pids:
            self._broken = True
            detail = (
                f"exitcode {dead[0].exitcode} (pid {dead[0].pid})"
                if dead
                else f"worker set changed {sorted(self._worker_pids)} -> "
                     f"{sorted(now_pids)}"
            )
            raise RuntimeError(
                "a pipeline worker process died mid-batch — "
                f"{detail}. The in-flight sample is lost (commonly the OOM "
                "killer: reduce num_threads/batch memory or use "
                "worker_mode='thread'); the pool is marked broken."
            )

    def produce_batch(self, batch_size: int, iteration: int, epoch: int):
        """Returns a list of flat-leaf lists, or raises StopIteration."""
        if self._broken:
            raise RuntimeError(
                "pipeline worker pool is broken (a worker died earlier); "
                "re-create the pipeline"
            )
        # check BEFORE dispatch too: a worker killed while idle is silently
        # replaced by the pool and fast batches can complete inside the
        # first wait() below without ever consulting the watchdog — the
        # death would go unreported (and an idle-killed worker leaves the
        # inqueue lock orphaned, so the pool MUST be declared broken for
        # shutdown() to take the force path)
        self._check_workers_alive()
        args = [(i, iteration, epoch, batch_size) for i in range(batch_size)]
        async_res = self._pool.map_async(_worker_process_sample, args)
        while True:
            async_res.wait(0.5)
            if async_res.ready():
                break
            self._check_workers_alive()
        results = [_import_result(r) for r in async_res.get()]
        # every successful sample's shm is now attached+freed; only then
        # surface worker errors
        for r in results:
            if isinstance(r, tuple) and len(r) == 2 and r[0] == "error":
                raise RuntimeError(f"pipeline worker failed:\n{r[1]}")
        if any(isinstance(r, str) and r == "EPOCH_END" for r in results):
            raise StopIteration
        return results

    def _remove_payload(self):
        try:
            os.unlink(self._payload_path)
        except FileNotFoundError:
            pass

    def shutdown(self):
        """Stop the pool and remove its payload file — safe even after a
        hard-killed worker.

        ``Pool.terminate()`` is NOT safe then: a worker blocked in
        ``inqueue.get()`` holds the queue's reader lock while it waits, so
        SIGKILLing it orphans the lock (POSIX semaphore — nothing releases
        it), and ``_terminate_pool -> _help_stuff_finish`` deadlocks on
        ``inqueue._rlock.acquire()`` (observed as a forever-hang of
        ``pipe.stop()`` in CI). When the pool is broken we bypass the
        graceful path entirely; when it looks healthy we still bound the
        graceful path with a timeout and fall back, because a worker death
        the watchdog never observed leaves the same orphaned lock."""
        import threading

        self._remove_payload()  # the workers have loaded it, or will never run
        if not self._broken:
            done = threading.Event()

            def _graceful():
                try:
                    self._pool.terminate()
                    self._pool.join()
                except Exception:
                    pass
                finally:
                    done.set()

            t = threading.Thread(
                target=_graceful, name="accvlab-pool-shutdown", daemon=True
            )
            t.start()
            if done.wait(10.0):
                return
            self._broken = True  # abandoned; fall through to force-kill
        self._force_shutdown()

    def _force_shutdown(self):
        """Kill-path teardown that never touches the (possibly orphaned)
        inqueue lock: stop the respawn loop, SIGKILL the workers, and cancel
        the pool's atexit finalizer so interpreter exit cannot re-enter the
        deadlocking ``_terminate_pool``. Helper threads are daemons; the
        queues' fds are reclaimed with the process."""
        from multiprocessing import pool as mp_pool

        p = self._pool
        try:
            p._state = mp_pool.TERMINATE  # noqa: SLF001
            p._worker_handler._state = mp_pool.TERMINATE  # noqa: SLF001
            p._change_notifier.put(None)  # noqa: SLF001 — wake the handler
        except Exception:
            pass
        try:
            p._worker_handler.join(5.0)  # noqa: SLF001 — stop respawns
        except Exception:
            pass
        for w in list(getattr(p, "_pool", [])):
            try:
                w.kill()
            except Exception:
                pass
        for w in list(getattr(p, "_pool", [])):
            try:
                w.join(5.0)
            except Exception:
                pass
        try:
            p._terminate.cancel()  # noqa: SLF001 — disarm the atexit path
        except Exception:
            pass
