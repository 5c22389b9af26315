"""Chrome-trace (Perfetto) timeline of the pipeline's host-side phases
(port of ``accvlab_tpu/tools/chrome_trace.py``).

:class:`ChromeTraceRecorder` is a bounded, thread-safe event buffer that
``TorchPipeline.start_trace``/``stop_trace`` write the executor's phase
spans into, exported as Chrome trace-event JSON (open the file in
``chrome://tracing`` or https://ui.perfetto.dev). It shows the producer
thread, the prefetch queue and the consumer's transfer and device enqueue
beside each other on one clock; device-internal timing belongs to
``torch.profiler``.

Event model (Trace Event Format, "X"/"i"/"M" phases):

* complete spans — ``host_build`` (producer: input + host steps for one
  batch), ``queue_put`` (producer blocked on a full prefetch queue),
  ``consumer_wait`` (``__next__`` waiting for a host batch: input-bound
  time), ``device_dispatch`` (the transfer and the device steps' enqueue,
  per echo replay).
* instant events — ``epoch_end``, ``reset``.
* metadata — process and thread names.

Overhead when recording: one lock and one dict append per phase (four
events per batch); none when not recording (the pipeline reads one
attribute).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional


class ChromeTraceRecorder:
    """Bounded, thread-safe trace-event buffer.

    Args:
        max_events: hard cap on buffered events; once reached, new events
            are counted in :attr:`dropped` instead of stored (a trace that
            silently eats memory on a week-long run would be worse than a
            truncated one). Four events per pipeline batch: the default
            holds ~25k batches.
    """

    def __init__(self, max_events: int = 100_000):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self._lock = threading.Lock()
        self._events: list = []
        self._max = int(max_events)
        self._tids: dict = {}
        #: events discarded after the buffer filled (monitoring)
        self.dropped = 0
        #: monotonic origin; event timestamps are relative to this
        self.t0 = time.monotonic()

    # ------------------------------------------------------------------ #

    def _append(self, ev: dict, thread: str) -> None:
        with self._lock:
            # tid assignment must share the event lock: two threads
            # registering concurrently would otherwise both read len() and
            # merge onto one timeline row
            tid = self._tids.get(thread)
            if tid is None:
                tid = self._tids[thread] = len(self._tids) + 1
            ev["tid"] = tid
            if len(self._events) >= self._max:
                self.dropped += 1
                return
            self._events.append(ev)

    def complete(
        self, name: str, thread: str, ts_s: float, dur_s: float, **args
    ) -> None:
        """Record a complete span ("X"): began at monotonic ``ts_s``,
        lasted ``dur_s`` seconds, on the named logical thread. A span that
        began before this recorder existed (e.g. a producer batch in flight
        across ``start_trace``) is clipped to the recorder's origin."""
        rel_s = ts_s - self.t0
        if rel_s < 0.0:
            dur_s += rel_s
            rel_s = 0.0
        self._append(
            {
                "name": name,
                "ph": "X",
                "pid": 1,
                "ts": rel_s * 1e6,
                "dur": max(0.0, dur_s) * 1e6,
                "args": args,
            },
            thread,
        )

    def instant(self, name: str, thread: str, **args) -> None:
        """Record an instant event ("i") at the current time."""
        self._append(
            {
                "name": name,
                "ph": "i",
                "s": "t",
                "pid": 1,
                "ts": (time.monotonic() - self.t0) * 1e6,
                "args": args,
            },
            thread,
        )

    # ------------------------------------------------------------------ #

    def to_dict(self) -> dict:
        """The Trace Event Format object (``{"traceEvents": [...]}``)."""
        with self._lock:
            events = list(self._events)
            tids = dict(self._tids)
            dropped = self.dropped
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": 1,
                "args": {"name": "accvlab_tpu_torch pipeline"},
            }
        ]
        for thread, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 1,
                    "tid": tid,
                    "args": {"name": thread},
                }
            )
        out = {"traceEvents": meta + events}
        if dropped:
            out["accvlab_dropped_events"] = dropped
        return out

    def save(self, path: str) -> None:
        """Write the trace as JSON; open in chrome://tracing or Perfetto."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)
