"""Iteration profiler (port of ``accvlab_tpu/tools/stopwatch.py``).

Same surface: a singleton with named (nestable) accumulators, warm-up
iterations skipped, optional device synchronisation around measurements,
periodic printing, one-time measurements and an optional CPU-usage
accumulator (through ``psutil`` where it is importable; without it the
CPU usage is left out, and the printed stats say so).

``do_device_sync=True`` synchronises the current CUDA device around each
measurement, so host timestamps bound the device work enqueued before them;
it does nothing when CUDA is not initialised (the caller runs on the CPU,
where work is synchronous).

When disabled (the default), every measurement method is a no-op, so
instrumented code pays only an attribute lookup.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from .singleton_base import SingletonBase

try:
    import psutil

    _PSUTIL = True
except ImportError:  # pragma: no cover
    _PSUTIL = False


def _device_sync():
    """Wait for the current CUDA device; a no-op when the caller has not
    initialised CUDA (it runs on the CPU)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Stopwatch(SingletonBase):
    """Singleton runtime profiler with warmup skipping and nested named timers.

    Usage::

        sw = Stopwatch()
        sw.enable(num_warmup_iters=3, print_every_n_iters=50, do_device_sync=True)
        for batch in loader:
            sw.start_meas("step")
            ...
            sw.end_meas("step")
            sw.finish_iter()
    """

    class _TimeAccumulator:
        __slots__ = ("accum", "num", "_start", "running")

        def __init__(self):
            self.accum = 0.0
            self.num = 0
            self._start = None
            self.running = False

        def start(self, now):
            self._start = now
            self.running = True

        def end(self, now):
            self.accum += now - self._start
            self.num += 1
            self.running = False

        def get_accum_time(self):
            return self.accum

        def get_num_meas(self):
            return self.num

        def is_running(self):
            return self.running

    class _TimeAndCPUUsageAccumulator(_TimeAccumulator):
        __slots__ = ("cpu_accum", "_cpu_start")

        def __init__(self):
            super().__init__()
            self.cpu_accum = 0.0
            self._cpu_start = None

        def start(self, now):
            super().start(now)
            if _PSUTIL:
                psutil.cpu_percent(interval=None)  # reset the sampling window

        def end(self, now):
            if _PSUTIL:
                self.cpu_accum += psutil.cpu_percent(interval=None)
            super().end(now)

        def get_mean_cpu_usage(self):
            return self.cpu_accum / self.num if self.num else 0.0

    def __init__(self, *args, **kwargs):
        if self._singleton_initialized:
            return
        self._singleton_initialized = True
        self._enabled = False
        self._num_warmup_iters = 0
        self._print_every_n_iters: Optional[int] = None
        self._do_device_sync = False
        self._iter_count = 0
        self._accumulators = {}
        self._one_time = {}
        self._cpu_usage_name: Optional[str] = None
        self._bind_disabled()

    # -- enable / disable ------------------------------------------------ #

    def _bind_disabled(self):
        noop = lambda *a, **k: None
        self.start_meas = noop
        self.end_meas = noop
        self.start_one_time_measurement = noop
        self.end_one_time_measurement = noop
        self.finish_iter = noop
        self.print_eval_times = noop
        self.set_cpu_usage_meas_name = noop

    def _bind_enabled(self):
        self.start_meas = self._start_meas_enabled
        self.end_meas = self._end_meas_enabled
        self.start_one_time_measurement = self._start_one_time_enabled
        self.end_one_time_measurement = self._end_one_time_enabled
        self.finish_iter = self._finish_iter_enabled
        self.print_eval_times = self._print_eval_times_enabled
        self.set_cpu_usage_meas_name = self._set_cpu_usage_meas_name_enabled

    def enable(
        self,
        num_warmup_iters: int,
        print_every_n_iters: Optional[int] = None,
        do_device_sync: bool = False,
        do_cuda_sync: Optional[bool] = None,
    ):
        """Enable measurements.

        Args:
            num_warmup_iters: iterations to skip before accumulating.
            print_every_n_iters: print stats every N non-warmup iterations
                (``None`` disables periodic printing).
            do_device_sync: synchronise the current CUDA device around
                measurements so host timestamps bound device work
                (reference ``do_cuda_sync``).
            do_cuda_sync: accepted alias for ``do_device_sync`` (API parity).
        """
        self._enabled = True
        self._num_warmup_iters = num_warmup_iters
        self._print_every_n_iters = print_every_n_iters
        self._do_device_sync = do_device_sync if do_cuda_sync is None else do_cuda_sync
        self._iter_count = 0
        self._accumulators = {}
        self._one_time = {}
        self._bind_enabled()

    def disable(self):
        self._enabled = False
        self._bind_disabled()

    @property
    def is_enabled(self) -> bool:
        """Whether the stopwatch is enabled (a property, parity: ``stopwatch.py:191``)."""
        return self._enabled

    def get_num_nonwarmup_iters_measured(self) -> int:
        return max(0, self._iter_count - self._num_warmup_iters)

    @property
    def _in_warmup(self) -> bool:
        return self._iter_count < self._num_warmup_iters

    # -- enabled implementations ---------------------------------------- #

    def _get_accumulator(self, name):
        acc = self._accumulators.get(name)
        if acc is None:
            if name == self._cpu_usage_name:
                acc = self._TimeAndCPUUsageAccumulator()
            else:
                acc = self._TimeAccumulator()
            self._accumulators[name] = acc
        return acc

    def _set_cpu_usage_meas_name_enabled(self, name: str):
        assert name not in self._accumulators, (
            "CPU usage measurement name must be set before the first measurement with that name"
        )
        self._cpu_usage_name = name

    def _start_meas_enabled(self, name: str):
        if self._in_warmup:
            return
        if self._do_device_sync:
            _device_sync()
        self._get_accumulator(name).start(time.perf_counter())

    def _end_meas_enabled(self, name: str):
        if self._in_warmup:
            return
        acc = self._accumulators.get(name)
        assert acc is not None and acc.is_running(), (
            f"end_meas('{name}') without a matching start_meas"
        )
        if self._do_device_sync:
            _device_sync()
        acc.end(time.perf_counter())

    def _start_one_time_enabled(self, name: str):
        if self._do_device_sync:
            _device_sync()
        acc = self._TimeAccumulator()
        self._one_time[name] = acc
        acc.start(time.perf_counter())

    def _end_one_time_enabled(self, name: str):
        acc = self._one_time.get(name)
        assert acc is not None, f"end_one_time_measurement('{name}') without a start"
        if self._do_device_sync:
            _device_sync()
        acc.end(time.perf_counter())
        print(f"[Stopwatch] one-time '{name}': {acc.get_accum_time() * 1e3:.3f} ms")

    def _finish_iter_enabled(self):
        self._iter_count += 1
        n = self.get_num_nonwarmup_iters_measured()
        if self._print_every_n_iters and n > 0 and n % self._print_every_n_iters == 0:
            self._print_eval_times_enabled()

    def _print_eval_times_enabled(self):
        n = self.get_num_nonwarmup_iters_measured()
        lines = [f"[Stopwatch] stats after {n} measured iterations:"]
        for name, acc in self._accumulators.items():
            if acc.get_num_meas() == 0:
                continue
            total = acc.get_accum_time()
            mean = total / acc.get_num_meas()
            per_iter = total / n if n else float("nan")
            line = (
                f"  {name}: total {total:.4f} s | mean/call {mean * 1e3:.3f} ms "
                f"({acc.get_num_meas()} calls) | mean/iter {per_iter * 1e3:.3f} ms"
            )
            if isinstance(acc, self._TimeAndCPUUsageAccumulator):
                line += (f" | mean CPU {acc.get_mean_cpu_usage():.1f}%" if _PSUTIL
                         else " | CPU usage not measured (psutil is not importable)")
            lines.append(line)
        print("\n".join(lines))

    # -- stats access (always available) --------------------------------- #

    def get_mean_time(self, name: str) -> float:
        acc = self._accumulators.get(name)
        if acc is None or acc.get_num_meas() == 0:
            return float("nan")
        return acc.get_accum_time() / acc.get_num_meas()

    def get_total_time(self, name: str) -> float:
        acc = self._accumulators.get(name)
        return acc.get_accum_time() if acc is not None else float("nan")
