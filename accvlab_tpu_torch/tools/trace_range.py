"""Profiler trace ranges.

PyTorch port of ``accvlab_tpu/tools/trace_range.py``. A range is a
``torch.profiler.record_function`` range (the counterpart of the JAX
package's ``jax.profiler.TraceAnnotation``: it shows in a
``torch.profiler`` trace) and, on the card, an NVTX range as well
(``torch.cuda.nvtx``, for Nsight). The optional sync-on-push/pop, which
makes a host range bound the device work enqueued inside it, waits for the
card as :mod:`.stopwatch` does.

When disabled (the default), ``range_push``/``range_pop`` are bound to
no-ops: instrumented code pays an attribute lookup.

The port's own phases (the executor's and the training step's
``accvlab.*`` ranges) open through :func:`_profiled`, which needs no
switch: a range exists only while a ``torch.profiler`` records.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

from .._device import DeviceLike, resolve_device
from .singleton_base import SingletonBase
from .stopwatch import _device_sync


class _Range:
    """One open range: the profiler's, and NVTX's on the card."""

    __slots__ = ("_rf", "_nvtx")

    def __init__(self, name: str, nvtx: bool):
        self._rf = torch.profiler.record_function(name)
        self._rf.__enter__()
        self._nvtx = nvtx
        if nvtx:
            torch.cuda.nvtx.range_push(name)

    def close(self) -> None:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(None, None, None)


#: what :func:`_profiled` hands out while no profiler records
_OFF = contextlib.nullcontext()


def _profiled(name: str, **args):
    """A ``torch.profiler`` range named ``name`` while a profiler records
    this thread, else a shared object that does nothing (the check is one
    call). ``args`` are ints or strings, kept in the trace when the
    profiler records shapes (``FunctionEvent.kwinputs``).

    The range is the profiler's fast record function: it dispatches no
    operator, so ``make_fx`` would not record it, and it has no twin on the
    device's timeline; its ``device_time_total`` holds the kernels launched
    inside it, a CUDA graph's through its launch. Keep it outside code that
    a trace or a graph capture runs all the same."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name, (), args)


class TraceRangeWrapper(SingletonBase):
    """Singleton push/pop profiler-range wrapper.

    Usage::

        ranges = TraceRangeWrapper()
        ranges.enable(sync_on_push=False, sync_on_pop=False,
                      keep_track_of_range_order=True)
        ranges.range_push("augment")
        ...
        ranges.range_pop("augment")
    """

    def __init__(self, *args, **kwargs):
        if self._singleton_initialized:
            return
        self._singleton_initialized = True
        self._enabled = False
        self._sync_on_push = False
        self._sync_on_pop = False
        self._track_order = False
        self._nvtx = False
        self._stack: List[tuple] = []
        self._bind_disabled()

    def _bind_disabled(self):
        noop = lambda *a, **k: None  # noqa: E731
        self.range_push = noop
        self.range_pop = noop

    def _bind_enabled(self):
        self.range_push = self._range_push_enabled
        self.range_pop = self._range_pop_enabled

    def enable(
        self,
        sync_on_push: bool = False,
        sync_on_pop: bool = False,
        keep_track_of_range_order: bool = False,
        device: DeviceLike = None,
    ):
        """Enable trace ranges.

        Args:
            sync_on_push: wait for the card before opening a range.
            sync_on_pop: wait for the card before closing a range.
            keep_track_of_range_order: verify pops match pushes (LIFO) and
                that the popped name (if given) matches the top of the stack.
            device: the device whose work the ranges bound (default the
                card, which raises without one; ``"cpu"`` opens profiler
                ranges only, no NVTX).
        """
        dev = resolve_device(device)
        self._enabled = True
        self._sync_on_push = sync_on_push
        self._sync_on_pop = sync_on_pop
        self._track_order = keep_track_of_range_order
        self._nvtx = dev.type == "cuda"
        self._stack = []
        self._bind_enabled()

    def disable(self):
        assert not self._stack, "Cannot disable with open ranges"
        self._enabled = False
        self._bind_disabled()

    @property
    def is_enabled(self) -> bool:
        """Whether the wrapper is enabled."""
        return self._enabled

    def _range_push_enabled(self, range_name: str):
        if self._sync_on_push:
            _device_sync()
        self._stack.append((range_name, _Range(range_name, self._nvtx)))

    def _range_pop_enabled(self, range_name: Optional[str] = None):
        assert self._stack, "range_pop without a matching range_push"
        name, rng = self._stack.pop()
        if self._track_order and range_name is not None:
            assert name == range_name, (
                f"Out-of-order range pop: expected '{name}', got '{range_name}'"
            )
        if self._sync_on_pop:
            _device_sync()
        rng.close()


# The reference's naming.
NVTXRangeWrapper = TraceRangeWrapper


# ---------------------------------------------------------------------- #
# numba_nvtx-style free functions                                        #
# ---------------------------------------------------------------------- #
#
# Handle-based free functions with the reference's contract: register a
# string once, push by integer handle, pop; handle 0 is a safe no-op and
# pushes/pops nest LIFO. They open profiler ranges, and NVTX ranges too
# once the program has initialised CUDA.

_handle_names: dict = {}
_free_stack: List = []


def register_string(name: str) -> int:
    """Register a range name once and return an integer handle (never 0)."""
    for h, n in _handle_names.items():
        if n == name:
            return h
    handle = len(_handle_names) + 1
    _handle_names[handle] = name
    return handle


def range_push(handle: int) -> None:
    """Open a profiler range by handle. Handle 0 (or unknown) is a no-op."""
    name = _handle_names.get(int(handle))
    _free_stack.append(None if name is None
                       else _Range(name, torch.cuda.is_initialized()))


def range_pop() -> None:
    """Close the innermost range opened with :func:`range_push`."""
    if not _free_stack:
        return
    rng = _free_stack.pop()
    if rng is not None:
        rng.close()
