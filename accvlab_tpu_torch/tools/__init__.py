"""accvlab_tpu_torch.tools — dev-time profiling and debugging tools (port of
``accvlab_tpu.tools``): :class:`Stopwatch` (iteration profiler),
:class:`ChromeTraceRecorder` (the pipeline's phase timeline),
:class:`TraceRangeWrapper` (profiler and NVTX ranges) and
:class:`TensorDumper` (dump and compare). ``program_cache`` is still to
port (ROADMAP.md)."""

from .chrome_trace import ChromeTraceRecorder
from .singleton_base import SingletonBase
from .stopwatch import Stopwatch
from .tensor_dumper import TensorDumper
from .trace_range import NVTXRangeWrapper, TraceRangeWrapper, range_pop, range_push, register_string

__all__ = [
    "ChromeTraceRecorder",
    "NVTXRangeWrapper",
    "SingletonBase",
    "Stopwatch",
    "TensorDumper",
    "TraceRangeWrapper",
    "range_pop",
    "range_push",
    "register_string",
]
