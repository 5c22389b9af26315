"""accvlab_tpu_torch.tools — dev-time profiling and debugging tools (port of
``accvlab_tpu.tools``): :class:`Stopwatch` (iteration profiler),
:class:`ChromeTraceRecorder` (the pipeline's phase timeline),
:class:`TraceRangeWrapper` (profiler and NVTX ranges),
:class:`TensorDumper` (dump and compare) and :func:`shared_jit`
(structurally identical programs share one traced executable and, on the
card, its CUDA graphs: :mod:`.program_cache`)."""

from .chrome_trace import ChromeTraceRecorder
from .program_cache import clear_program_cache, program_cache_stats, shared_jit
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
    "clear_program_cache",
    "program_cache_stats",
    "shared_jit",
    "range_pop",
    "range_push",
    "register_string",
]
