"""accvlab_tpu_torch.tools — dev-time profiling tools (port of
``accvlab_tpu.tools``): :class:`Stopwatch` (iteration profiler) and
:class:`ChromeTraceRecorder` (the pipeline's phase timeline). The other
tools are still to port (ROADMAP.md)."""

from .chrome_trace import ChromeTraceRecorder
from .singleton_base import SingletonBase
from .stopwatch import Stopwatch

__all__ = ["ChromeTraceRecorder", "SingletonBase", "Stopwatch"]
