"""The 95th percentile of the time between the ends of consecutive steps:
the CUDA events recorded right after each step, over the traced run's steps
after its profiled stretches. A late batch or a stalled host shows here
before it moves the mean."""

import numpy as np


def read(ctx):
    times = ctx["step_interval_ms"]
    return float(np.percentile(np.asarray(times, np.float64), 95)) if times else None
