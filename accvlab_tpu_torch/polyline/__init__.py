"""accvlab_tpu_torch.polyline — polyline arc-length ops (port of
``accvlab_tpu.polyline``): plain torch ops on the inputs' device, no kernel."""

from .functions import (
    interpolate,
    interpolate_var_size_batch,
    lengths,
    lengths_var_size_batch,
)

__all__ = [
    "interpolate",
    "interpolate_var_size_batch",
    "lengths",
    "lengths_var_size_batch",
]
