"""Input sources for the pipeline framework (port of ``accvlab_tpu.pipeline.inputs``;
the samplers and the elastic callable are later work, see ROADMAP.md)."""

from .base import CallableBase, DataProvider, IterableBase, SampleInfo, SamplerBase
from .multicam_jpeg import MultiCameraJpegProvider
from .multicam_synthetic import MultiCameraSyntheticProvider
from .shuffled_sharded_input_callable import ShuffledShardedInputCallable

__all__ = [
    "CallableBase",
    "DataProvider",
    "IterableBase",
    "MultiCameraJpegProvider",
    "MultiCameraSyntheticProvider",
    "SampleInfo",
    "SamplerBase",
    "ShuffledShardedInputCallable",
]
