"""Input sources for the pipeline framework (port of ``accvlab_tpu.pipeline.inputs``)."""

from .base import CallableBase, DataProvider, IterableBase, SampleInfo, SamplerBase
from .elastic_sharded_input_callable import ElasticShardedInputCallable, elastic_reshard
from .multicam_jpeg import MultiCameraJpegProvider
from .multicam_synthetic import MultiCameraSyntheticProvider
from .sampler_input_callable import SamplerInputCallable
from .sampler_input_iterable import SamplerInputIterable
from .sequence_sampler import SequenceSampler
from .shuffled_sharded_input_callable import ShuffledShardedInputCallable

__all__ = [
    "CallableBase",
    "DataProvider",
    "ElasticShardedInputCallable",
    "IterableBase",
    "MultiCameraJpegProvider",
    "MultiCameraSyntheticProvider",
    "SampleInfo",
    "SamplerBase",
    "SamplerInputCallable",
    "SamplerInputIterable",
    "SequenceSampler",
    "ShuffledShardedInputCallable",
    "elastic_reshard",
]
