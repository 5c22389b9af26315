"""accvlab_tpu_torch.pipeline — structured data-loading & preprocessing framework.

PyTorch port of ``accvlab_tpu.pipeline``: a :class:`PipelineDefinition`
composes an input source with an ordered list of processing steps into an
executable input pipeline. Host steps run per sample on worker threads
(numpy); the batch crosses to the card in one packed pinned copy; device
steps run eagerly on batched tensors; a prefetch ring overlaps host work
with the device. Construction-time blueprint checking is kept as in the JAX
package.
"""

from .dtypes import DType, dtype_for_numpy, numpy_dtype_for, torch_dtype_for
from .sample_data_group import SampleDataGroup
from .pipeline import PipelineDefinition, TorchPipeline
from .random_context import (
    DeviceRandomContext,
    HostRandomContext,
    RandomContext,
    ReplayRandomContext,
    ScriptedRandomContext,
)
from .structured_output_iterator import (
    DALIStructuredOutputIterator,
    StructuredOutputIterator,
)

__all__ = [
    "DALIStructuredOutputIterator",
    "DType",
    "DeviceRandomContext",
    "HostRandomContext",
    "PipelineDefinition",
    "RandomContext",
    "ReplayRandomContext",
    "SampleDataGroup",
    "ScriptedRandomContext",
    "StructuredOutputIterator",
    "TorchPipeline",
    "dtype_for_numpy",
    "numpy_dtype_for",
    "torch_dtype_for",
]
