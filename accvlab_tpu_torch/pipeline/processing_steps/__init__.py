"""Processing steps (port of ``accvlab_tpu.pipeline.processing_steps``, every
step of it)."""

from .pipeline_step_base import BatchLevelStepBase, PipelineStepBase
from .affine_transformer import AffineTransformer
from .annotation_element_condition_eval import AnnotationElementConditionEval
from .applied_steps import (
    DataGroupArrayInPathElementsAppliedStep,
    DataGroupArrayWithNameElementsAppliedStep,
    DataGroupInPathAppliedStep,
    DataGroupsWithNameAppliedStep,
    GroupToApplyToSelectedStepBase,
)
from .bev_bboxes_transformer_3d import BEVBBoxesTransformer3D
from .bounding_box_to_heatmap_converter import BoundingBoxToHeatmapConverter
from .color_converter import YCbCrToRGBConverter
from .dct_wire import (
    DCTWirePacker,
    DCTWireUnpacker,
    compress_jpeg_dct,
    decompress_jpeg_dct,
    optimize_band_groups,
)
from .field_utils import AxesLayoutSetter, TensorSizeAdder, UnneededFieldRemover
from .image_decoder import ImageDecoder
from .image_normalizers import ImageMeanStdDevNormalizer, ImageRange01Normalizer
from .padders import ImageToTileSizePadder, PaddingToUniform, optimize_size_buckets
from .photo_metric_distorter import PhotoMetricDistorter
from .selection_steps import (
    ConditionalElementRemover,
    CoordinateCropper,
    PointsInRangeCheck,
    VisibleBboxSelector,
)
from .wire_compression import (
    WirePlanePacker,
    WirePlaneUnpacker,
    compress_plane,
    decompress_plane,
)

__all__ = [
    "AffineTransformer",
    "AnnotationElementConditionEval",
    "AxesLayoutSetter",
    "BEVBBoxesTransformer3D",
    "BatchLevelStepBase",
    "BoundingBoxToHeatmapConverter",
    "ConditionalElementRemover",
    "CoordinateCropper",
    "DCTWirePacker",
    "DCTWireUnpacker",
    "DataGroupArrayInPathElementsAppliedStep",
    "DataGroupArrayWithNameElementsAppliedStep",
    "DataGroupInPathAppliedStep",
    "DataGroupsWithNameAppliedStep",
    "GroupToApplyToSelectedStepBase",
    "ImageDecoder",
    "ImageMeanStdDevNormalizer",
    "ImageRange01Normalizer",
    "ImageToTileSizePadder",
    "PaddingToUniform",
    "PhotoMetricDistorter",
    "PipelineStepBase",
    "PointsInRangeCheck",
    "TensorSizeAdder",
    "UnneededFieldRemover",
    "VisibleBboxSelector",
    "WirePlanePacker",
    "WirePlaneUnpacker",
    "YCbCrToRGBConverter",
    "compress_jpeg_dct",
    "compress_plane",
    "decompress_jpeg_dct",
    "decompress_plane",
    "optimize_band_groups",
    "optimize_size_buckets",
]
