"""Processing steps (port of ``accvlab_tpu.pipeline.processing_steps``: the
device steps of the headline pipeline; the other steps wait, see ROADMAP.md)."""

from .pipeline_step_base import BatchLevelStepBase, PipelineStepBase
from .affine_transformer import AffineTransformer
from .bounding_box_to_heatmap_converter import BoundingBoxToHeatmapConverter
from .image_normalizers import ImageMeanStdDevNormalizer, ImageRange01Normalizer
from .photo_metric_distorter import PhotoMetricDistorter

__all__ = [
    "AffineTransformer",
    "BatchLevelStepBase",
    "BoundingBoxToHeatmapConverter",
    "ImageMeanStdDevNormalizer",
    "ImageRange01Normalizer",
    "PhotoMetricDistorter",
    "PipelineStepBase",
]
