"""Processing steps (port of ``accvlab_tpu.pipeline.processing_steps``: the
steps of the headline pipeline, its DCT wire and its YUV 4:2:0 wire; the
other steps wait, see ROADMAP.md)."""

from .pipeline_step_base import BatchLevelStepBase, PipelineStepBase
from .affine_transformer import AffineTransformer
from .bounding_box_to_heatmap_converter import BoundingBoxToHeatmapConverter
from .color_converter import YCbCrToRGBConverter
from .dct_wire import (
    DCTWirePacker,
    DCTWireUnpacker,
    compress_jpeg_dct,
    decompress_jpeg_dct,
    optimize_band_groups,
)
from .image_decoder import ImageDecoder
from .image_normalizers import ImageMeanStdDevNormalizer, ImageRange01Normalizer
from .photo_metric_distorter import PhotoMetricDistorter
from .wire_compression import (
    WirePlanePacker,
    WirePlaneUnpacker,
    compress_plane,
    decompress_plane,
)

__all__ = [
    "AffineTransformer",
    "BatchLevelStepBase",
    "BoundingBoxToHeatmapConverter",
    "DCTWirePacker",
    "DCTWireUnpacker",
    "ImageDecoder",
    "ImageMeanStdDevNormalizer",
    "ImageRange01Normalizer",
    "PhotoMetricDistorter",
    "PipelineStepBase",
    "WirePlanePacker",
    "WirePlaneUnpacker",
    "YCbCrToRGBConverter",
    "compress_jpeg_dct",
    "compress_plane",
    "decompress_jpeg_dct",
    "decompress_plane",
    "optimize_band_groups",
]
