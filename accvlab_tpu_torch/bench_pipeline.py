"""The headline multi-camera pipeline of ``bench.py``, built on the port.

``bench.py:130-269`` with raw frames in place of the JPEG/DCT wire (the DCT
wire modules wait for libjpeg on the card machine, ROADMAP.md): 6 cameras of
372x1024 RGB, 32 boxes of 10 classes each, batches of 8 read through
``ShuffledShardedInputCallable``; one packed transfer per batch; then on the
device ``AffineTransformer`` -> ``PhotoMetricDistorter`` ->
``BoundingBoxToHeatmapConverter`` (the CUDA rasterizer) ->
``ImageMeanStdDevNormalizer``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from .pipeline import PipelineDefinition
from .pipeline.inputs import MultiCameraSyntheticProvider, ShuffledShardedInputCallable
from .pipeline.processing_steps import (
    AffineTransformer,
    BoundingBoxToHeatmapConverter,
    ImageMeanStdDevNormalizer,
    PhotoMetricDistorter,
)

def headline_steps(out_hw=(256, 704), heatmap_hw=(64, 176), num_classes: int = 10,
                   affine_prob: float = 0.5, photometric_prob: float = 0.5,
                   heatmap_implementation: str = "auto"):
    """The device steps of bench.py's pipeline, in order."""
    p = photometric_prob
    return [
        AffineTransformer(
            output_hw=out_hw,
            resizing_mode=AffineTransformer.ResizingMode.STRETCH,
            image_field_names="image",
            transformation_steps=[
                AffineTransformer.UniformScaling(affine_prob, 0.9, 1.1),
                AffineTransformer.Translation(affine_prob, [-16.0, -16.0], [16.0, 16.0]),
            ],
        ),
        PhotoMetricDistorter(
            "image",
            min_max_brightness=[-16.0, 16.0],
            min_max_hue=[-10.0, 10.0],
            min_max_contrast=[0.8, 1.2],
            min_max_saturation=[0.8, 1.2],
            prob_brightness_aug=p, prob_hue_aug=p, prob_contrast_aug=p,
            prob_saturation_aug=p, prob_swap_channels=p,
        ),
        BoundingBoxToHeatmapConverter(
            annotation_field_name="annotations",
            bboxes_in_name="bboxes",
            heatmap_out_name="heatmap",
            heatmap_hw=heatmap_hw,
            image_hw_field_name="image_hw",
            categories_in_name="categories",
            num_categories=num_classes,
            is_active_opt_out_name="active",
            center_opt_out_name="center",
            center_offset_opt_out_name="offset",
            implementation=heatmap_implementation,
        ),
        ImageMeanStdDevNormalizer("image", mean=[103.5, 116.3, 123.7], std_dev=[57.4, 57.1, 58.4]),
    ]


def build_pipeline(batch_size: int = 8, device=None, num_threads: Optional[int] = None,
                   hw: Tuple[int, int] = (372, 1024), num_cams: int = 6,
                   out_hw=(256, 704), heatmap_hw=(64, 176), num_samples: int = 6400,
                   num_unique: int = 2, affine_prob: float = 0.5,
                   photometric_prob: float = 0.5, heatmap_implementation: str = "auto",
                   seed: int = 0):
    """bench.py's pipeline on the port (``device`` defaults to the card)."""
    if num_threads is None:
        num_threads = max(2, os.cpu_count() or 4)
    provider = MultiCameraSyntheticProvider(num_samples=num_samples, num_unique=num_unique,
                                            hw=hw, num_cams=num_cams)
    inp = ShuffledShardedInputCallable(provider, batch_size=batch_size, shuffle=True)
    steps = headline_steps(out_hw, heatmap_hw, affine_prob=affine_prob,
                           photometric_prob=photometric_prob,
                           heatmap_implementation=heatmap_implementation)
    definition = PipelineDefinition(inp, steps, check_data_format=False,
                                    copy_external_source_passthrough_outputs=False)
    return definition.get_pipeline(batch_size=batch_size, num_threads=num_threads,
                                   device=device, seed=seed)
