"""End-to-end 2-D detection input pipeline on the port.

The counterpart of ``examples/object_detection_2d_pipeline.py``: multi-camera
JPEG input, augmentation, CenterNet heatmap targets, DataLoader-style
iteration through :class:`StructuredOutputIterator`, timed with the
:class:`Stopwatch` and optionally traced (``pipe.start_trace``). The same
provider, the same step list and the same two wires:

* ``wire="dct"`` (the default): ``DCTWirePacker`` on the host,
  ``DCTWireUnpacker`` on the card, in a band grouping chosen by
  ``optimize_band_groups(max_groups=16)`` over three of the provider's
  JPEGs. Without the native libjpeg decoder it raises (the JAX example falls
  back to the YUV wire quietly);
* ``wire="yuv"``: ``ImageDecoder(wire_format="yuv420", decoder="auto")`` and
  the plane codec (``WirePlanePacker``/``WirePlaneUnpacker``).

Then, on the card: ``YCbCrToRGBConverter`` -> ``TensorSizeAdder`` ->
``AffineTransformer`` -> ``PhotoMetricDistorter`` ->
``BoundingBoxToHeatmapConverter`` -> ``ImageMeanStdDevNormalizer``.

:class:`BenchNuScenesProvider` puts bench.py's data (6 cameras of 372x1024
q90 JPEG, 32 boxes of 10 classes per camera) into the example's sample
structure, for the example at full width.

Run on the card, or on the CPU:
    python -m accvlab_tpu_torch.object_detection_2d_pipeline [--device cpu]
    (set ACCVLAB_EXAMPLE_TRACE=<path> to save the phase timeline)
"""

from __future__ import annotations

import argparse
import io
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .pipeline import (
    DType,
    PipelineDefinition,
    SampleDataGroup,
    StructuredOutputIterator,
    native_jpeg,
)
from .pipeline.inputs import DataProvider, ShuffledShardedInputCallable
from .pipeline.inputs.multicam_jpeg import bench_jpegs
from .pipeline.inputs.multicam_synthetic import sample_boxes
from .pipeline.processing_steps import (
    AffineTransformer,
    BoundingBoxToHeatmapConverter,
    DCTWirePacker,
    DCTWireUnpacker,
    ImageDecoder,
    ImageMeanStdDevNormalizer,
    PhotoMetricDistorter,
    TensorSizeAdder,
    WirePlanePacker,
    WirePlaneUnpacker,
    YCbCrToRGBConverter,
    optimize_band_groups,
)
from .tools import Stopwatch

NUM_CAMERAS = 2
NUM_CLASSES = 10
IMAGE_HW = (372, 512)
OUT_HW = (256, 512)
HEATMAP_HW = (64, 128)


def _structure(num_cameras: int) -> SampleDataGroup:
    cam = SampleDataGroup()
    cam.add_data_field("image", DType.UINT8)
    ann = SampleDataGroup()
    ann.add_data_field("bboxes", DType.FLOAT)
    ann.add_data_field("categories", DType.INT32)
    cam.add_data_group_field("annotations", ann)
    root = SampleDataGroup()
    root.add_data_group_field_array("cameras", cam, num_cameras)
    root.add_data_field("token", DType.STRING)
    return root


class SyntheticNuScenesProvider(DataProvider):
    """The JAX example's stand-in for a NuScenes provider: 8 random JPEGs
    (PIL, quality 90) cycled over the cameras, 16 random boxes per camera."""

    def __init__(self, num_samples: int = 64):
        from PIL import Image

        self._n = num_samples
        rng = np.random.default_rng(0)
        self._jpegs = []
        for _ in range(8):
            img = rng.integers(0, 255, (*IMAGE_HW, 3), np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=90)
            self._jpegs.append(np.frombuffer(buf.getvalue(), np.uint8).copy())

    @property
    def sample_data_structure(self) -> SampleDataGroup:
        return _structure(NUM_CAMERAS)

    def get_data(self, sample_index: int) -> SampleDataGroup:
        rng = np.random.default_rng(sample_index)
        sdg = self.sample_data_structure
        n_obj = 16
        for cidx in range(NUM_CAMERAS):
            cam = sdg["cameras"][cidx]
            cam["image"] = self._jpegs[(sample_index + cidx) % len(self._jpegs)]
            x1 = rng.uniform(0, IMAGE_HW[1] - 40, (n_obj,))
            y1 = rng.uniform(0, IMAGE_HW[0] - 40, (n_obj,))
            cam["annotations"]["bboxes"] = np.stack(
                [x1, y1, x1 + rng.uniform(10, 120, n_obj), y1 + rng.uniform(10, 90, n_obj)],
                axis=1,
            ).astype(np.float32)
            cam["annotations"]["categories"] = rng.integers(
                0, NUM_CLASSES, (n_obj,)
            ).astype(np.int32)
        sdg["token"] = f"sample-{sample_index:06d}"
        return sdg

    def get_number_of_samples(self) -> int:
        return self._n


class BenchNuScenesProvider(DataProvider):
    """bench.py's dataset in the example's sample structure: ``num_unique``
    sets of ``num_cameras`` q90 JPEGs of ``image_hw`` (bench.py's frames and
    cache format, :func:`~.pipeline.inputs.multicam_jpeg.bench_jpegs`) and
    bench.py's box draws, ``max_objects`` boxes of ``num_classes`` classes
    per camera."""

    def __init__(self, num_samples: int = 6400, num_unique: int = 16,
                 image_hw: Tuple[int, int] = (372, 1024), num_cameras: int = 6,
                 max_objects: int = 32, num_classes: int = NUM_CLASSES,
                 cache_dir: Optional[str] = None):
        self._n = num_samples
        self._hw = tuple(image_hw)
        self._num_cameras = num_cameras
        self._max_objects = max_objects
        self._num_classes = num_classes
        self._jpegs = bench_jpegs(num_unique * num_cameras, self._hw, cache_dir)

    @property
    def sample_data_structure(self) -> SampleDataGroup:
        return _structure(self._num_cameras)

    def get_data(self, sample_index: int) -> SampleDataGroup:
        sdg = self.sample_data_structure
        boxes = sample_boxes(sample_index, self._num_cameras, self._hw, self._max_objects,
                             self._num_classes)
        for c in range(self._num_cameras):
            cam = sdg["cameras"][c]
            cam["image"] = self._jpegs[(sample_index * self._num_cameras + c) % len(self._jpegs)]
            cam["annotations"]["bboxes"] = boxes[c][0]
            cam["annotations"]["categories"] = boxes[c][1]
        sdg["token"] = f"sample-{sample_index:06d}"
        return sdg

    def get_number_of_samples(self) -> int:
        return self._n


def host_shard_info() -> Tuple[int, int]:
    """``(shard_id, num_shards)`` of this process: its rank and the world
    size when ``torch.distributed`` is initialised, else ``(0, 1)``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def wire_steps(wire: str, provider: DataProvider, image_hw: Sequence[int]):
    """The example's wire: the host steps and the card's first steps."""
    image_hw = tuple(image_hw)
    if wire == "dct":
        if not native_jpeg.available():
            raise RuntimeError(
                "wire='dct' needs the native libjpeg decoder, which did not build "
                f"({native_jpeg.build_error()}); pass wire='yuv' for the pixel wire "
                "(nothing falls back to it quietly)"
            )
        probe_jpegs = [provider.get_data(i)["cameras"][0]["image"] for i in range(3)]
        groups = optimize_band_groups(probe_jpegs, image_hw, image_hw, max_groups=16)
        return [
            DCTWirePacker("image", source_hw=image_hw, out_hw=image_hw, grouping=groups),
            DCTWireUnpacker("image", source_hw=image_hw, out_hw=image_hw, grouping=groups),
        ]
    if wire == "yuv":
        return [
            ImageDecoder("image", wire_format="yuv420", decoder="auto"),
            WirePlanePacker(["image", "image_cbcr"]),
            WirePlaneUnpacker(["image", "image_cbcr"]),
        ]
    raise ValueError(f"wire must be 'dct' or 'yuv', got {wire!r}")


def detection_steps(out_hw=OUT_HW, heatmap_hw=HEATMAP_HW, num_classes: int = NUM_CLASSES):
    """The example's card steps after the wire, in order."""
    return [
        YCbCrToRGBConverter("image"),
        TensorSizeAdder("image", "_hw"),
        AffineTransformer(
            output_hw=out_hw,
            resizing_mode=AffineTransformer.ResizingMode.STRETCH,
            image_field_names="image",
            transformation_steps=[
                AffineTransformer.UniformScaling(0.5, 0.9, 1.1),
                AffineTransformer.Translation(0.5, [-20.0, -20.0], [20.0, 20.0]),
            ],
        ),
        PhotoMetricDistorter(
            "image",
            min_max_brightness=[-16.0, 16.0],
            min_max_hue=[-12.0, 12.0],
            min_max_contrast=[0.75, 1.25],
            min_max_saturation=[0.8, 1.2],
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
            height_width_bboxes_heatmap_opt_out_name="hw",
        ),
        ImageMeanStdDevNormalizer(
            "image", mean=[103.5, 116.3, 123.7], std_dev=[57.4, 57.1, 58.4]
        ),
    ]


def build_pipeline(batch_size: int = 4, wire: str = "dct", device=None,
                   provider: Optional[DataProvider] = None,
                   image_hw: Sequence[int] = IMAGE_HW, out_hw=OUT_HW, heatmap_hw=HEATMAP_HW,
                   num_threads: int = 4):
    """The example's loader and pipeline: ``(loader, pipe)``. ``loader`` is a
    :class:`StructuredOutputIterator` made by ``CreateAsDataLoaderObject``
    (an instance of ``torch.utils.data.DataLoader`` too), yielding nested
    dicts of tensors. ``device`` defaults to the card (raises without
    one); ``provider`` defaults to :class:`SyntheticNuScenesProvider`, whose
    frames are ``image_hw``."""
    device = resolve_device(device)
    shard_id, num_shards = host_shard_info()
    provider = SyntheticNuScenesProvider() if provider is None else provider
    input_callable = ShuffledShardedInputCallable(
        provider, batch_size=batch_size, shard_id=shard_id, num_shards=num_shards,
        shuffle=True, seed=21,
    )
    steps = wire_steps(wire, provider, image_hw) + detection_steps(out_hw, heatmap_hw)
    definition = PipelineDefinition(
        input_callable, steps, check_data_format=False,
        copy_external_source_passthrough_outputs=False,
    )
    pipe = definition.get_pipeline(batch_size=batch_size, num_threads=num_threads,
                                   device=device)
    blueprint = definition.check_and_get_output_data_structure()
    loader = StructuredOutputIterator.CreateAsDataLoaderObject(
        num_batches_in_epoch=input_callable.length,
        pipeline=pipe,
        sample_data_structure_blueprint=blueprint,
    )
    return loader, pipe


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    parser.add_argument("--wire", default="dct", choices=("dct", "yuv"))
    args = parser.parse_args(argv)

    sw = Stopwatch()
    sw.enable(num_warmup_iters=1, print_every_n_iters=None, do_device_sync=True)
    loader, pipe = build_pipeline(wire=args.wire, device=args.device)
    # optional phase timeline (chrome://tracing / Perfetto): per-batch
    # producer and consumer spans
    trace_path = os.environ.get("ACCVLAB_EXAMPLE_TRACE")
    if trace_path:
        pipe.start_trace()
    print(f"device: {pipe.device}  batches/epoch: {len(loader)}")
    try:
        for i, batch in enumerate(loader):
            sw.start_meas("batch")
            img = batch["cameras"][0]["image"]
            heat = batch["cameras"][0]["annotations"]["heatmap"]
            if img.is_cuda:
                torch.cuda.synchronize(img.device)
            sw.end_meas("batch")
            sw.finish_iter()
            if i == 0:
                print(f"image {tuple(img.shape)} {img.dtype} | heatmap {tuple(heat.shape)}")
        sw.print_eval_times()
        if trace_path:
            trace = pipe.stop_trace(trace_path)
            print(f"phase timeline: {len(trace)} events -> {trace_path}")
    finally:
        pipe.stop()


if __name__ == "__main__":
    main()
