"""The headline multi-camera pipeline of ``bench.py``, built on the port.

``bench.py:130-269``: bench.py's dataset of 6 cameras of 372x1024 q90 JPEGs
with 32 boxes of 10 classes each (16 unique frame sets), batches of 8 read
through ``ShuffledShardedInputCallable``, and one of three wires:

* ``wire="dct"`` (the default, as in bench.py): the **DCT wire**. The host
  runs only the JPEG entropy decode and packs the quantized coefficients
  (``DCTWirePacker``, libjpeg + ``csrc/dctpack.cpp``); the card decodes
  them (``DCTWireUnpacker``: unpack, IDCT, resize). The band grouping is
  ``grouping=``, by default ``"dp16"``: :func:`optimize_band_groups` over 3
  of the provider's JPEGs with at most 16 groups, as bench.py computes it
  at setup. Without the native libjpeg decoder this wire raises, where
  bench.py falls back quietly to the YUV wire;
* ``wire="yuv"``: the **YUV 4:2:0 pixel wire**. The host decodes
  (``ImageDecoder(decode_resize_hw=out_hw, wire_format="yuv420",
  decoder=decoder)``: libjpeg at its 6/8 DCT scale with ``"native"``, PIL
  with ``"pil"``) and packs the planes (``WirePlanePacker``); the card
  unpacks them (``WirePlaneUnpacker``);
* ``wire="frames"``: raw RGB frames of the same structured noise (no
  decoder, no wire codec), the path of the earlier slices and of
  :func:`~.train_centernet_e2e.build_train_pipeline`.

One packed transfer per batch; then, on the card: ``YCbCrToRGBConverter``
(after either JPEG wire) -> ``AffineTransformer`` ->
``PhotoMetricDistorter`` -> ``BoundingBoxToHeatmapConverter`` (the CUDA
rasterizer) -> ``ImageMeanStdDevNormalizer``.

``measure_input_idle`` is ``bench.py:272-361``: the share of a CenterNet
training loop fed by that pipeline that the card waits for input.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import torch

from ._device import resolve_device
from .models.centernet import CenterNetDetector, adam, init_params
from .parallel.mesh import data_shard_info
from .pipeline import PipelineDefinition, native_jpeg
from .pipeline.inputs import (
    MultiCameraJpegProvider,
    MultiCameraSyntheticProvider,
    SamplerBase,
    SamplerInputCallable,
    ShuffledShardedInputCallable,
)
from .pipeline.processing_steps import (
    AffineTransformer,
    BoundingBoxToHeatmapConverter,
    DCTWirePacker,
    DCTWireUnpacker,
    ImageDecoder,
    ImageMeanStdDevNormalizer,
    PhotoMetricDistorter,
    WirePlanePacker,
    WirePlaneUnpacker,
    YCbCrToRGBConverter,
    optimize_band_groups,
)

#: unique frame sets per wire: bench.py's 16 JPEG sets; the 2 raw-frame sets
#: that the earlier slices measured
NUM_UNIQUE = {"dct": 16, "yuv": 16, "frames": 2}
#: the DCT wire's static band groupings (``dct_wire.band_groups``)
STATIC_GROUPINGS = ("split12", "band", "diag8")


def dct_grouping(grouping, provider, source_hw, out_hw):
    """The DCT wire's band grouping from ``build_pipeline``'s ``grouping=``:
    ``"dpN"`` is :func:`optimize_band_groups` over camera 0's JPEGs of the
    provider's first 3 samples with at most N groups (bench.py:186-205);
    ``"split12"``, ``"band"`` and ``"diag8"`` and explicit ``(start, end)``
    pairs pass through. Anything else raises ``ValueError`` (bench.py falls
    back to ``"split12"``)."""
    if not isinstance(grouping, str):
        return tuple((int(a), int(b)) for a, b in grouping)
    if grouping in STATIC_GROUPINGS:
        return grouping
    if grouping.startswith("dp") and grouping[2:].isdigit():
        probe = [provider.jpeg(i, 0) for i in range(3)]
        return optimize_band_groups(probe, source_hw, out_hw, max_groups=int(grouping[2:]))
    raise ValueError(f"grouping must be 'dpN' (e.g. 'dp16'), one of {STATIC_GROUPINGS} or "
                     f"(start, end) pairs, got {grouping!r}")


def headline_steps(out_hw=(256, 704), heatmap_hw=(64, 176), num_classes: int = 10,
                   affine_prob: float = 0.5, photometric_prob: float = 0.5,
                   heatmap_implementation: str = "auto", hw_out_name: Optional[str] = None):
    """The device steps of bench.py's pipeline after the wire, in order.
    ``hw_out_name`` also asks the heatmap converter for each box's (h, w) on the heatmap
    grid under that name, as the training example's pipeline does."""
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
            height_width_bboxes_heatmap_opt_out_name=hw_out_name,
            implementation=heatmap_implementation,
        ),
        ImageMeanStdDevNormalizer("image", mean=[103.5, 116.3, 123.7], std_dev=[57.4, 57.1, 58.4]),
    ]


def build_pipeline(batch_size: int = 8, device=None, num_threads: Optional[int] = None,
                   hw: Tuple[int, int] = (372, 1024), num_cams: int = 6,
                   out_hw=(256, 704), heatmap_hw=(64, 176), num_samples: int = 6400,
                   num_unique: Optional[int] = None, affine_prob: float = 0.5,
                   photometric_prob: float = 0.5, heatmap_implementation: str = "auto",
                   seed: int = 0, hw_out_name: Optional[str] = None, wire: str = "dct",
                   wire_pack: bool = True, echo_factor: int = 1,
                   cache_dir: Optional[str] = None, sampler: Optional[SamplerBase] = None,
                   sampler_iterations: int = 1024, decoder: str = "pil",
                   grouping="dp16", worker_mode: str = "thread", mesh=None):
    """bench.py's pipeline on the port (``device`` defaults to the card).

    ``wire``: ``"dct"`` (the default), ``"yuv"`` or ``"frames"`` (module
    docstring). ``grouping``: the DCT wire's band grouping, ``"dpN"``,
    ``"split12"``, ``"band"``, ``"diag8"`` or ``(start, end)`` pairs
    (:func:`dct_grouping`); the chosen groups are the packer's ``groups``.
    ``wire_pack=False`` ships the YUV planes without the plane codec;
    ``decoder`` is the YUV wire's host decoder. ``num_unique`` defaults to
    :data:`NUM_UNIQUE` of the wire. ``cache_dir`` keeps the encoded JPEGs in
    bench.py's cache format there (``multicam_jpeg.bench_jpegs``).
    ``sampler`` replaces bench.py's shuffled reads with a
    ``SamplerInputCallable`` over ``sampler`` (for example a
    ``SequenceSampler``, drive order), built for ``sampler_iterations``
    batches plus the prefetch ring's 2. ``worker_mode="process"`` runs the
    per-sample host phase (the input and, on the YUV wire, the decoder) in
    ``num_threads`` spawned workers; the wire packers stay in the producer.
    ``mesh`` (:func:`.parallel.make_mesh`) delivers each batch as this rank's
    shard of the global batch (``DTensor`` leaves, ``Shard(0)`` over
    ``data``), its input read from this rank's shard of the dataset.
    """
    if wire not in NUM_UNIQUE:
        raise ValueError(f"wire must be one of {tuple(NUM_UNIQUE)}, got {wire!r}")
    device = resolve_device(device)
    if wire == "dct" and not native_jpeg.available():
        raise RuntimeError(
            "wire='dct' needs the native libjpeg decoder, which did not build "
            f"({native_jpeg.build_error()}); pass wire='yuv' with decoder='pil' for the pixel "
            "wire (nothing falls back to it quietly)"
        )
    if num_threads is None:
        num_threads = max(2, os.cpu_count() or 4)
    if num_unique is None:
        num_unique = NUM_UNIQUE[wire]
    if wire != "frames":
        provider = MultiCameraJpegProvider(num_samples=num_samples, num_unique=num_unique,
                                           hw=hw, num_cams=num_cams, cache_dir=cache_dir)
    if wire == "dct":
        groups = dct_grouping(grouping, provider, hw, out_hw)
        steps = [DCTWirePacker("image", source_hw=hw, out_hw=out_hw, grouping=groups),
                 DCTWireUnpacker("image", source_hw=hw, out_hw=out_hw, grouping=groups),
                 YCbCrToRGBConverter("image")]
    elif wire == "yuv":
        steps = [ImageDecoder("image", decode_resize_hw=out_hw, wire_format="yuv420",
                              decoder=decoder)]
        if wire_pack:  # bench.py's ACCVLAB_BENCH_WIRE_PACK
            steps += [WirePlanePacker(["image", "image_cbcr"]),
                      WirePlaneUnpacker(["image", "image_cbcr"])]
        steps.append(YCbCrToRGBConverter("image"))
    else:
        provider = MultiCameraSyntheticProvider(num_samples=num_samples, num_unique=num_unique,
                                                hw=hw, num_cams=num_cams)
        steps = []
    if sampler is None:
        shard_id, num_shards = (0, 1) if mesh is None else data_shard_info(mesh)
        inp = ShuffledShardedInputCallable(provider, batch_size=batch_size, shuffle=True,
                                           shard_id=shard_id, num_shards=num_shards)
    else:
        inp = SamplerInputCallable(provider, sampler, max_num_iterations=sampler_iterations,
                                   pre_fetch_queue_length=2)
    steps += headline_steps(out_hw, heatmap_hw, affine_prob=affine_prob,
                            photometric_prob=photometric_prob,
                            heatmap_implementation=heatmap_implementation,
                            hw_out_name=hw_out_name)
    definition = PipelineDefinition(inp, steps, check_data_format=False,
                                    copy_external_source_passthrough_outputs=False)
    return definition.get_pipeline(batch_size=batch_size, num_threads=num_threads,
                                   device=device, seed=seed, worker_mode=worker_mode, mesh=mesh,
                                   echo_factor=echo_factor)


def model_inputs(out: Dict[str, torch.Tensor], num_cams: int):
    """Every camera's images ``(B * num_cams, H, W, 3)`` and heatmaps
    ``(B * num_cams, Hf, Wf, C)`` of one pipeline batch, camera-major."""
    images = torch.cat([out[f"cameras.[{c}].image"] for c in range(num_cams)], 0)
    heat = torch.cat([out[f"cameras.[{c}].annotations.heatmap"] for c in range(num_cams)], 0)
    return images, heat.permute(0, 2, 3, 1)


def dense_focal_loss(outputs: Dict[str, torch.Tensor], heat: torch.Tensor) -> torch.Tensor:
    """bench.py's loss of ``measure_input_idle`` (``bench.py:307-320``): the
    penalty-reduced focal loss on the dense heatmap target, plus 0.01 times
    the mean absolute offset and size outputs."""
    pred = torch.sigmoid(outputs["heatmap"].float())
    pos = heat >= 0.999
    pos_loss = torch.where(pos, ((1 - pred) ** 2) * -torch.log(pred + 1e-6), 0.0)
    neg_loss = torch.where(~pos, ((1 - heat) ** 4) * (pred**2) * -torch.log(1 - pred + 1e-6), 0.0)
    n_pos = pos.sum().to(pred.dtype).clamp(min=1.0)
    focal = (pos_loss.sum() + neg_loss.sum()) / n_pos
    reg = outputs["offset"].abs().mean() + outputs["size"].abs().mean()
    return focal + 0.01 * reg


def dense_train_step(model: CenterNetDetector, opt: torch.optim.Optimizer, num_cams: int):
    """``step(out)``: one step of ``measure_input_idle``'s training on a
    pipeline batch ``out``; returns the loss as a device scalar."""

    def step(out: Dict[str, torch.Tensor]) -> torch.Tensor:
        images, heat = model_inputs(out, num_cams)
        loss = dense_focal_loss(model(images), heat)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def measure_input_idle(pipe, num_cams: int, n_iters: int = 6, width: int = 64) -> dict:
    """Share of a training loop's time that the card waits for input.

    A CenterNet (10 classes, ``width``) trained with :func:`dense_focal_loss`
    and Adam (lr 1e-3) on every camera of the pipeline's batches, on the
    pipeline's device. After one step and a warm-up window, ``t_e2e`` is the
    time per step over ``n_iters`` steps each fed a fresh batch by
    ``pipe.run()`` (its prefetch ring running), and ``t_comp`` the same on
    the first batch, cached. The card is synchronised once at the end of
    each window. ``idle = max(0, (t_e2e - t_comp) / t_e2e)``; it counts the
    pipeline's own device stage as idle, since that shares the card with
    the step.

    Returns ``{"t_e2e_s", "t_comp_s", "idle"}``.
    """
    model = CenterNetDetector(num_classes=10, width=width)
    init_params(model, torch.Generator().manual_seed(0)).to(pipe.device)
    step = dense_train_step(model, adam(model.parameters()), num_cams)
    out0 = pipe.run()
    step(out0).item()

    def loop(use_pipe: bool) -> float:
        t0 = time.perf_counter()
        for _ in range(n_iters):
            loss = step(pipe.run() if use_pipe else out0)
        loss.item()  # one synchronisation, at the end of the window
        return (time.perf_counter() - t0) / n_iters

    loop(True)  # the prefetch ring to its steady state
    t_e2e = loop(True)
    t_comp = loop(False)
    return {"t_e2e_s": t_e2e, "t_comp_s": t_comp, "idle": max(0.0, (t_e2e - t_comp) / t_e2e)}
