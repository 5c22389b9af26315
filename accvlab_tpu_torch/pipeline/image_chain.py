"""Where the device stage's image chain goes through one kernel.

The device steps ``AffineTransformer`` -> ``PhotoMetricDistorter`` ->
``ImageMeanStdDevNormalizer`` on one image name make dozens of full-size
passes through device memory between the uint8 frames and the float32
images. :func:`run_device_steps`, which runs the device stage for the
executor's eager batches and for its traced program alike, sends such a
chain through the operator ``accvlab_tpu_torch::image_chain``
(:mod:`.operators.image_chain`): it reads each frame once and writes each
image once.

The steps keep their randomness and geometry. Each still runs in its place
and draws what it draws, so the draw schedule is the same; the affine step
updates points, projections and sizes and warps its other images, and hands
back the sampling maps of the chain's images instead of warping them; the
photometric step hands back its per-sample values; at the normalizer's place
the operator makes the images. The format check (``check``) holds each step
to its blueprint as before.

The executor decides once, when it is built, whether its chain goes through
the operator: when the input says so.

* :func:`find_image_chain`: the steps hold the three on the same image name,
  in that order, and every step between them is of a type known to leave
  that name alone (the heatmap converter, unless it reads the images'
  size); the normalizer's output is FLOAT;
* :func:`takes_images`: at the affine step every image under the name is
  typed UINT8, and the pipeline's device is one the kernel runs on (the
  card).

Otherwise the steps run as written: on CPU tensors, on float images, in
another order, or with an unknown step between them. A uint8 image that
reaches the photometric step is ``(B, H, W, 3)``; the operator takes it
contiguous and refuses any other shape.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Union

import torch

from .dtypes import DType
from .operators.image_chain import chain_consts, image_chain, pack_params
from .processing_steps.affine_transformer import AffineTransformer
from .processing_steps.bounding_box_to_heatmap_converter import BoundingBoxToHeatmapConverter
from .processing_steps.image_normalizers import ImageMeanStdDevNormalizer
from .processing_steps.photo_metric_distorter import PhotoMetricDistorter
from .sample_data_group import SampleDataGroup

Name = Union[str, int]

#: the devices whose tensors the kernel takes
KERNEL_DEVICES = ("cuda",)


class ImageChain(NamedTuple):
    """The positions of the chain's steps among the device steps, and the
    image name."""
    affine: int
    photometric: int
    normalizer: int
    name: Name


def _leaves_images(step, name: Name) -> bool:
    """Whether ``step`` is known to neither read nor write the images under
    ``name``."""
    return type(step) is BoundingBoxToHeatmapConverter and step._image_field_name != name


def find_image_chain(steps: Sequence) -> Optional[ImageChain]:
    """The first chain in ``steps`` (the device steps, in order) that the
    operator can take, or None."""
    for a, affine in enumerate(steps):
        if type(affine) is not AffineTransformer:
            continue
        for name in affine._image_field_names:
            found = []
            for i in range(a + 1, len(steps)):
                step = steps[i]
                want = (PhotoMetricDistorter, ImageMeanStdDevNormalizer)[len(found)]
                if type(step) is want and step._image_name == name:
                    found.append(i)
                    if len(found) == 2:
                        if step._output_type == DType.FLOAT:
                            return ImageChain(a, found[0], i, name)
                        break
                elif not _leaves_images(step, name):
                    break
    return None


def takes_images(blueprint: SampleDataGroup, name: Name, device) -> bool:
    """Whether the operator takes the images under ``name``: every one typed
    UINT8 in ``blueprint`` (the data's format at the affine step), on a
    ``device`` the kernel runs on."""
    paths = blueprint.find_all_occurrences(name)
    return (torch.device(device).type in KERNEL_DEVICES and bool(paths)
            and all(blueprint.get_type_of_item_in_path(p) == DType.UINT8 for p in paths))


def run_device_steps(steps: Sequence, sdg: SampleDataGroup, ctx, chain: Optional[ImageChain],
                     apply: Callable) -> SampleDataGroup:
    """The device steps on ``sdg``, their draws from ``ctx``; ``chain``
    (:func:`find_image_chain` of ``steps`` where :func:`takes_images`, else
    None) goes through the operator. ``apply(i, fn, sdg)`` runs ``fn``, the
    ``i``-th step's ``_process`` or its stand-in in the chain, on ``sdg``
    (with the step's format check where the caller checks)."""
    held = {}

    def affine(data):
        held["maps"], held["out_hw"] = steps[chain.affine].image_params(data, chain.name)
        return data

    def photometric(data):
        held["values"], held["bgr"] = steps[chain.photometric].image_params(data)
        return data

    def normalizer(data):
        params = pack_params(held["maps"], held["values"])
        consts = chain_consts(held["bgr"], *steps[chain.normalizer].image_params())
        oh, ow = held["out_hw"]
        for ip in data.find_all_occurrences(chain.name):
            image = image_chain(data.get_item_in_path(ip).contiguous(), params, oh, ow, consts)
            data.change_type_of_data_and_remove_data(ip, DType.FLOAT)
            data.set_item_in_path(ip, image)
        return data

    stand_ins = {} if chain is None else {chain.affine: affine, chain.photometric: photometric,
                                          chain.normalizer: normalizer}
    for i, step in enumerate(steps):
        step.set_random_context(ctx)
        sdg = apply(i, stand_ins.get(i, step._process), sdg)
    return sdg
