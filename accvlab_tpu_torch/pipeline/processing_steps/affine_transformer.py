"""Spatial augmentation step: composable random affine transforms with
consistent geometry updates, batched.

PyTorch port of ``accvlab_tpu/pipeline/processing_steps/affine_transformer.py``.
The 2x3 transform is built from composable :class:`TransformationStep`
objects exactly as there — one transform per sample, now a ``(B, 2, 3)``
tensor — then applied on the device:

* images via :func:`~accvlab_tpu_torch.pipeline.operators.warp_affine`,
* point sets via ``apply_transform_to_points``,
* projection matrices via ``add_post_transform_to_projection_matrix``,
* ``image_hw`` fields updated to the output size.

Composition convention (DALI's): a step combines as ``new @ prior`` and the
final transform is ``resize @ augmentation``. Probabilistic gating (``prob``)
is a per-sample ``where``. The transformation steps are those of the JAX
package: ``Translation``, ``ShiftInsideOriginalImage``,
``ShiftToAlignWithOriginalImageBorder``, ``Rotation``, ``UniformScaling``,
``NonUniformScaling``, ``Shearing`` and ``Selection``, each with its ordering
rules, and each drawing in the JAX package's order: a step's own draws in
``_apply``, then its ``prob`` coin; a ``Selection`` draws its choice, then
runs every option's steps (and their draws) whichever it chooses. Degrees
become radians in float32 before ``cos``/``sin``/``tan``, as there.

The input size is a ``(B, 2)`` float32 tensor on the batch's device: the
images' shape, or each sample's own ``image_hw`` when
``image_hw_field_names`` is given, as the JAX package reads it per sample
under ``vmap``. So samples of different sizes padded to one shape each get
their own resize, and nothing is read back to the host. The constants are
made on the device (no copy from host memory).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from enum import Enum
from typing import List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ._common import as_name_list, batch_tensor
from .pipeline_step_base import PipelineStepBase
from ..operators.image_ops import sampling_maps, warp_affine
from ..operators.point_ops import (
    add_post_transform_to_projection_matrix,
    apply_transform_to_points,
    homogeneous,
)
from ..sample_data_group import SampleDataGroup

Name = Union[str, int]


def _compose(new: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
    """``new @ [prior; 0 0 1]`` for ``(B, 2, 3)`` affines, summed in dot order."""
    p3 = homogeneous(prior)
    return (
        new[:, :, 0, None] * p3[:, None, 0, :]
        + new[:, :, 1, None] * p3[:, None, 1, :]
        + new[:, :, 2, None] * p3[:, None, 2, :]
    )


def _translation_mat(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    one, zero = torch.ones_like(tx), torch.zeros_like(tx)
    return torch.stack(
        [torch.stack([one, zero, tx], -1), torch.stack([zero, one, ty], -1)], -2
    )


def _corner_coords(prior: torch.Tensor, image_hw: torch.Tensor):
    """The prior transform of each sample's upper-left ``(0, 0)`` and
    lower-right ``(w, h)`` corners, as ``prior @ [x, y, 1]`` (dot order), and
    their element-wise min and max: ``(B, 2)`` each."""
    ul = prior[:, :, 2]
    lr = prior[:, :, 0] * image_hw[:, 1, None] + prior[:, :, 1] * image_hw[:, 0, None] + ul
    return torch.minimum(ul, lr), torch.maximum(ul, lr)


_DEG = float(np.float32(np.pi / 180.0))


def _about_center(l00, l01, l10, l11, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """``(B, 2, 3)`` matrix applying the 2x2 linear map about ``(cx, cy)``."""
    tx = cx - (l00 * cx + l01 * cy)
    ty = cy - (l10 * cx + l11 * cy)
    return torch.stack(
        [torch.stack([l00, l01, tx], -1), torch.stack([l10, l11, ty], -1)], -2
    )


class AffineTransformer(PipelineStepBase):
    """Random affine augmentation with consistent geometry updates."""

    placement = "device"

    class TransformationStep(ABC):
        """One composable transform with an application probability."""

        def __init__(self, prob: float):
            self.prob = prob
            self._rng = None
            self._bsz = 1
            self._device = torch.device("cpu")

        def __call__(self, prior_trafo: torch.Tensor, image_hw: torch.Tensor,
                     rng) -> torch.Tensor:
            self._rng = rng
            self._bsz = prior_trafo.shape[0]
            self._device = prior_trafo.device
            applied = self._apply(prior_trafo, image_hw)
            if self.prob >= 1.0:
                return applied
            draw = self._uniform(0.0, 1.0)
            return torch.where((draw < self.prob)[:, None, None], applied, prior_trafo)

        @abstractmethod
        def check_prev_types_compatible_and_add_current_type(
            self, prev_types: Set[type]
        ) -> Set[type]:
            """Validate ordering constraints; return types incl. this step's."""

        @abstractmethod
        def _apply(self, prior_trafo: torch.Tensor, image_hw) -> torch.Tensor:
            """Return the composed ``(B, 2, 3)`` transforms with this step applied."""

        def _uniform(self, lo, hi) -> torch.Tensor:
            draw = self._rng.uniform(lo, hi, shape=(self._bsz,))
            return batch_tensor(draw, self._device).to(torch.float32)

        def _full(self, value) -> torch.Tensor:
            """``value`` as float32 for every sample of the batch."""
            return torch.full((self._bsz,), float(np.float32(value)), device=self._device)

        def _get_random_in_range(self, lo, hi) -> torch.Tensor:
            if lo == hi:
                return self._full(lo)
            return self._uniform(lo, hi)

        @staticmethod
        def _get_center_xy(image_hw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
            """Each sample's centre ``(x, y)`` from its ``(B, 2)`` float32 size."""
            return image_hw[:, 1] * 0.5, image_hw[:, 0] * 0.5

        def _simple_add(self, prev_types: Set[type]) -> Set[type]:
            res = set(prev_types)
            res.add(self.__class__)
            return res

    class Translation(TransformationStep):
        """Shift by a fixed or range-random (x, y) offset."""

        def __init__(self, prob, min_xy: Sequence[float], max_xy: Optional[Sequence[float]] = None):
            super().__init__(prob)
            self.min_xy = list(min_xy)
            self.max_xy = list(max_xy) if max_xy is not None else None

        def _apply(self, prior_trafo, image_hw):
            if self.max_xy is None:
                tx, ty = self._full(self.min_xy[0]), self._full(self.min_xy[1])
            else:
                tx = self._get_random_in_range(self.min_xy[0], self.max_xy[0])
                ty = self._get_random_in_range(self.min_xy[1], self.max_xy[1])
            return _compose(_translation_mat(tx, ty), prior_trafo)

        def check_prev_types_compatible_and_add_current_type(self, prev_types):
            return self._simple_add(prev_types)

    class ShiftInsideOriginalImage(TransformationStep):
        """Random shift keeping the (scaled-up) image covering the viewport.

        Acts per dimension only where the transformed image is larger than
        the viewport; not allowed after Rotation or Shearing. Draws x, then
        y, each in the sample's own range."""

        def __init__(self, prob, shift_x: bool, shift_y: bool):
            super().__init__(prob)
            self.shift_x = shift_x
            self.shift_y = shift_y

        def _apply(self, prior_trafo, image_hw):
            min_coords, max_coords = _corner_coords(prior_trafo, image_hw)
            view = torch.stack([image_hw[:, 1], image_hw[:, 0]], -1)
            min_shift = -min_coords
            max_shift = view - max_coords
            lo = torch.minimum(min_shift, max_shift)
            hi = torch.maximum(min_shift, max_shift)
            dx = self._uniform(lo[:, 0], hi[:, 0])
            dy = self._uniform(lo[:, 1], hi[:, 1])
            movable = (min_shift < max_shift).to(torch.float32)
            dx = dx * (float(self.shift_x) * movable[:, 0])
            dy = dy * (float(self.shift_y) * movable[:, 1])
            return _compose(_translation_mat(dx, dy), prior_trafo)

        def check_prev_types_compatible_and_add_current_type(self, prev_types):
            if (
                AffineTransformer.Rotation in prev_types
                or AffineTransformer.Shearing in prev_types
            ):
                raise ValueError(
                    "Cannot perform `ShiftInsideOriginalImage` if rotation or "
                    "shearing are (potentially) performed before."
                )
            return self._simple_add(prev_types)

    class ShiftToAlignWithOriginalImageBorder(TransformationStep):
        """Shift so the transformed image aligns with one border of the
        viewport; not allowed after Rotation or Shearing."""

        class Border(Enum):
            TOP = 0
            LEFT = 1
            BOTTOM = 2
            RIGHT = 3

        def __init__(self, prob,
                     border: "AffineTransformer.ShiftToAlignWithOriginalImageBorder.Border"):
            super().__init__(prob)
            self._border = border

        def _apply(self, prior_trafo, image_hw):
            min_coords, max_coords = _corner_coords(prior_trafo, image_hw)
            zero = torch.zeros_like(image_hw[:, 0])
            b = self.Border
            if self._border == b.TOP:
                tx, ty = zero, -min_coords[:, 1]
            elif self._border == b.LEFT:
                tx, ty = -min_coords[:, 0], zero
            elif self._border == b.BOTTOM:
                tx, ty = zero, image_hw[:, 0] - max_coords[:, 1]
            elif self._border == b.RIGHT:
                tx, ty = image_hw[:, 1] - max_coords[:, 0], zero
            else:
                raise NotImplementedError(f"Border type {self._border} not supported")
            return _compose(_translation_mat(tx, ty), prior_trafo)

        def check_prev_types_compatible_and_add_current_type(self, prev_types):
            if (
                AffineTransformer.Rotation in prev_types
                or AffineTransformer.Shearing in prev_types
            ):
                raise ValueError(
                    "Cannot perform `ShiftToAlignWithOriginalImageBorder` if "
                    "rotation or shearing are (potentially) performed before."
                )
            return self._simple_add(prev_types)

    class Rotation(TransformationStep):
        """Rotate about the image center by a fixed or range-random angle
        (degrees; the reference's sign convention)."""

        def __init__(self, prob, min_rot: float, max_rot: Optional[float] = None):
            super().__init__(prob)
            self.min_rot = min_rot
            self.max_rot = max_rot

        def _apply(self, prior_trafo, image_hw):
            if self.max_rot is None:
                angle = self._full(-np.float32(self.min_rot))
            else:
                angle = -self._get_random_in_range(self.min_rot, self.max_rot)
            rad = angle * _DEG
            c, s = torch.cos(rad), torch.sin(rad)
            cx, cy = self._get_center_xy(image_hw)
            return _compose(_about_center(c, -s, s, c, cx, cy), prior_trafo)

        def check_prev_types_compatible_and_add_current_type(self, prev_types):
            return self._simple_add(prev_types)

    class UniformScaling(TransformationStep):
        """Scale uniformly about the image center."""

        def __init__(self, prob, min_scaling: float, max_scaling: Optional[float] = None):
            super().__init__(prob)
            self.min_scaling = min_scaling
            self.max_scaling = max_scaling

        def _apply(self, prior_trafo, image_hw):
            if self.max_scaling is None:
                s = self._full(self.min_scaling)
            else:
                s = self._get_random_in_range(self.min_scaling, self.max_scaling)
            zero = torch.zeros_like(s)
            cx, cy = self._get_center_xy(image_hw)
            return _compose(_about_center(s, zero, zero, s, cx, cy), prior_trafo)

        def check_prev_types_compatible_and_add_current_type(self, prev_types):
            return self._simple_add(prev_types)

    class NonUniformScaling(TransformationStep):
        """Scale x and y independently about the image center (draws x,
        then y)."""

        def __init__(
            self,
            prob,
            min_scaling_xy: Sequence[float],
            max_scaling_xy: Optional[Sequence[float]] = None,
        ):
            super().__init__(prob)
            self.min_scaling_xy = list(min_scaling_xy)
            self.max_scaling_xy = list(max_scaling_xy) if max_scaling_xy is not None else None

        def _apply(self, prior_trafo, image_hw):
            if self.max_scaling_xy is None:
                sx = self._full(self.min_scaling_xy[0])
                sy = self._full(self.min_scaling_xy[1])
            else:
                sx = self._get_random_in_range(self.min_scaling_xy[0], self.max_scaling_xy[0])
                sy = self._get_random_in_range(self.min_scaling_xy[1], self.max_scaling_xy[1])
            zero = torch.zeros_like(sx)
            cx, cy = self._get_center_xy(image_hw)
            return _compose(_about_center(sx, zero, zero, sy, cx, cy), prior_trafo)

        def check_prev_types_compatible_and_add_current_type(self, prev_types):
            return self._simple_add(prev_types)

    class Shearing(TransformationStep):
        """Shear by (x, y) angles in degrees about the image center (draws
        x, then y)."""

        def __init__(
            self,
            prob,
            min_shearing_xy: Sequence[float],
            max_shearing_xy: Optional[Sequence[float]] = None,
        ):
            super().__init__(prob)
            self.min_shearing_xy = list(min_shearing_xy)
            self.max_shearing_xy = (
                list(max_shearing_xy) if max_shearing_xy is not None else None
            )

        def _apply(self, prior_trafo, image_hw):
            if self.max_shearing_xy is None:
                ax = self._full(self.min_shearing_xy[0])
                ay = self._full(self.min_shearing_xy[1])
            else:
                ax = self._get_random_in_range(self.min_shearing_xy[0], self.max_shearing_xy[0])
                ay = self._get_random_in_range(self.min_shearing_xy[1], self.max_shearing_xy[1])
            tx = torch.tan(ax * _DEG)
            ty = torch.tan(ay * _DEG)
            one = torch.ones_like(tx)
            cx, cy = self._get_center_xy(image_hw)
            return _compose(_about_center(one, tx, ty, one, cx, cy), prior_trafo)

        def check_prev_types_compatible_and_add_current_type(self, prev_types):
            return self._simple_add(prev_types)

    class Selection(TransformationStep):
        """Choose one step sequence out of alternatives with the given
        probabilities, per sample. The choice is drawn first; then every
        option's steps run (and draw) in order, whichever is chosen."""

        _eps = 1e-6

        def __init__(self, prob, option_probs: Sequence[float], options: Sequence):
            super().__init__(prob)
            num_options = len(option_probs)
            assert len(options) == num_options, (
                "Number of per-option probabilities and options does not match"
            )
            base = AffineTransformer.TransformationStep
            self._options = [o if not isinstance(o, base) else [o] for o in options]
            accum = np.cumsum(np.asarray(option_probs, np.float64))
            assert abs(accum[-1] - 1.0) <= self._eps, (
                "Probabilities for options do not sum up to 1"
            )
            self._accum = [float(a) for a in accum]

        def _apply(self, prior_trafo, image_hw):
            draw = self._uniform(0.0, 1.0)
            res = prior_trafo
            chosen = torch.zeros_like(draw, dtype=torch.bool)
            for i, accum in enumerate(self._accum):
                option_res = prior_trafo
                for s in self._options[i]:
                    option_res = s(option_res, image_hw, self._rng)
                within = draw <= accum
                take = ~chosen & within
                res = torch.where(take[:, None, None], option_res, res)
                chosen = chosen | within
            return res

        def check_prev_types_compatible_and_add_current_type(self, prev_types):
            res = set(prev_types)
            for option in self._options:
                option_types = set(prev_types)
                for el in option:
                    option_types = el.check_prev_types_compatible_and_add_current_type(
                        option_types
                    )
                res = res.union(option_types)
            return res

    class ResizingMode(Enum):
        STRETCH = 0
        PAD = 1
        CROP = 2

    class ResizingAnchor(Enum):
        CENTER = 0
        TOP_OR_LEFT = 1
        BOTTOM_OR_RIGHT = 2

    def __init__(
        self,
        output_hw: Sequence[int],
        resizing_mode: "AffineTransformer.ResizingMode",
        resizing_anchor: Optional["AffineTransformer.ResizingAnchor"] = None,
        image_field_names: Optional[Union[Name, List[Name], Tuple[Name, ...]]] = None,
        image_hw_field_names: Optional[Union[Name, List[Name], Tuple[Name, ...]]] = None,
        projection_matrix_field_names: Optional[Union[Name, List[Name], Tuple[Name, ...]]] = None,
        point_field_names: Optional[Union[Name, List[Name], Tuple[Name, ...]]] = None,
        transformation_steps: Optional[Sequence["AffineTransformer.TransformationStep"]] = None,
        transform_image_on_gpu: bool = True,  # parity arg; device placement implied
    ):
        super().__init__()
        image_field_names = as_name_list(image_field_names) or []
        image_hw_field_names = as_name_list(image_hw_field_names) or []
        assert image_field_names or image_hw_field_names, (
            "Either image_field_names or image_hw_field_names must be provided "
            "(source of the input image size)."
        )
        self._image_field_names = image_field_names
        self._extract_size_from_images = len(image_field_names) > 0
        self._image_hw_field_names = image_hw_field_names
        self._projection_matrix_field_names = as_name_list(projection_matrix_field_names) or []
        self._point_field_names = as_name_list(point_field_names) or []
        self._transformation_steps = list(transformation_steps or [])
        self._output_hw = tuple(int(v) for v in output_hw)
        self._resizing_mode = resizing_mode
        self._resizing_anchor = resizing_anchor
        del transform_image_on_gpu

        types_seen: Set[type] = set()
        for step in self._transformation_steps:
            types_seen = step.check_prev_types_compatible_and_add_current_type(types_seen)

    # -- transform construction ----------------------------------------- #

    def _get_transformation(self, image_hw: torch.Tensor) -> torch.Tensor:
        resize = self._get_transformation_to_output_size(image_hw)
        if self._transformation_steps:
            augmentation = torch.eye(2, 3, device=image_hw.device).expand(image_hw.shape[0], 2, 3)
            for step in self._transformation_steps:
                augmentation = step(augmentation, image_hw, self.random)
            return _compose(resize, augmentation)  # resize applied after
        return resize

    def _get_transformation_to_output_size(self, input_hw: torch.Tensor) -> torch.Tensor:
        """Parity: ``affine_transformer.py:468-494``, per sample from the
        ``(B, 2)`` float32 sizes, in its float32 order (a division, then the
        ``frac`` products)."""
        hw_h, hw_w = input_hw[:, 0], input_hw[:, 1]
        out_h = torch.full_like(hw_h, float(self._output_hw[0]))
        out_w = torch.full_like(hw_w, float(self._output_hw[1]))
        zero = torch.zeros_like(hw_h)
        mode, anchor = self._resizing_mode, self._resizing_anchor
        if mode == self.ResizingMode.STRETCH:
            rows = [[out_w / hw_w, zero, zero], [zero, out_h / hw_h, zero]]
        elif mode in (self.ResizingMode.PAD, self.ResizingMode.CROP):
            ratio_h, ratio_w = out_h / hw_h, out_w / hw_w
            s = (torch.minimum if mode == self.ResizingMode.PAD else torch.maximum)(ratio_h,
                                                                                    ratio_w)
            if anchor == self.ResizingAnchor.TOP_OR_LEFT:
                shift = (zero, zero)
            elif anchor in (self.ResizingAnchor.CENTER, self.ResizingAnchor.BOTTOM_OR_RIGHT):
                frac = 0.5 if anchor == self.ResizingAnchor.CENTER else 1.0
                shift = (out_w * frac - s * hw_w * frac, out_h * frac - s * hw_h * frac)
            else:
                raise ValueError(f"Resizing anchor {anchor} not supported.")
            rows = [[s, zero, shift[0]], [zero, s, shift[1]]]
        else:
            raise ValueError(f"Resizing mode {mode} not supported.")
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    # -- step interface -------------------------------------------------- #

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        self._apply(data, None)
        return data

    def image_params(self, data: SampleDataGroup, image_name: Name):
        """What :meth:`_process` does, except warping the images under
        ``image_name``, which are left as they are: the step's part of the
        fused image chain (:mod:`..image_chain`). Returns the ``(B, 2, 3)``
        float32 maps from output to source pixels that their warp would
        sample with, and the output ``(height, width)``."""
        transform = self._apply(data, image_name)
        return sampling_maps(transform, transform.shape[0], transform.device), self._output_hw

    def _apply(self, data: SampleDataGroup, deferred: Optional[Name]) -> torch.Tensor:
        """The step on ``data`` but for the warp of the images under
        ``deferred`` (None: every image is warped); returns the transforms."""
        if self._extract_size_from_images:
            first = data.get_item_in_path(data.find_all_occurrences(self._image_field_names[0])[0])
            bsz, device = first.shape[0], first.device
            image_hw = torch.stack([torch.full((bsz,), float(v), device=device)
                                    for v in first.shape[-3:-1]], -1)
        else:
            hw_t = data.get_item_in_path(data.find_all_occurrences(self._image_hw_field_names[0])[0])
            image_hw = torch.as_tensor(hw_t).reshape(-1, 2).to(torch.float32)
            bsz, device = image_hw.shape[0], image_hw.device

        transform = self._get_transformation(image_hw)

        for image_field_name in self._image_field_names:
            if image_field_name == deferred:
                continue
            for ip in data.find_all_occurrences(image_field_name):
                image = data.get_item_in_path(ip)
                data.set_item_in_path(
                    ip, warp_affine(image, transform, self._output_hw, fill_value=0.0)
                )
        for name in self._projection_matrix_field_names:
            for pp in data.find_all_occurrences(name):
                parent = data.get_parent_of_path(pp)
                parent[name] = add_post_transform_to_projection_matrix(parent[name], transform)
        for name in self._point_field_names:
            for pp in data.find_all_occurrences(name):
                parent = data.get_parent_of_path(pp)
                parent[name] = apply_transform_to_points(parent[name], transform)
        if not self._extract_size_from_images:
            for name in self._image_hw_field_names:
                for sp in data.find_all_occurrences(name):
                    parent = data.get_parent_of_path(sp)
                    out_hw = torch.full((bsz, 2), self._output_hw[0], dtype=torch.int32,
                                        device=device)
                    out_hw[:, 1] = self._output_hw[1]
                    parent[name] = out_hw
        return transform

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        def require(names, what):
            for name in names:
                if len(data_empty.find_all_occurrences(name)) == 0:
                    raise KeyError(f"No occurrences of {what} with name `{name}` found.")

        if self._extract_size_from_images:
            require(self._image_field_names, "images")
        else:
            require(self._image_hw_field_names, "image sizes")
            require(self._image_field_names, "images")
        require(self._projection_matrix_field_names, "projection matrices")
        require(self._point_field_names, "point sets")
        return data_empty
