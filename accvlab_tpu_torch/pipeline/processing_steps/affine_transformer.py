"""Spatial augmentation step: composable random affine transforms with
consistent geometry updates, batched.

PyTorch port of ``accvlab_tpu/pipeline/processing_steps/affine_transformer.py``.
The 2x3 transform is built from composable :class:`TransformationStep`
objects exactly as there — one transform per sample, now a ``(B, 2, 3)``
tensor — then applied on the device:

* images via :func:`~accvlab_tpu_torch.pipeline.operators.warp_affine`,
* point sets via ``transform_points``,
* projection matrices via left-composition of the homogeneous transform,
* ``image_hw`` fields updated to the output size.

Composition convention (DALI's): a step combines as ``new @ prior`` and the
final transform is ``resize @ augmentation``. Probabilistic gating (``prob``)
is a per-sample ``where``. Ported transformation steps: ``Translation`` and
``UniformScaling`` (the ones the headline pipeline uses); the others wait
(ROADMAP.md).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from enum import Enum
from typing import List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ._common import as_name_list, batch_tensor
from .pipeline_step_base import PipelineStepBase
from ..operators.image_ops import warp_affine
from ..operators.point_ops import transform_points
from ..sample_data_group import SampleDataGroup

Name = Union[str, int]

_IDENTITY = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)


def _compose(new: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
    """``new @ [prior; 0 0 1]`` for ``(B, 2, 3)`` affines, summed in dot order."""
    bottom = torch.tensor([[0.0, 0.0, 1.0]], device=prior.device).expand(prior.shape[0], 1, 3)
    p3 = torch.cat([prior, bottom], dim=-2)  # (B, 3, 3)
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


def _about_center(l00, l01, l10, l11, cx: float, cy: float) -> torch.Tensor:
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

        def __call__(self, prior_trafo: torch.Tensor, image_hw, rng) -> torch.Tensor:
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

        def _get_random_in_range(self, lo, hi) -> torch.Tensor:
            if lo == hi:
                return torch.full((self._bsz,), float(np.float32(lo)), device=self._device)
            return self._uniform(lo, hi)

        @staticmethod
        def _get_center_xy(image_hw) -> Tuple[float, float]:
            hw = np.asarray(image_hw, np.float32)
            return float(hw[1] * np.float32(0.5)), float(hw[0] * np.float32(0.5))

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
                tx = torch.full((self._bsz,), float(np.float32(self.min_xy[0])), device=self._device)
                ty = torch.full((self._bsz,), float(np.float32(self.min_xy[1])), device=self._device)
            else:
                tx = self._get_random_in_range(self.min_xy[0], self.max_xy[0])
                ty = self._get_random_in_range(self.min_xy[1], self.max_xy[1])
            return _compose(_translation_mat(tx, ty), prior_trafo)

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
                s = torch.full((self._bsz,), float(np.float32(self.min_scaling)), device=self._device)
            else:
                s = self._get_random_in_range(self.min_scaling, self.max_scaling)
            zero = torch.zeros_like(s)
            cx, cy = self._get_center_xy(image_hw)
            return _compose(_about_center(s, zero, zero, s, cx, cy), prior_trafo)

        def check_prev_types_compatible_and_add_current_type(self, prev_types):
            return self._simple_add(prev_types)

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

    def _get_transformation(self, image_hw, bsz: int, device) -> torch.Tensor:
        resize = self._get_transformation_to_output_size(image_hw, bsz, device)
        if self._transformation_steps:
            augmentation = torch.as_tensor(_IDENTITY, device=device).expand(bsz, 2, 3)
            for step in self._transformation_steps:
                augmentation = step(augmentation, image_hw, self.random)
            return _compose(resize, augmentation)  # resize applied after
        return resize

    def _get_transformation_to_output_size(self, input_hw, bsz: int, device) -> torch.Tensor:
        """Parity: ``affine_transformer.py:468-494`` (static sizes, so the
        scalars are computed in float32 on the host)."""
        f32 = np.float32
        out_h, out_w = f32(self._output_hw[0]), f32(self._output_hw[1])
        hw = np.asarray(input_hw, f32)
        mode, anchor = self._resizing_mode, self._resizing_anchor
        if mode == self.ResizingMode.STRETCH:
            mat = [[out_w / hw[1], 0.0, 0.0], [0.0, out_h / hw[0], 0.0]]
        elif mode in (self.ResizingMode.PAD, self.ResizingMode.CROP):
            ratios = [out_h / hw[0], out_w / hw[1]]
            s = min(ratios) if mode == self.ResizingMode.PAD else max(ratios)
            if anchor == self.ResizingAnchor.TOP_OR_LEFT:
                shift = (f32(0.0), f32(0.0))
            elif anchor in (self.ResizingAnchor.CENTER, self.ResizingAnchor.BOTTOM_OR_RIGHT):
                frac = f32(0.5 if anchor == self.ResizingAnchor.CENTER else 1.0)
                shift = (out_w * frac - s * hw[1] * frac, out_h * frac - s * hw[0] * frac)
            else:
                raise ValueError(f"Resizing anchor {anchor} not supported.")
            mat = [[s, 0.0, shift[0]], [0.0, s, shift[1]]]
        else:
            raise ValueError(f"Resizing mode {mode} not supported.")
        return torch.as_tensor(np.asarray(mat, f32), device=device).expand(bsz, 2, 3)

    # -- step interface -------------------------------------------------- #

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        if self._extract_size_from_images:
            first = data.get_item_in_path(data.find_all_occurrences(self._image_field_names[0])[0])
            image_hw = tuple(int(v) for v in first.shape[-3:-1])
        else:
            hw_t = data.get_item_in_path(data.find_all_occurrences(self._image_hw_field_names[0])[0])
            # the transform needs the size as host scalars; all samples must share it
            hw_np = np.asarray(hw_t.cpu() if isinstance(hw_t, torch.Tensor) else hw_t)
            hw_np = hw_np.reshape(-1, 2)
            if not (hw_np == hw_np[:1]).all():
                raise ValueError("AffineTransformer: all samples of a batch must share image_hw")
            first = hw_t
            image_hw = tuple(int(v) for v in hw_np[0])
        bsz = first.shape[0]
        device = first.device if isinstance(first, torch.Tensor) else torch.device("cpu")

        transform = self._get_transformation(image_hw, bsz, device)

        for image_field_name in self._image_field_names:
            for ip in data.find_all_occurrences(image_field_name):
                image = data.get_item_in_path(ip)
                data.set_item_in_path(
                    ip, warp_affine(image, transform, self._output_hw, fill_value=0.0)
                )
        for name in self._projection_matrix_field_names:
            for pp in data.find_all_occurrences(name):
                parent = data.get_parent_of_path(pp)
                proj = parent[name].to(torch.float32)
                bottom = torch.tensor([[0.0, 0.0, 1.0]], device=device).expand(bsz, 1, 3)
                parent[name] = torch.matmul(torch.cat([transform, bottom], dim=-2), proj)
        for name in self._point_field_names:
            for pp in data.find_all_occurrences(name):
                parent = data.get_parent_of_path(pp)
                pts = parent[name].to(torch.float32)
                pairs = pts.reshape(*pts.shape[:-1], -1, 2)  # rows hold (x, y) pairs
                moved = transform_points(pairs.flatten(1, -2), transform).reshape(pairs.shape)
                parent[name] = moved.reshape(pts.shape)
        if not self._extract_size_from_images:
            for name in self._image_hw_field_names:
                for sp in data.find_all_occurrences(name):
                    parent = data.get_parent_of_path(sp)
                    parent[name] = torch.tensor(
                        self._output_hw, dtype=torch.int32, device=device
                    ).expand(bsz, 2).contiguous()
        return data

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
