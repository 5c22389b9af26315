"""Photometric augmentation step, batched.

PyTorch port of ``accvlab_tpu/pipeline/processing_steps/photo_metric_distorter.py``:
random brightness / contrast (random pre- or post- color ops) / saturation /
hue / channel swap, with ONE set of per-sample random decisions applied
consistently to all matching images. The per-sample decisions are ``(B,)``
tensors and every operation is a per-sample ``where``-select over the batch;
the channel permutation is a batched gather.

The hue matrix product stays float32 with TF32 off (asserted).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ._common import batch_tensor
from .pipeline_step_base import PipelineStepBase
from ..dtypes import DType
from ..sample_data_group import SampleDataGroup

# the 6 channel permutations, indexed like the reference's enumerated cases
_CHANNEL_PERMS = np.array(
    [[0, 1, 2], [0, 2, 1], [1, 0, 2], [2, 1, 0], [2, 0, 1], [1, 2, 0]], np.int64
)

_RGB_LUMA = np.array([0.299, 0.587, 0.114], np.float32)

# RGB <-> YIQ (the classic NTSC matrices used by linear hue rotation)
_RGB2YIQ = np.array(
    [[0.299, 0.587, 0.114], [0.5959, -0.2746, -0.3213], [0.2115, -0.5227, 0.3112]],
    np.float32,
)
_YIQ2RGB = np.linalg.inv(_RGB2YIQ).astype(np.float32)

#: the scale of 8-bit values to [0, 1]
U8_INTENSITY = np.float32(1.0 / 255.0)


def _check_f32_matmul(device: torch.device):
    if device.type == "cuda" and (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "PhotoMetricDistorter needs float32 matrix products: TF32 is enabled "
            "(torch.backends.cuda.matmul.allow_tf32 / set_float32_matmul_precision)"
        )


def _e(v):  # per-sample value -> broadcast over (B, H, W, C)
    return v[:, None, None, None]


def _saturation(image, s, luma):
    gray = image[..., 0] * luma[0] + image[..., 1] * luma[1] + image[..., 2] * luma[2]
    return gray[..., None] + _e(s) * (image - gray[..., None])


def _hue_matrix(degrees: torch.Tensor) -> torch.Tensor:
    """``(B, 3, 3)`` float32 hue rotations by ``degrees`` in YIQ, acting on
    RGB column vectors."""
    rad = degrees * float(np.float32(np.pi / 180.0))
    c, s = torch.cos(rad), torch.sin(rad)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rot = torch.stack(
        [
            torch.stack([one, zero, zero], -1),
            torch.stack([zero, c, -s], -1),
            torch.stack([zero, s, c], -1),
        ],
        -2,
    )  # (B, 3, 3)
    _check_f32_matmul(degrees.device)
    yiq2rgb = torch.as_tensor(_YIQ2RGB, device=degrees.device)
    rgb2yiq = torch.as_tensor(_RGB2YIQ, device=degrees.device)
    return torch.matmul(torch.matmul(yiq2rgb, rot), rgb2yiq)


def _hue_rotate(image, m, is_bgr):
    if is_bgr:
        image = image.flip(-1)
    _check_f32_matmul(image.device)
    bsz, h, w, ch = image.shape
    out = torch.matmul(image.reshape(bsz, h * w, ch), m.transpose(1, 2)).reshape(image.shape)
    if is_bgr:
        out = out.flip(-1)
    return out


def sample_values(aug: dict, is_uint8: bool) -> dict:
    """The per-sample ``(B,)`` values of the distortion from the step's
    decisions (``PhotoMetricDistorter._draw_decisions``), for images of
    8-bit values (``is_uint8``) or of [0, 1] floats: the gates
    ``brightness``, ``pre_contrast``, ``saturation``, ``hue``,
    ``post_contrast`` and ``swap`` (bool), the brightness ``delta`` on the
    [0, 1] scale, the contrast ``alpha``, the saturation ``s``, the hue's
    ``(B, 3, 3)`` matrix ``hue_m`` and the channel permutation ``perm``
    ``(B, 3)`` (int64)."""
    intensity = U8_INTENSITY if is_uint8 else np.float32(1.0)
    return dict(
        brightness=aug["aug_brightness"],
        delta=aug["delta"] * float(intensity),
        pre_contrast=aug["aug_contrast"] & (aug["contrast_mode"] == 1),
        alpha=aug["alpha"],
        saturation=aug["aug_saturation"],
        s=aug["saturation"],
        hue=aug["aug_hue"],
        hue_m=_hue_matrix(aug["hue"]),
        post_contrast=aug["aug_contrast"] & (aug["contrast_mode"] == 0),
        swap=aug["aug_swap"],
        perm=torch.as_tensor(_CHANNEL_PERMS, device=aug["perm_index"].device)[
            aug["perm_index"].long()],
    )


def luma_of(is_bgr: bool) -> list:
    """Saturation's luma weights in the images' channel order."""
    return [float(v) for v in (_RGB_LUMA[::-1] if is_bgr else _RGB_LUMA)]


def distort(image: torch.Tensor, v: dict, is_uint8: bool, is_bgr: bool) -> torch.Tensor:
    """The distortion of one batch of ``(B, H, W, 3)`` images with the
    per-sample values ``v`` (:func:`sample_values`): uint8 images in,
    uint8 out (truncated), else [0, 1] floats. Every operation is a
    per-sample ``where``-select over the batch; the channel permutation is a
    batched gather."""
    img = image.to(torch.float32)
    if is_uint8:
        img = img * float(U8_INTENSITY)

    def sel(cond, new, old):
        return torch.where(_e(cond), new, old)

    img = sel(v["brightness"], torch.clamp(img + _e(v["delta"]), 0.0, 1.0), img)
    img = sel(v["pre_contrast"], torch.clamp(img * _e(v["alpha"]), 0.0, 1.0), img)
    img = sel(v["saturation"], _saturation(img, v["s"], luma_of(is_bgr)), img)
    img = sel(v["hue"], _hue_rotate(img, v["hue_m"], is_bgr), img)
    img = sel(v["post_contrast"], torch.clamp(img * _e(v["alpha"]), 0.0, 1.0), img)
    swapped = torch.gather(img, -1, v["perm"][:, None, None, :].expand(img.shape))
    img = sel(v["swap"], swapped, img)
    if is_uint8:
        return torch.clamp(img * 255.0, 0.0, 255.0).to(torch.uint8)
    return torch.clamp(img, 0.0, 1.0)


class PhotoMetricDistorter(PipelineStepBase):
    """Random photometric distortion with shared per-sample decisions."""

    placement = "device"

    def __init__(
        self,
        image_name: Union[str, int],
        min_max_brightness: Sequence[float],
        min_max_hue: Sequence[float],
        min_max_contrast: Sequence[float],
        min_max_saturation: Sequence[float],
        prob_brightness_aug: float = 0.5,
        prob_hue_aug: float = 0.5,
        prob_contrast_aug: float = 0.5,
        prob_saturation_aug: float = 0.5,
        prob_swap_channels: float = 0.5,
        is_bgr: bool = False,
        enforce_process_on_gpu: bool = True,  # parity arg; device placement is implied
    ):
        super().__init__()
        self._image_name = image_name
        self._min_max_brightness = tuple(min_max_brightness)
        self._min_max_hue = tuple(min_max_hue)
        self._min_max_contrast = tuple(min_max_contrast)
        self._min_max_saturation = tuple(min_max_saturation)
        self._prob_brightness = prob_brightness_aug
        self._prob_hue = prob_hue_aug
        self._prob_contrast = prob_contrast_aug
        self._prob_saturation = prob_saturation_aug
        self._prob_swap = prob_swap_channels
        self._is_bgr = is_bgr
        del enforce_process_on_gpu

    def _draw_decisions(self, bsz: int, device):
        """Fixed draw order (documented for ScriptedRandomContext tests, the
        same as the JAX step's): 5x uniform[0,1) gates, randint[0,2) contrast
        mode, then value draws (brightness, contrast, hue, saturation ranges),
        randint[0,6) perm. Every draw has shape ``(bsz,)``."""
        rng = self.random
        shape = (bsz,)

        def u(lo, hi):
            return batch_tensor(rng.uniform(lo, hi, shape), device).to(torch.float32)

        def rand_in_range(lo_hi):
            lo, hi = lo_hi
            if hi == lo:
                return torch.full(shape, float(np.float32(lo)), device=device)
            return u(lo, hi)

        aug_brightness = u(0.0, 1.0) < self._prob_brightness
        aug_contrast = u(0.0, 1.0) < self._prob_contrast
        aug_saturation = u(0.0, 1.0) < self._prob_saturation
        aug_hue = u(0.0, 1.0) < self._prob_hue
        aug_swap = u(0.0, 1.0) < self._prob_swap
        contrast_mode = batch_tensor(rng.randint(0, 2, shape), device)
        delta = rand_in_range(self._min_max_brightness)
        alpha = rand_in_range(self._min_max_contrast)
        hue = rand_in_range(self._min_max_hue)
        saturation = rand_in_range(self._min_max_saturation)
        perm_index = batch_tensor(rng.randint(0, 6, shape), device)
        return dict(
            aug_brightness=aug_brightness,
            aug_contrast=aug_contrast,
            aug_saturation=aug_saturation,
            aug_hue=aug_hue,
            aug_swap=aug_swap,
            contrast_mode=contrast_mode,
            delta=delta,
            alpha=alpha,
            hue=hue,
            saturation=saturation,
            perm_index=perm_index,
        )

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        paths = data.find_all_occurrences(self._image_name)
        first = data.get_item_in_path(paths[0])
        aug = self._draw_decisions(first.shape[0], first.device)
        for ip in paths:
            t = data.get_type_of_item_in_path(ip)
            assert t in (DType.FLOAT, DType.UINT8), f"Image type {t} not supported"
            is_uint8 = t == DType.UINT8
            image = distort(data.get_item_in_path(ip), sample_values(aug, is_uint8), is_uint8,
                            self._is_bgr)
            data.set_item_in_path(ip, image)
        return data

    def image_params(self, data: SampleDataGroup):
        """The batch's decisions drawn as :meth:`_process` draws them, as the
        per-sample values of uint8 images (:func:`sample_values`), and
        whether the images are BGR. No pixel is touched: this is the step's
        part of the fused image chain (:mod:`..image_chain`)."""
        first = data.get_item_in_path(data.find_all_occurrences(self._image_name)[0])
        aug = self._draw_decisions(first.shape[0], first.device)
        return sample_values(aug, True), self._is_bgr

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        if len(data_empty.find_all_occurrences(self._image_name)) == 0:
            raise KeyError(
                f"No occurrences of images found with name '{self._image_name}'."
            )
        return data_empty
