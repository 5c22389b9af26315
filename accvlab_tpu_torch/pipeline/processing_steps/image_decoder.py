"""Host step: decode encoded images, per sample (port of
``accvlab_tpu/pipeline/processing_steps/image_decoder.py``).

The port always decodes through PIL (libjpeg-turbo behind Pillow, which
releases the interpreter lock). The JAX package takes its own libjpeg
decoder first where that library builds, which decodes at libjpeg's M/8 DCT
scale and so differs from PIL's power-of-two draft scales; the port's
counterpart of that decoder waits for libjpeg on the card machine
(ROADMAP.md). There is one decoder here and nothing falls back between
decoders.
"""

from __future__ import annotations

import io
from typing import Union

import numpy as np

from .pipeline_step_base import PipelineStepBase
from ..dtypes import DType
from ..sample_data_group import SampleDataGroup
from ...color import subsample_chroma_420


class ImageDecoder(PipelineStepBase):
    """Decode all encoded-image fields with a given name, in place.

    Input fields hold the encoded file bytes as uint8 arrays; outputs are
    decoded uint8 HWC images (RGB, or BGR with ``as_bgr=True``), or with
    ``wire_format="yuv420"`` the planar uint8 Y ``(H, W)`` plus a sibling
    ``<image_name>_cbcr`` of 2x2-subsampled chroma ``(H/2, W/2, 2)``, to be
    turned into RGB on the device by :class:`YCbCrToRGBConverter`.

    ``decode_scale_hint_hw``: decode at the smallest PIL draft scale that
    covers this (height, width) and keep that size. ``decode_resize_hw``:
    decode (draft) and resize bilinearly to exactly this size. Geometry
    fields keep the original size. In the ``yuv420`` format odd decoded
    sizes are edge-replicated by one row or column to even before the
    chroma is subsampled.
    """

    placement = "host"

    def __init__(
        self,
        image_name: Union[str, int],
        as_bgr: bool = False,
        decode_scale_hint_hw=None,
        decode_resize_hw=None,
        wire_format: str = "rgb",
    ):
        super().__init__()
        if wire_format not in ("rgb", "yuv420"):
            raise ValueError(f"wire_format must be 'rgb' or 'yuv420', got {wire_format!r}")
        if wire_format == "yuv420":
            if as_bgr:
                raise ValueError(
                    "as_bgr with wire_format='yuv420': pass as_bgr to the "
                    "YCbCrToRGBConverter device step instead (the host never "
                    "produces RGB in this mode)"
                )
            if not isinstance(image_name, str):
                raise ValueError(
                    "wire_format='yuv420' needs a string image_name (the "
                    "chroma travels in a derived '<image_name>_cbcr' field)"
                )
            if decode_resize_hw is not None and (
                int(decode_resize_hw[0]) % 2 or int(decode_resize_hw[1]) % 2
            ):
                raise ValueError(
                    "wire_format='yuv420' needs an even decode_resize_hw "
                    f"(4:2:0 chroma is half-resolution), got {tuple(decode_resize_hw)}"
                )
        self._image_name = image_name
        self._as_bgr = as_bgr
        self._wire_format = wire_format
        self._scale_hint = tuple(decode_scale_hint_hw) if decode_scale_hint_hw else None
        self._resize_hw = tuple(decode_resize_hw) if decode_resize_hw else None

    @property
    def chroma_field_name(self) -> str:
        return f"{self._image_name}_cbcr"

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        from PIL import Image

        yuv = self._wire_format == "yuv420"
        mode = "YCbCr" if yuv else "RGB"
        for ip in data.find_all_occurrences(self._image_name):
            encoded = np.asarray(data.get_item_in_path(ip), dtype=np.uint8)
            img = Image.open(io.BytesIO(encoded.tobytes()))
            target = self._resize_hw or self._scale_hint
            if target is not None:
                # DCT-domain scaled decode straight to the target colour space
                img.draft(mode, (target[1], target[0]))
            if img.mode != mode:
                img = img.convert(mode)
            if self._resize_hw is not None and img.size != (self._resize_hw[1],
                                                            self._resize_hw[0]):
                img = img.resize((self._resize_hw[1], self._resize_hw[0]), Image.BILINEAR)
            decoded = np.asarray(img, dtype=np.uint8)
            if yuv:
                hgt, wid = decoded.shape[:2]
                if (hgt | wid) & 1:
                    # 4:2:0 needs even sizes: replicate the last row/column
                    decoded = np.pad(decoded, ((0, hgt & 1), (0, wid & 1), (0, 0)), mode="edge")
                y, cbcr = subsample_chroma_420(decoded)
                data.set_item_in_path(ip, y)
                parent = data.get_parent_of_path(list(ip))
                if not parent.path_exists(self.chroma_field_name):
                    parent.add_data_field(self.chroma_field_name, DType.UINT8)
                parent[self.chroma_field_name] = cbcr
            else:
                if self._as_bgr:
                    decoded = decoded[..., ::-1]
                data.set_item_in_path(ip, decoded)
        return data

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        paths = data_empty.find_all_occurrences(self._image_name)
        if len(paths) == 0:
            raise KeyError(
                f"No occurrences of images found. Fields containing images are "
                f"expected to have the name '{self._image_name}'."
            )
        for ip in paths:
            t = data_empty.get_type_of_item_in_path(ip)
            if t != DType.UINT8:
                raise TypeError(f"Encoded image field at {ip} must be UINT8, got {t}")
            if self._wire_format == "yuv420":
                parent = data_empty.get_parent_of_path(list(ip))
                if parent.path_exists(self.chroma_field_name):
                    raise KeyError(
                        f"wire_format='yuv420' adds a '{self.chroma_field_name}' "
                        "field but one already exists"
                    )
                parent.add_data_field(self.chroma_field_name, DType.UINT8)
        return data_empty
