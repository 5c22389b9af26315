"""Host step: decode encoded images, per sample (port of
``accvlab_tpu/pipeline/processing_steps/image_decoder.py``).

Two decoders, chosen by ``decoder=`` and counted in ``decoded_by``:

* ``"native"``: the port's copy of the JAX package's libjpeg decoder
  (:mod:`..native_jpeg`). It decodes at libjpeg's M/8 DCT scale (6/8 for
  1024 -> 704) and resamples to the target itself, straight into the wire
  layout; an image it cannot take raises;
* ``"pil"`` (the default): Pillow, at its power-of-two draft scales, then a
  bilinear resize;
* ``"auto"``: the JAX package's rule, image by image
  (``image_decoder.py:121-190``): native for a JPEG whose sizes suit it,
  when the library builds, and PIL for the rest (PNG and other formats, an
  odd yuv420 size without an even ``decode_resize_hw``, a scale hint on the
  yuv420 wire, CMYK).
"""

from __future__ import annotations

import io
import threading
from typing import Union

import numpy as np

from .pipeline_step_base import PipelineStepBase
from .. import native_jpeg
from ..dtypes import DType
from ..sample_data_group import SampleDataGroup
from ...color import subsample_chroma_420

# host steps run on a thread pool over shared step objects; a lock in the
# instance would keep the step from pickling
_COUNT_LOCK = threading.Lock()


class ImageDecoder(PipelineStepBase):
    """Decode all encoded-image fields with a given name, in place.

    Input fields hold the encoded file bytes as uint8 arrays; outputs are
    decoded uint8 HWC images (RGB, or BGR with ``as_bgr=True``), or with
    ``wire_format="yuv420"`` the planar uint8 Y ``(H, W)`` plus a sibling
    ``<image_name>_cbcr`` of 2x2-subsampled chroma ``(H/2, W/2, 2)``, to be
    turned into RGB on the device by :class:`YCbCrToRGBConverter`.

    ``decode_scale_hint_hw``: decode at the smallest DCT scale that covers
    this (height, width) and keep that size. ``decode_resize_hw``: decode at
    a DCT scale and resize bilinearly to exactly this size. Geometry fields
    keep the original size. In the ``yuv420`` format odd decoded sizes are
    edge-replicated by one row or column to even before the chroma is
    subsampled (PIL path).

    ``use_device_mixed`` and ``hw_decoder_load`` (DALI's mixed nvJPEG
    decode) are taken in the JAX package's positions and ignored, as it
    ignores them: decoding runs on the host.

    ``decoder``: ``"pil"``, ``"native"`` or ``"auto"`` (module docstring).
    ``"native"`` raises at construction when the library does not build.
    ``decoded_by`` counts the images each decoder took.
    """

    placement = "host"

    def __init__(
        self,
        image_name: Union[str, int],
        use_device_mixed: bool = False,
        hw_decoder_load: float = 0.65,
        as_bgr: bool = False,
        decode_scale_hint_hw=None,
        decode_resize_hw=None,
        wire_format: str = "rgb",
        decoder: str = "pil",
    ):
        super().__init__()
        if decoder not in ("auto", "native", "pil"):
            raise ValueError(f"decoder must be 'auto', 'native' or 'pil', got {decoder!r}")
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
        if decoder == "native":
            if wire_format == "yuv420" and self._scale_hint is not None:
                raise ValueError("decoder='native' on the yuv420 wire takes decode_resize_hw, "
                                 "not decode_scale_hint_hw")
            if not native_jpeg.available():
                raise RuntimeError(f"decoder='native': {native_jpeg.build_error()}")
        self._decoder = decoder
        del use_device_mixed, hw_decoder_load  # the host decodes
        #: images decoded by each decoder since construction
        self.decoded_by = {"native": 0, "pil": 0}

    @property
    def chroma_field_name(self) -> str:
        return f"{self._image_name}_cbcr"

    def _set_yuv_fields(self, data, ip, y, cbcr):
        data.set_item_in_path(ip, y)
        parent = data.get_parent_of_path(list(ip))
        if not parent.path_exists(self.chroma_field_name):
            parent.add_data_field(self.chroma_field_name, DType.UINT8)
        parent[self.chroma_field_name] = cbcr

    def _native(self, data, ip, encoded: np.ndarray) -> bool:
        """Decode one image natively where ``decoder`` and the JAX package's
        rule (``image_decoder.py:121-176``) say so; returns whether it did.
        With ``decoder="native"`` an image the rule sends to PIL raises."""
        if self._decoder == "pil" or (self._decoder == "auto" and not native_jpeg.available()):
            return False
        yuv = self._wire_format == "yuv420"
        if yuv and self._scale_hint is not None:
            reason = "a scale hint on the yuv420 wire"
        elif encoded.nbytes < 3 or encoded[0] != 0xFF or encoded[1] != 0xD8:
            reason = "not a JPEG"
        else:
            try:
                if self._resize_hw is not None:
                    target = self._resize_hw
                elif self._scale_hint is not None:
                    target = native_jpeg.scaled_size(native_jpeg.probe(encoded), self._scale_hint)
                else:
                    target = native_jpeg.probe(encoded)
                if yuv and (target[0] | target[1]) & 1:
                    reason = f"odd size {tuple(target)} on the yuv420 wire"
                elif yuv:
                    self._set_yuv_fields(data, ip, *native_jpeg.decode_yuv420(encoded, target))
                    return True
                else:
                    data.set_item_in_path(ip, native_jpeg.decode_rgb(encoded, target,
                                                                     self._as_bgr))
                    return True
            except ValueError as e:  # a header or colour space libjpeg does not take
                reason = str(e)
        if self._decoder == "native":
            raise ValueError(f"ImageDecoder(decoder='native') cannot decode this image: {reason}")
        return False

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        from PIL import Image

        yuv = self._wire_format == "yuv420"
        mode = "YCbCr" if yuv else "RGB"
        for ip in data.find_all_occurrences(self._image_name):
            encoded = np.asarray(data.get_item_in_path(ip), dtype=np.uint8)
            if self._native(data, ip, encoded):
                self._count("native")
                continue
            self._count("pil")
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
                self._set_yuv_fields(data, ip, *subsample_chroma_420(decoded))
            else:
                if self._as_bgr:
                    decoded = decoded[..., ::-1]
                data.set_item_in_path(ip, decoded)
        return data

    def _count(self, decoder: str) -> None:
        with _COUNT_LOCK:
            self.decoded_by[decoder] += 1

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
