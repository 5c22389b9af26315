"""Device step: YCbCr 4:2:0 -> RGB, batched (port of
``accvlab_tpu/pipeline/processing_steps/color_converter.py``).

:class:`ImageDecoder` with ``wire_format="yuv420"`` ships planar Y plus
subsampled CbCr over the host-to-device copy (1.5 bytes per pixel); this
step, the first device step that touches the image, upsamples the chroma,
applies the colour matrix and rounds, so later steps see the uint8 HWC RGB
(or BGR) they always did. The batch dimension changes nothing in its
arithmetic.
"""

from __future__ import annotations

from typing import Union

from .pipeline_step_base import PipelineStepBase
from ..dtypes import DType
from ..sample_data_group import SampleDataGroup
from ...color import ycbcr420_to_rgb, ycbcr_coefficients


class YCbCrToRGBConverter(PipelineStepBase):
    """Convert ``image_name`` (uint8 Y, ``(B, H, W)``) and its
    ``<image_name>_cbcr`` sibling (uint8 ``(B, H/2, W/2, 2)``) into a uint8
    ``(B, H, W, 3)`` RGB image, removing the chroma field.

    Defaults follow JPEG (BT.601, full range); video frames typically need
    ``color_range="limited"`` (and ``matrix="bt709"`` for HD content).
    """

    # "device", not "any": an "any" step ahead of the first device step would
    # run in the host stage and convert to RGB before the copy, doubling the
    # bytes this step exists to save
    placement = "device"

    def __init__(
        self,
        image_name: Union[str, int],
        matrix: str = "bt601",
        color_range: str = "full",
        as_bgr: bool = False,
    ):
        super().__init__()
        if not isinstance(image_name, str):
            raise ValueError("YCbCrToRGBConverter needs a string image_name")
        ycbcr_coefficients(matrix, color_range)  # validate at construction
        self._image_name = image_name
        self._chroma_name = f"{image_name}_cbcr"
        self._matrix = matrix
        self._color_range = color_range
        self._as_bgr = as_bgr

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        for ip in data.find_all_occurrences(self._image_name):
            parent = data.get_parent_of_path(list(ip))
            y = data.get_item_in_path(ip)
            rgb = ycbcr420_to_rgb(y, parent[self._chroma_name], matrix=self._matrix,
                                  color_range=self._color_range)
            if self._as_bgr:
                rgb = rgb.flip(-1)
            parent.remove_field(self._chroma_name)
            data.set_item_in_path(ip, rgb)
        return data

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        paths = data_empty.find_all_occurrences(self._image_name)
        if len(paths) == 0:
            raise KeyError(
                f"No occurrences of images found with name '{self._image_name}'."
            )
        for ip in paths:
            parent = data_empty.get_parent_of_path(list(ip))
            for name in (ip[-1], self._chroma_name):
                if not parent.path_exists(name):
                    raise KeyError(
                        f"YCbCrToRGBConverter expects a '{name}' field next to "
                        f"the image at {ip} (produced by ImageDecoder with "
                        "wire_format='yuv420')"
                    )
                t = parent.get_type_of_field(name)
                if t != DType.UINT8:
                    raise TypeError(f"Field '{name}' at {ip} must be UINT8, got {t}")
            parent.remove_field(self._chroma_name)
        return data_empty
