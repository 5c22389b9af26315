"""Image normalization steps (port of
``accvlab_tpu/pipeline/processing_steps/image_normalizers.py``).

Both steps are ``placement = "any"``: given a numpy image (one sample, on
the host side of the boundary) they compute in numpy, in the JAX package's
float32 order; given a torch tensor (the batch, on the device side) they
compute in torch. Both are elementwise per channel, so the batch dimension
changes nothing in their arithmetic.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from .pipeline_step_base import PipelineStepBase
from ..dtypes import DType, numpy_dtype_for, torch_dtype_for
from ..sample_data_group import SampleDataGroup


class ImageRange01Normalizer(PipelineStepBase):
    """Cast matching UINT8 images to FLOAT and scale to [0, 1]."""

    placement = "any"

    def __init__(self, image_name: Union[str, int]):
        super().__init__()
        self._image_name = image_name

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        for ip in data.find_all_occurrences(self._image_name):
            image = data.get_item_in_path(ip)
            if isinstance(image, torch.Tensor):
                image = image.to(torch.float32) * float(np.float32(1.0 / 255.0))
            else:
                image = np.asarray(image).astype(np.float32) * np.float32(1.0 / 255.0)
            data.change_type_of_data_and_remove_data(ip, DType.FLOAT)
            data.set_item_in_path(ip, image)
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
            data_empty.change_type_of_data_and_remove_data(ip, DType.FLOAT)
        return data_empty


class ImageMeanStdDevNormalizer(PipelineStepBase):
    """Normalize matching images: ``(image - mean) / std_dev`` per channel."""

    placement = "any"

    def __init__(
        self,
        image_name: Union[str, int],
        mean: Union[Sequence[float], float],
        std_dev: Union[Sequence[float], float],
        output_type: DType = DType.FLOAT,
    ):
        super().__init__()
        self._image_name = image_name
        self._output_type = output_type
        np_type = numpy_dtype_for(output_type)
        if not isinstance(mean, (Sequence, np.ndarray)):
            mean = [mean] * 3
        if not isinstance(std_dev, (Sequence, np.ndarray)):
            std_dev = [std_dev] * 3
        self._mean = np.asarray(mean, dtype=np_type)
        std = np.asarray(std_dev, dtype=np_type)
        assert np.all(std > 0), "std_dev entries must be > 0"
        self._inv_std = (1.0 / std).astype(np_type)

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        t_type = torch_dtype_for(self._output_type)
        np_type = numpy_dtype_for(self._output_type)
        for ip in data.find_all_occurrences(self._image_name):
            image = data.get_item_in_path(ip)
            if isinstance(image, torch.Tensor):
                mean = torch.as_tensor(self._mean, device=image.device)
                inv_std = torch.as_tensor(self._inv_std, device=image.device)
                image = ((image.to(t_type) - mean) * inv_std).to(t_type)
            else:
                image = ((np.asarray(image).astype(np_type) - self._mean) * self._inv_std
                         ).astype(np_type)
            data.change_type_of_data_and_remove_data(ip, self._output_type)
            data.set_item_in_path(ip, image)
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
            data_empty.change_type_of_data_and_remove_data(ip, self._output_type)
        return data_empty
