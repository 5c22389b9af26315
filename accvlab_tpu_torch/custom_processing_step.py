"""Template: writing a custom processing step for the port.

The counterpart of ``examples/custom_processing_step.py``. A step
implements two methods:

* ``_check_and_adjust_data_format_input_to_output`` — validate the input
  blueprint, return the output blueprint (construction time, free per batch);
* ``_process`` — transform the data. A host step (``placement = "host"``)
  gets ONE sample's numpy arrays; a device step gets the whole batch's
  tensors, with a leading batch dimension, and draws its randomness with
  ``shape=(batch,)``. With ``placement = "any"`` the step runs on either
  side of the host/device boundary, so it handles both forms: numpy values
  take the numpy path, tensors the torch path, as below.

Run:  python -m accvlab_tpu_torch.custom_processing_step
"""

from __future__ import annotations

import numpy as np
import torch

from .pipeline import DType, SampleDataGroup
from .pipeline.processing_steps import PipelineStepBase

_LUMA = (0.299, 0.587, 0.114)


class GrayscaleConverter(PipelineStepBase):
    """Convert matching RGB images to single-channel grayscale, times a
    random gain drawn per sample from the injected RandomContext.

    Demonstrates: field search by name, dtype change, randomness injection,
    and the two forms of an ``"any"`` step."""

    placement = "any"

    def __init__(self, image_name, random_gain_range=None):
        super().__init__()
        self._image_name = image_name
        self._gain_range = random_gain_range

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        for path in data.find_all_occurrences(self._image_name):
            image = data.get_item_in_path(path)
            if isinstance(image, torch.Tensor):  # the batch, (B, H, W, 3)
                luma = torch.tensor(_LUMA, dtype=torch.float32, device=image.device)
                gray = image.to(torch.float32) @ luma
                if self._gain_range is not None:
                    gain = self.random.uniform(*self._gain_range, shape=(image.shape[0],))
                    gain = torch.as_tensor(gain, dtype=torch.float32, device=image.device)
                    gray = gray * gain[:, None, None]
            else:  # one sample, (H, W, 3)
                gray = np.asarray(image).astype(np.float32) @ np.asarray(_LUMA, np.float32)
                if self._gain_range is not None:
                    gray = gray * self.random.uniform(*self._gain_range)
            data.change_type_of_data_and_remove_data(path, DType.FLOAT)
            data.set_item_in_path(path, gray[..., None])
        return data

    def _check_and_adjust_data_format_input_to_output(self, data_empty):
        paths = data_empty.find_all_occurrences(self._image_name)
        if not paths:
            raise KeyError(f"No image fields named '{self._image_name}' found")
        for path in paths:
            data_empty.change_type_of_data_and_remove_data(path, DType.FLOAT)
        return data_empty


def main():
    from .pipeline import ScriptedRandomContext

    step = GrayscaleConverter("image", random_gain_range=(0.5, 1.5))
    rng = ScriptedRandomContext()
    rng.script_uniform(0.5, 1.5, [1.0, 1.0])
    step.set_random_context(rng)

    sdg = SampleDataGroup()
    sdg.add_data_field("image", DType.UINT8)
    sdg["image"] = np.full((4, 6, 3), 100, np.uint8)  # one sample, host form
    out = step(sdg)  # __call__ also validates the advertised output format
    print("host:  ", out["image"].shape, out["image"].dtype, float(out["image"][0, 0, 0]),
          "(expect 100.0)")

    batch = SampleDataGroup()
    batch.add_data_field("image", DType.UINT8)
    batch["image"] = torch.full((2, 4, 6, 3), 100, dtype=torch.uint8)  # a batch of 2
    out = step(batch)
    print("device:", tuple(out["image"].shape), out["image"].dtype,
          float(out["image"][0, 0, 0, 0]), "(expect 100.0)")


if __name__ == "__main__":
    main()
