"""The inputs of a run, made from ``--seed`` by the benchmark itself.

Both sides get the same arrays: the program through :func:`provider`, a
data provider of the port's pipeline, and the reference directly.

* frames: ``num_unique`` sets of ``num_cams`` uint8 RGB frames of
  ``frame_hw``, uniform bytes; sample ``i`` shows set ``i % num_unique``;
* boxes: bench.py's per-camera draws (``x1`` in ``[0, W - 40)``, ``y1`` in
  ``[0, H - 40)``, width in ``[10, 200)``, height in ``[10, 120)``, class in
  ``[0, num_classes)``), made for every sample at once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def substream(seed: int, purpose: int) -> np.random.Generator:
    """An independent numpy stream of ``seed`` for one purpose."""
    return np.random.default_rng([int(seed), int(purpose)])


def seed63(seed: int, purpose: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` from ``seed`` and a purpose."""
    state = np.random.SeedSequence([int(seed), int(purpose)]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


@dataclass
class Inputs:
    frames: np.ndarray  # (num_unique * num_cams, H, W, 3) uint8
    boxes: np.ndarray  # (num_samples, num_cams, T, 4) float32, x1 y1 x2 y2
    categories: np.ndarray  # (num_samples, num_cams, T) int32
    num_cams: int

    @property
    def num_unique(self) -> int:
        return self.frames.shape[0] // self.num_cams

    def frame(self, sample: int, cam: int) -> np.ndarray:
        return self.frames[(sample % self.num_unique) * self.num_cams + cam]


def make_inputs(seed: int, config: dict, traffic: dict) -> Inputs:
    cams = int(config["num_cams"])
    h, w = config["frame_hw"]
    n, t = int(traffic["num_samples"]), int(config["max_objects"])
    frames = substream(seed, 1).integers(0, 256, (traffic["num_unique"] * cams, h, w, 3),
                                         dtype=np.uint8)
    rng = substream(seed, 2)
    x1 = rng.uniform(0, w - 40, (n, cams, t))
    y1 = rng.uniform(0, h - 40, (n, cams, t))
    bw = rng.uniform(10, 200, (n, cams, t))
    bh = rng.uniform(10, 120, (n, cams, t))
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], axis=-1).astype(np.float32)
    categories = rng.integers(0, config["num_classes"], (n, cams, t)).astype(np.int32)
    return Inputs(frames, boxes, categories, cams)


def provider(inputs: Inputs, config: dict):
    """A data provider of the port's pipeline over ``inputs``: sample ``i``
    is ``cameras[c].{image, image_hw, annotations.{bboxes, categories}}``."""
    from accvlab_tpu_torch.pipeline import DType, SampleDataGroup
    from accvlab_tpu_torch.pipeline.inputs import DataProvider

    hw = np.asarray(config["frame_hw"], np.int32)

    def structure() -> SampleDataGroup:
        cam = SampleDataGroup()
        cam.add_data_field("image", DType.UINT8)
        cam.add_data_field("image_hw", DType.INT32)
        ann = SampleDataGroup()
        ann.add_data_field("bboxes", DType.FLOAT)
        ann.add_data_field("categories", DType.INT32)
        cam.add_data_group_field("annotations", ann)
        root = SampleDataGroup()
        root.add_data_group_field_array("cameras", cam, inputs.num_cams)
        return root

    class SeededCameras(DataProvider):
        @property
        def sample_data_structure(self) -> SampleDataGroup:
            return structure()

        def get_data(self, sample_index: int) -> SampleDataGroup:
            sdg = structure()
            for c in range(inputs.num_cams):
                cam = sdg["cameras"][c]
                cam["image"] = inputs.frame(sample_index, c)
                cam["image_hw"] = hw
                cam["annotations"]["bboxes"] = inputs.boxes[sample_index, c]
                cam["annotations"]["categories"] = inputs.categories[sample_index, c]
            return sdg

        def get_number_of_samples(self) -> int:
            return inputs.boxes.shape[0]

    return SeededCameras()
