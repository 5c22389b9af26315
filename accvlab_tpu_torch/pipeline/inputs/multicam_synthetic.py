"""Synthetic multi-camera dataset of the headline benchmark, as raw frames.

``bench.py`` (``build_dataset``, ``bench.py:44-127``) synthesizes 6 cameras
of 1024x372 frames per sample, each with 32 boxes of 10 classes, and ships
them as JPEG for the host decoder. The PyTorch port's headline pipeline
takes raw RGB frames instead (the DCT/JPEG wire needs libjpeg on the host,
see ROADMAP.md), so this module makes the same content without an encoder:

* frames: bench.py's structured noise — uniform bytes on a 1/8-size grid,
  upsampled bilinearly (half-pixel centres) to the frame size;
* boxes: bench.py's per-sample draws, bit for bit (``default_rng(index)``).

Everything is numpy from a seed, so the JAX package and the port can be fed
identical samples.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..dtypes import DType
from ..sample_data_group import SampleDataGroup
from .base import DataProvider


def _upsample_axis(a: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    n_in = a.shape[axis]
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    pos = np.clip(pos, 0.0, n_in - 1)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w = (pos - i0).astype(np.float32)
    shape = [1] * a.ndim
    shape[axis] = n_out
    w = w.reshape(shape)
    return np.take(a, i0, axis=axis) * (1.0 - w) + np.take(a, i1, axis=axis) * w


def structured_noise_frames(num_frames: int, hw: Tuple[int, int], seed: int = 0) -> List[np.ndarray]:
    """``num_frames`` uint8 ``(H, W, 3)`` frames of upsampled 1/8-grid noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    frames = []
    for _ in range(num_frames):
        base = rng.integers(0, 255, (h // 8, w // 8, 3), np.uint8).astype(np.float32)
        up = _upsample_axis(_upsample_axis(base, h, 0), w, 1)
        frames.append(np.clip(np.rint(up), 0, 255).astype(np.uint8))
    return frames


def sample_boxes(sample_index: int, num_cams: int, hw: Tuple[int, int], max_objects: int,
                 num_classes: int):
    """bench.py's per-camera box draws for one sample: a list of
    ``(bboxes (N, 4) float32, categories (N,) int32)`` per camera."""
    srng = np.random.default_rng(sample_index)
    out = []
    for _ in range(num_cams):
        x1 = srng.uniform(0, hw[1] - 40, (max_objects,))
        y1 = srng.uniform(0, hw[0] - 40, (max_objects,))
        bw = srng.uniform(10, 200, (max_objects,))
        bh = srng.uniform(10, 120, (max_objects,))
        boxes = np.stack([x1, y1, x1 + bw, y1 + bh], axis=1).astype(np.float32)
        cats = srng.integers(0, num_classes, (max_objects,)).astype(np.int32)
        out.append((boxes, cats))
    return out


def sample_structure(sdg_cls, dtype_cls, num_cams: int):
    """The headline sample blueprint (cameras[c].{image, image_hw,
    annotations.{bboxes, categories}}), built from the given package's
    ``SampleDataGroup`` and ``DType`` classes."""
    cam = sdg_cls()
    cam.add_data_field("image", dtype_cls.UINT8)
    cam.add_data_field("image_hw", dtype_cls.INT32)  # original size (metadata)
    ann = sdg_cls()
    ann.add_data_field("bboxes", dtype_cls.FLOAT)
    ann.add_data_field("categories", dtype_cls.INT32)
    cam.add_data_group_field("annotations", ann)
    root = sdg_cls()
    root.add_data_group_field_array("cameras", cam, num_cams)
    return root


def fill_sample(sdg, frames, sample_index: int, num_cams: int, hw, max_objects: int,
                num_classes: int):
    """Fill a blueprint from :func:`sample_structure` with sample ``sample_index``."""
    boxes = sample_boxes(sample_index, num_cams, hw, max_objects, num_classes)
    for c in range(num_cams):
        cam = sdg["cameras"][c]
        cam["image"] = frames[(sample_index * num_cams + c) % len(frames)]
        cam["image_hw"] = np.asarray(hw, np.int32)
        cam["annotations"]["bboxes"] = boxes[c][0]
        cam["annotations"]["categories"] = boxes[c][1]
    return sdg


class MultiCameraSyntheticProvider(DataProvider):
    """bench.py's ``DataProvider`` with raw frames: ``num_unique`` distinct
    frame sets of ``num_cams`` cameras, cycled over ``num_samples`` samples."""

    def __init__(self, num_samples: int = 6400, num_unique: int = 2,
                 hw: Tuple[int, int] = (372, 1024), num_cams: int = 6,
                 max_objects: int = 32, num_classes: int = 10, seed: int = 0):
        self._hw = tuple(hw)
        self._num_samples = num_samples
        self._num_cams = num_cams
        self._max_objects = max_objects
        self._num_classes = num_classes
        self._frames = structured_noise_frames(num_unique * num_cams, self._hw, seed)

    @property
    def sample_data_structure(self) -> SampleDataGroup:
        return sample_structure(SampleDataGroup, DType, self._num_cams)

    def get_data(self, sample_index: int) -> SampleDataGroup:
        return fill_sample(self.sample_data_structure, self._frames, sample_index,
                           self._num_cams, self._hw, self._max_objects, self._num_classes)

    def get_number_of_samples(self) -> int:
        return self._num_samples
