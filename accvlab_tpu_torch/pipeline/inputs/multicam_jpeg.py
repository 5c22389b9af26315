"""Synthetic multi-camera dataset of the headline benchmark, as JPEG.

``bench.py``'s ``build_dataset`` (``bench.py:44-127``) on the port's
classes: ``num_unique * num_cams`` frames of structured noise (uniform bytes
on a 1/8-size grid from ``default_rng(0)``, upsampled with PIL's
``BILINEAR``), each encoded by PIL as JPEG quality 90, cycled over the
samples; per-sample boxes drawn as bench.py draws them
(:func:`multicam_synthetic.sample_boxes`). The JPEG bytes are those that
bench.py's recipe encodes for the same size.

The encoded frames can be kept on disk in bench.py's cache format
(``bench_jpegs_<n>_<H>x<W>_q90.npz`` with arrays ``j0``, ``j1``, ...):
pass ``cache_dir`` (:func:`bench_cache_dir` is bench.py's own directory).
Without it nothing is read or written.
"""

from __future__ import annotations

import io
import os
from typing import List, Optional, Tuple

import numpy as np

from ..dtypes import DType
from ..sample_data_group import SampleDataGroup
from .base import DataProvider
from .multicam_synthetic import fill_sample, sample_structure

JPEG_QUALITY = 90


def bench_cache_dir() -> str:
    """The directory of bench.py's JPEG cache: ``$XDG_CACHE_HOME/accvlab``,
    else ``~/.cache/accvlab``."""
    root = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return os.path.join(root, "accvlab")


def cache_file(cache_dir: str, num_jpegs: int, hw: Tuple[int, int]) -> str:
    return os.path.join(cache_dir, f"bench_jpegs_{num_jpegs}_{hw[0]}x{hw[1]}_q{JPEG_QUALITY}.npz")


def encode_bench_jpegs(num_jpegs: int, hw: Tuple[int, int]) -> List[np.ndarray]:
    """bench.py's frames (``default_rng(0)``), encoded: a list of uint8
    arrays of JPEG bytes."""
    from PIL import Image

    rng = np.random.default_rng(0)
    out = []
    for _ in range(num_jpegs):
        base = rng.integers(0, 255, (hw[0] // 8, hw[1] // 8, 3), np.uint8)
        img = np.asarray(Image.fromarray(base).resize((hw[1], hw[0]), Image.BILINEAR), np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=JPEG_QUALITY)
        out.append(np.frombuffer(buf.getvalue(), np.uint8).copy())
    return out


def bench_jpegs(num_jpegs: int, hw: Tuple[int, int], cache_dir: Optional[str] = None
                ) -> List[np.ndarray]:
    """:func:`encode_bench_jpegs` through bench.py's disk cache
    in ``cache_dir`` when one is given (read if present, else written)."""
    if cache_dir is None:
        return encode_bench_jpegs(num_jpegs, hw)
    path = cache_file(cache_dir, num_jpegs, hw)
    if os.path.exists(path):
        with np.load(path) as z:
            return [z[f"j{i}"] for i in range(num_jpegs)]
    jpegs = encode_bench_jpegs(num_jpegs, hw)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.npz"  # .npz: savez keeps the name
    np.savez(tmp, **{f"j{i}": j for i, j in enumerate(jpegs)})
    os.replace(tmp, path)
    return jpegs


class MultiCameraJpegProvider(DataProvider):
    """bench.py's ``DataProvider``: ``num_unique`` distinct sets of
    ``num_cams`` JPEG frames, cycled over ``num_samples`` samples, each
    camera with ``max_objects`` boxes of ``num_classes`` classes and its
    original size in ``image_hw``."""

    def __init__(self, num_samples: int = 6400, num_unique: int = 16,
                 hw: Tuple[int, int] = (372, 1024), num_cams: int = 6,
                 max_objects: int = 32, num_classes: int = 10,
                 cache_dir: Optional[str] = None):
        self._hw = tuple(hw)
        self._num_samples = num_samples
        self._num_cams = num_cams
        self._max_objects = max_objects
        self._num_classes = num_classes
        self._jpegs = bench_jpegs(num_unique * num_cams, self._hw, cache_dir)

    @property
    def sample_data_structure(self) -> SampleDataGroup:
        return sample_structure(SampleDataGroup, DType, self._num_cams)

    def get_data(self, sample_index: int) -> SampleDataGroup:
        return fill_sample(self.sample_data_structure, self._jpegs, sample_index,
                           self._num_cams, self._hw, self._max_objects, self._num_classes)

    def get_number_of_samples(self) -> int:
        return self._num_samples

    def jpeg(self, sample_index: int, cam: int = 0) -> np.ndarray:
        """The JPEG bytes of camera ``cam`` in sample ``sample_index``, as
        :meth:`get_data` fills them (without drawing the boxes)."""
        return self._jpegs[(sample_index * self._num_cams + cam) % len(self._jpegs)]
