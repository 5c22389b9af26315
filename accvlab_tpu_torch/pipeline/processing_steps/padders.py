"""Padding steps (port of ``accvlab_tpu/pipeline/processing_steps/padders.py``;
host steps, numpy, the JAX package's code).

``ImageToTileSizePadder`` pads each image so H and W are tile multiples;
``PaddingToUniform`` pads fields to the per-batch maximum shape. They make
the shapes uniform at the host/device boundary: the device steps after them
take batched tensors.
"""

from __future__ import annotations

from collections.abc import Sequence as ABCSequence
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ._common import as_name_list
from .pipeline_step_base import BatchLevelStepBase, PipelineStepBase
from ..sample_data_group import SampleDataGroup

Name = Union[str, int]


class ImageToTileSizePadder(PipelineStepBase):
    """Right/bottom-pad each image so H and W are multiples of the tile size.

    Runs on the host (input image sizes may vary per sample).
    """

    placement = "host"

    def __init__(
        self,
        image_name: Name,
        tile_size_to_pad_to: Union[int, Sequence[int]],
    ):
        super().__init__()
        self._image_name = image_name
        self._tile = (
            list(tile_size_to_pad_to)
            if isinstance(tile_size_to_pad_to, ABCSequence)
            else [tile_size_to_pad_to, tile_size_to_pad_to]
        )
        assert self._tile[0] > 0 and self._tile[1] > 0, (
            "Tile size must be greater than 0. To retain the original image "
            "size, use tile size 1."
        )

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        for ip in data.find_all_occurrences(self._image_name):
            image = np.asarray(data.get_item_in_path(ip))
            h, w = image.shape[0], image.shape[1]
            th = (h + self._tile[0] - 1) // self._tile[0] * self._tile[0]
            tw = (w + self._tile[1] - 1) // self._tile[1] * self._tile[1]
            if (th, tw) != (h, w):
                pad = [(0, th - h), (0, tw - w)] + [(0, 0)] * (image.ndim - 2)
                image = np.pad(image, pad)
            data.set_item_in_path(ip, image)
        return data

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        if len(data_empty.find_all_occurrences(self._image_name)) == 0:
            raise KeyError(
                f"No occurrences of images found with name '{self._image_name}'."
            )
        return data_empty


class PaddingToUniform(BatchLevelStepBase):
    """Pad selected fields (or all data fields) to the per-batch maximum
    shape, filling with ``fill_value``.

    Batch-level host step: it needs the whole batch to know the target shape
    (the reference's DALI graph sees whole batches implicitly).
    """

    def __init__(
        self,
        field_names: Optional[Union[Name, List[Name], Tuple[Name, ...]]] = None,
        fill_value: Union[int, float] = 0.0,
        size_buckets: Optional[Sequence[int]] = None,
        bucket_dims: Optional[Sequence[int]] = None,
    ):
        """``size_buckets``: optional ascending sizes; the per-batch maximum
        of each padded dimension is rounded UP to the next bucket, which
        bounds the number of distinct batch shapes the device steps see.

        ``bucket_dims``: dimensions the buckets apply to (default: all).
        Restrict this to the RAGGED axes — e.g. ``bucket_dims=(0,)`` for
        ``(num_objects, 4)`` boxes; otherwise the fixed coordinate dim 4
        would also round up to the nearest bucket, silently inflating the
        field with fill values. Pair with :func:`optimize_size_buckets` to
        choose the bucket values from observed sizes."""
        super().__init__()
        self._field_names = as_name_list(field_names)
        self._fill_value = fill_value
        self._size_buckets = sorted(size_buckets) if size_buckets else None
        self._bucket_dims = (
            frozenset(int(d) for d in bucket_dims) if bucket_dims is not None
            else None
        )

    def _bucketed(self, size: int, dim: int) -> int:
        if self._size_buckets is None:
            return size
        if self._bucket_dims is not None and dim not in self._bucket_dims:
            return size
        for b in self._size_buckets:
            if size <= b:
                return b
        return size  # beyond the largest bucket: exact

    def _target_paths(self, sample: SampleDataGroup):
        if self._field_names is None:
            # all data-field leaves
            paths = []

            def recurse(group, prefix):
                for name in group.contained_top_level_field_names:
                    if group.is_data_group_field(name):
                        recurse(group[name], prefix + (name,))
                    else:
                        paths.append(prefix + (name,))

            recurse(sample, ())
            return paths
        paths = []
        for fnm in self._field_names:
            for pth in sample.find_all_occurrences(fnm):
                if sample.path_exists_and_is_data_group_field(pth):
                    # data-field arrays: pad each element
                    group = sample.get_item_in_path(pth)
                    for name in group.contained_top_level_field_names:
                        if group.is_data_field(name):
                            paths.append(tuple(pth) + (name,))
                else:
                    paths.append(tuple(pth))
        return paths

    def _process_batch(self, samples: List[SampleDataGroup]) -> List[SampleDataGroup]:
        if not samples:
            return samples
        for path in self._target_paths(samples[0]):
            arrs = [np.atleast_1d(np.asarray(s.get_item_in_path(list(path)))) for s in samples]
            ndim = max(a.ndim for a in arrs)
            arrs = [a.reshape(a.shape + (1,) * (ndim - a.ndim)) for a in arrs]
            target = tuple(
                self._bucketed(max(a.shape[d] for a in arrs), d) for d in range(ndim)
            )
            for s, a in zip(samples, arrs):
                pad = [(0, target[d] - a.shape[d]) for d in range(ndim)]
                if any(p[1] for p in pad):
                    a = np.pad(a, pad, constant_values=self._fill_value)
                s.set_item_in_path(list(path), a)
        return samples

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        if self._field_names is not None:
            for fnm in self._field_names:
                if len(data_empty.find_all_occurrences(fnm)) == 0:
                    raise KeyError(f"No occurrences of field '{fnm}' found.")
        return data_empty


def optimize_size_buckets(sizes, max_buckets, weights=None):
    """Exactly-optimal padding buckets for ragged sizes under a budget of
    distinct shapes: with at most ``max_buckets`` distinct padded sizes,
    choose the bucket values that minimize total padding waste
    ``sum_i w_i * (bucket(size_i) - size_i)``.

    ``PaddingToUniform(size_buckets=...)`` bounds the number of distinct
    batch shapes, but hand-picked buckets over-pad. Observed sizes
    (a sample of your dataset's sequence lengths / object counts / image
    dims) pin the trade exactly: any optimal bucket set uses only observed
    values (lowering a bucket to the largest size it serves never hurts),
    so a 1-D k-segmentation DP over the sorted distinct sizes is exact —
    the same shape of argument as the DCT wire's ``optimize_band_groups``.

    Args:
        sizes: observed sizes (any iterable of non-negative ints).
        max_buckets: maximum number of distinct padded sizes (>= 1).
        weights: optional per-size weights (e.g. observation counts when
            ``sizes`` are unique values; cost of a padded element). Defaults
            to 1 per entry.

    Returns:
        Ascending list of bucket sizes (the last is ``max(sizes)``), of
        length ``min(max_buckets, #distinct sizes)``.
    """
    raw = np.asarray(list(sizes))
    if raw.size == 0:
        raise ValueError("optimize_size_buckets needs at least one size")
    sizes = raw.astype(np.int64)
    # fail loudly on non-integer inputs (e.g. percentile statistics): a
    # silently truncated max bucket would sit BELOW real observed sizes and
    # the padder would fall past it, one new shape per novel size
    if not np.array_equal(sizes, raw):
        raise ValueError(
            "sizes must be integers (got non-integer values — pass raw "
            "observed sizes, not statistics)"
        )
    if sizes.min() < 0:
        raise ValueError("sizes must be non-negative")
    if max_buckets < 1:
        raise ValueError(f"max_buckets={max_buckets} must be >= 1")
    if weights is None:
        w = np.ones_like(sizes, dtype=np.float64)
    else:
        w = np.asarray(list(weights), dtype=np.float64)
        if w.shape != sizes.shape:
            raise ValueError("weights must match sizes")
    # aggregate to distinct sizes with summed weights
    vals, inv = np.unique(sizes, return_inverse=True)
    wsum = np.zeros(vals.shape[0], np.float64)
    np.add.at(wsum, inv, w)
    n = vals.shape[0]
    k = min(int(max_buckets), n)
    # prefix sums: cost of serving segment [i..j] with bucket vals[j] is
    # vals[j] * W[i..j] - S[i..j]  (W = sum of weights, S = sum w*val)
    pw = np.concatenate([[0.0], np.cumsum(wsum)])
    ps = np.concatenate([[0.0], np.cumsum(wsum * vals)])

    def seg_cost(i, j):  # inclusive
        return vals[j] * (pw[j + 1] - pw[i]) - (ps[j + 1] - ps[i])

    INF = float("inf")
    # dp[b][j]: min waste covering distinct sizes [0..j] with b buckets.
    # seg_cost(i, j) = vals[j]*pw[j+1] - ps[j+1] + (ps[i] - vals[j]*pw[i]),
    # affine in the prefix arrays — the minimization over the segment
    # start i vectorizes per (b, j), keeping the DP numpy-speed at the
    # dataset-statistics scale it is advertised for (thousands of
    # distinct sizes)
    dp = np.full((k + 1, n), INF)
    arg = np.zeros((k + 1, n), np.int64)
    for j in range(n):
        dp[1][j] = seg_cost(0, j)
    pw_i = pw[:n]  # pw[i] indexed by segment start i
    ps_i = ps[:n]
    for b in range(2, k + 1):
        base = np.concatenate([[INF], dp[b - 1][:-1]]) + ps_i  # dp[b-1][i-1]+ps[i]
        for j in range(b - 1, n):
            i0 = b - 1
            cand = base[i0 : j + 1] - vals[j] * pw_i[i0 : j + 1]
            rel = int(np.argmin(cand))
            arg[b][j] = i0 + rel
            dp[b][j] = cand[rel] + vals[j] * pw[j + 1] - ps[j + 1]
    # backtrack the bucket values (segment maxima)
    buckets = []
    b, j = k, n - 1
    while b >= 1:
        i = int(arg[b][j]) if b > 1 else 0
        buckets.append(int(vals[j]))
        j = i - 1
        b -= 1
    return sorted(buckets)
