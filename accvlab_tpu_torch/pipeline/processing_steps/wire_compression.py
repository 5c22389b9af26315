"""Lossless host-to-device wire compression of uint8 planes (port of
``accvlab_tpu/pipeline/processing_steps/wire_compression.py``).

* :class:`WirePlanePacker` — a host batch-level step that encodes uint8
  plane fields (Y and CbCr planes) into a bitplane-packed predictive code,
  with the C++ encoder of ``pipeline/csrc/wirepack.cpp``;
* :class:`WirePlaneUnpacker` — the device step that decodes them, on
  batched tensors, with plain torch ops: shift-and-mask bit unpacking, one
  scatter for the exception list, and one or two cumulative sums.

Predictors (chosen per batch per field, by measured cost):

* mode 1, "vertical": ``r[y] = p[y] - p[y-1]``; row 0 is differenced
  horizontally;
* mode 2, "plane": ``r = p - up - left + upleft``.

Wire format per plane field ``F`` of one sample, shape ``(H, d1, ...)``,
row width ``Wr = prod(shape[1:])``, ``Wr % 8 == 0`` (the executor stacks the
samples, so on the device every field has a leading batch dimension):

* ``F_wire_bp``   uint8 ``(b, H, Wr/8)``: bitplanes, LSB first, of the
  zigzag-mapped residual (``np.packbits`` bit order);
* ``F_wire_excp`` int32 ``(E,)``: flat indices into ``(H, Wr)`` of values
  that need more than ``b`` bits, padded with ``H*Wr``;
* ``F_wire_excv`` int16 ``(E,)``: the full zigzag residual there;
* ``F_wire_mode`` uint8 ``(mode, d2, ...)``: zeros, whose SHAPE carries the
  predictor mode and the layout beyond the row axis.

``b``, the mode and ``E`` (a power of two, at least 64) are chosen per
batch, so every wire tensor may change size from batch to batch. The
decoded plane is bit-identical to the input, and the wire fields are
byte-identical to the JAX package's for the same planes.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Union

import numpy as np
import torch

from .pipeline_step_base import BatchLevelStepBase, PipelineStepBase
from .. import wire_native
from ..dtypes import DType
from ..sample_data_group import SampleDataGroup

#: wire cost of one exception: int32 position + int16 value
_EXC_BITS = 48
#: minimum exception-list capacity bucket
_MIN_EXC_BUCKET = 64
#: plane-predictor residuals span [-510, 510] -> zigzag <= 1020 -> 10 bits
_MAX_BITS = 10

_SUFFIXES = ("_wire_bp", "_wire_excp", "_wire_excv", "_wire_mode")
_MODE_VERTICAL, _MODE_PLANE = 1, 2


def _zigzag(r: np.ndarray) -> np.ndarray:
    """Map signed residuals to unsigned: 0, -1, 1, -2, 2 -> 0, 1, 2, 3, 4."""
    r16 = np.ascontiguousarray(r, np.int16)
    return ((r16 << 1) ^ (r16 >> 15)).view(np.uint16)


def _exceptions_at(hist_cum: np.ndarray, b: int) -> int:
    """count(zz >= 2**b): values needing more than ``b`` bits."""
    t = 1 << b
    if t > hist_cum.size:
        return 0
    return int(hist_cum[-1] - hist_cum[t - 1])


def _hist_cum(zz: np.ndarray) -> np.ndarray:
    return np.cumsum(np.bincount(zz.ravel(), minlength=1 << _MAX_BITS))


def optimal_width_from_fits(fits, n: int, max_bits: int, exc_bits: int = _EXC_BITS) -> tuple:
    """Cost-optimal base width: minimize ``b*N + exceptions(b)*exc_bits``,
    where ``fits[b] = count(zigzag < 2**b)`` over the N values. Returns
    ``(b, cost_bits)``."""
    best_b, best_cost = max_bits, max_bits * n
    for b in range(max_bits + 1):
        cost = b * n + (n - int(fits[b])) * exc_bits
        if cost < best_cost:
            best_b, best_cost = b, cost
    return best_b, best_cost


def _optimal_width(zz_or_hist: np.ndarray, n: Optional[int] = None) -> tuple:
    """``(b, cost_bits)`` from either the zigzag values or a cumulative value
    histogram with its element count ``n``."""
    if n is None:
        hist_cum = _hist_cum(np.ravel(zz_or_hist))
        n = int(zz_or_hist.size)
    else:
        hist_cum = zz_or_hist
    fits = [n - _exceptions_at(hist_cum, b) for b in range(_MAX_BITS + 1)]
    return optimal_width_from_fits(fits, n, _MAX_BITS)


def _next_pow2(n: int) -> int:
    p = _MIN_EXC_BUCKET
    while p < n:
        p *= 2
    return p


def _validate_plane(plane: np.ndarray) -> int:
    """Shape/dtype contract of a plane; returns the flattened row width."""
    if plane.dtype != np.uint8:
        raise TypeError(f"WirePlanePacker compresses uint8 planes, got {plane.dtype}")
    if plane.ndim < 2:
        raise ValueError(f"WirePlanePacker needs >=2-D planes, got shape {plane.shape}")
    wr = int(np.prod(plane.shape[1:]))
    if wr % 8 != 0:
        raise ValueError(
            f"WirePlanePacker: row width {wr} (shape {plane.shape}) must "
            "be divisible by 8 (bit-packing granularity)"
        )
    return wr


def _residuals(plane: np.ndarray):
    """Both predictors' zigzag residuals of one plane, in numpy: the plain
    twin of ``wire_native.analyze``/``pack``. Returns ``(zz_vertical,
    zz_plane)``, each ``(H, Wr)`` uint16."""
    wr = _validate_plane(plane)
    d = plane.astype(np.int16)
    rv = d.copy()
    rv[1:] -= d[:-1]

    def hdiff(x):
        out = x.copy()
        out[:, 1:] -= x[:, :-1]
        return out

    r1 = rv.copy()
    r1[:1] = hdiff(d[:1])  # vertical mode: row 0 differenced horizontally
    r2 = hdiff(rv)  # plane mode: 2-D second difference
    h = plane.shape[0]
    return _zigzag(r1).reshape(h, wr), _zigzag(r2).reshape(h, wr)


def _pack_fields(zz, b, e):
    """Bitplanes + exception list (padded to ``e``) of chosen residuals, in
    numpy: the plain twin of ``wire_native.pack``."""
    planes = np.empty((b, zz.shape[0], zz.shape[1] // 8), np.uint8)
    for k in range(b):
        planes[k] = np.packbits(((zz >> k) & 1).astype(np.uint8), axis=-1)
    pos = np.flatnonzero(zz >= (1 << b)).astype(np.int32)
    excp = np.full((e,), zz.size, np.int32)
    excv = np.zeros((e,), np.int16)
    excp[: pos.size] = pos
    excv[: pos.size] = zz.reshape(-1)[pos].astype(np.int16)
    return planes, excp, excv


class _PlaneEncoder:
    """Encode state of one plane: both predictors' cumulative histograms
    from one pass of the C++ encoder, then the chosen ``(mode, b)``'s fields."""

    def __init__(self, plane: np.ndarray):
        wr = _validate_plane(plane)
        self.trailing = plane.shape[1:]
        self.n = plane.shape[0] * wr
        self._group = math.prod(plane.shape[2:])
        self._p2d = np.ascontiguousarray(plane.reshape(plane.shape[0], wr))
        h1, h2 = wire_native.analyze(self._p2d, self._group)
        self._h = (np.cumsum(h1), np.cumsum(h2))

    def hist_cum(self, mode: int) -> np.ndarray:
        return self._h[mode - 1]

    def exceptions_at(self, mode: int, b: int) -> int:
        return _exceptions_at(self.hist_cum(mode), b)

    def pack(self, mode: int, b: int, cap: int):
        return wire_native.pack(self._p2d, self._group, mode, b, cap)


def compress_plane(plane: np.ndarray, min_exc_capacity: int = _MIN_EXC_BUCKET):
    """Host-side encode of one uint8 plane outside the pipeline. Returns
    ``{"bp", "excp", "excv", "mode"}`` numpy arrays in the wire format of
    the module docstring; :func:`decompress_plane` inverts it."""
    plane = np.asarray(plane)
    enc = _PlaneEncoder(plane)
    b1, c1 = _optimal_width(enc.hist_cum(_MODE_VERTICAL), enc.n)
    b2, c2 = _optimal_width(enc.hist_cum(_MODE_PLANE), enc.n)
    mode, b = (_MODE_VERTICAL, b1) if c1 <= c2 else (_MODE_PLANE, b2)
    e = max(int(min_exc_capacity), _next_pow2(enc.exceptions_at(mode, b)))
    planes, excp, excv = enc.pack(mode, b, e)
    return {
        "bp": planes,
        "excp": excp,
        "excv": excv,
        "mode": np.zeros((mode,) + plane.shape[2:], np.uint8),
    }


def decompress_plane(fields) -> torch.Tensor:
    """Decode one plane of :func:`compress_plane`. ``fields`` maps the four
    names to tensors (or numpy arrays, which decode on the CPU); returns the
    original uint8 plane on their device."""
    bp, excp, excv, mode = (torch.as_tensor(fields[k])[None]
                            for k in ("bp", "excp", "excv", "mode"))
    return WirePlaneUnpacker._decode(bp, excp, excv, mode)[0]


class WirePlanePacker(BatchLevelStepBase):
    """Host batch-level step: encode uint8 plane fields for the wire.

    Pair with :class:`WirePlaneUnpacker` (same ``field_names``) as a device
    step ahead of anything that reads the planes. For the YUV 4:2:0 wire
    pass both the Y field and its ``<image>_cbcr`` sibling.
    """

    def __init__(self, field_names: Union[str, Iterable[str]]):
        super().__init__()
        if isinstance(field_names, str):
            field_names = [field_names]
        self._field_names = list(field_names)
        if not self._field_names:
            raise ValueError("WirePlanePacker needs at least one field name")
        #: per-field choices of the most recent batch: {name: {"mode",
        #: "width", "exc_capacity", "raw_bytes", "packed_bytes"}}; written by
        #: the producer thread, for monitoring
        self.last_batch_stats: dict = {}

    def _process_batch(self, samples: List[SampleDataGroup]) -> List[SampleDataGroup]:
        # pass 1: both predictors' histograms everywhere, summed per (field
        # name, mode), so that the batch picks the mode and the one width
        # that minimise the total cost over all samples
        encoded = []  # (sample_idx, path, encoder, name)
        hist = {}
        count = {}
        for si, sdg in enumerate(samples):
            for name in self._field_names:
                for ip in sdg.find_all_occurrences(name):
                    enc = _PlaneEncoder(np.asarray(sdg.get_item_in_path(ip)))
                    encoded.append((si, tuple(ip), enc, name))
                    for mode in (_MODE_VERTICAL, _MODE_PLANE):
                        key = (name, mode)
                        hist[key] = hist.get(key, 0) + enc.hist_cum(mode)
                        count[key] = count.get(key, 0) + enc.n
        mode_for = {}
        width = {}
        for name in {name for _, _, _, name in encoded}:
            best = None
            for mode in (_MODE_VERTICAL, _MODE_PLANE):
                b, c = _optimal_width(hist[(name, mode)], count[(name, mode)])
                if best is None or c < best[0]:
                    best = (c, mode, b)
            _, mode_for[name], width[name] = best
        # batch-uniform exception capacity per field name
        cap: dict = {}
        for _, _, enc, name in encoded:
            cap[name] = max(cap.get(name, 0), enc.exceptions_at(mode_for[name], width[name]))
        cap = {k: _next_pow2(v) for k, v in cap.items()}

        # pass 2: pack
        batch_stats: dict = {}
        for si, ip, enc, name in encoded:
            mode, b, e = mode_for[name], width[name], cap[name]
            planes, excp, excv = enc.pack(mode, b, e)
            mode_field = np.zeros((mode,) + tuple(enc.trailing[1:]), np.uint8)
            st = batch_stats.setdefault(name, {
                "mode": "plane" if mode == _MODE_PLANE else "vertical",
                "width": b, "exc_capacity": e, "raw_bytes": 0, "packed_bytes": 0,
            })
            st["raw_bytes"] += enc.n
            st["packed_bytes"] += planes.nbytes + excp.nbytes + excv.nbytes + mode_field.nbytes
            parent = samples[si].get_parent_of_path(list(ip))
            fname = ip[-1]
            parent.remove_field(fname)
            for sfx, t, value in zip(_SUFFIXES, (DType.UINT8, DType.INT32, DType.INT16,
                                                 DType.UINT8),
                                     (planes, excp, excv, mode_field)):
                parent.add_data_field(f"{fname}{sfx}", t)
                parent[f"{fname}{sfx}"] = value
        self.last_batch_stats = batch_stats
        return samples

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        found_any = False
        for name in self._field_names:
            for ip in data_empty.find_all_occurrences(name):
                found_any = True
                parent = data_empty.get_parent_of_path(list(ip))
                t = parent.get_type_of_field(ip[-1])
                if t != DType.UINT8:
                    raise TypeError(
                        f"WirePlanePacker: field '{name}' at {ip} must be UINT8, got {t}"
                    )
                parent.remove_field(ip[-1])
                parent.add_data_field(f"{ip[-1]}_wire_bp", DType.UINT8)
                parent.add_data_field(f"{ip[-1]}_wire_excp", DType.INT32)
                parent.add_data_field(f"{ip[-1]}_wire_excv", DType.INT16)
                parent.add_data_field(f"{ip[-1]}_wire_mode", DType.UINT8)
        if not found_any:
            raise KeyError(
                f"WirePlanePacker: none of {self._field_names} found in the "
                "sample data structure"
            )
        return data_empty


class WirePlaneUnpacker(PipelineStepBase):
    """Device step: reconstruct plane fields packed by :class:`WirePlanePacker`,
    batched.

    1. bit-unpack: each of the ``b`` bitplanes ``(B, H, Wr/8)`` is shifted
       and masked into bits and added, at its weight, into an int32 plane;
    2. exception patch: one scatter into ``(B, H*Wr + 1)``, whose extra
       column takes the padding index ``H*Wr`` and is cut off;
    3. un-zigzag and the predictor's inverse cumulative sums telescope the
       residuals back to the exact uint8 plane. The mode is read from the
       mode field's shape ``(B, mode, ...)``.
    """

    placement = "device"

    def __init__(self, field_names: Union[str, Iterable[str]]):
        super().__init__()
        if isinstance(field_names, str):
            field_names = [field_names]
        self._field_names = list(field_names)
        if not self._field_names:
            raise ValueError("WirePlaneUnpacker needs at least one field name")

    @staticmethod
    def _decode(bp: torch.Tensor, excp: torch.Tensor, excv: torch.Tensor,
                mode_field: torch.Tensor) -> torch.Tensor:
        """``bp (B, b, H, Wr/8)``, ``excp``/``excv (B, E)``, ``mode_field
        (B, mode, *rest)`` -> ``(B, H, Wr / prod(rest), *rest)`` uint8."""
        nb, b, h, wb = bp.shape
        wr = wb * 8
        n = h * wr
        mode = mode_field.shape[1]
        rest = tuple(mode_field.shape[2:])
        trailing = (wr // math.prod(rest),) + rest
        dev = bp.device
        zz = torch.zeros((nb, h, wr), dtype=torch.int32, device=dev)
        if b > 0:
            # bytes -> bits in np.packbits order: bit 7 first
            shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
            for k in range(b):
                bits = (bp[:, k, :, :, None] >> shifts) & 1
                zz += bits.reshape(nb, h, wr).to(torch.int32) << k
        # exception patch: negative indices wrap once, the rest out of range
        # (the padding H*Wr) land in the extra column, which is cut off
        idx = excp.to(torch.int64)
        idx = torch.where(idx < 0, idx + n, idx)
        idx = torch.where((idx >= 0) & (idx < n), idx, n)
        flat = torch.cat([zz.reshape(nb, n), zz.new_zeros((nb, 1))], dim=1)
        flat.scatter_(1, idx, excv.to(torch.int32))
        zz = flat[:, :n]
        res = ((zz >> 1) ^ -(zz & 1)).reshape((nb, h) + trailing)
        # inverse predictor: cumulative sum along the row axis (row 0 only in
        # the vertical mode), then down the columns
        if mode == _MODE_PLANE:
            x = torch.cumsum(res, dim=2, dtype=torch.int32)
        else:
            x = torch.cat([torch.cumsum(res[:, :1], dim=2, dtype=torch.int32), res[:, 1:]],
                          dim=1)
        return torch.cumsum(x, dim=1, dtype=torch.int32).to(torch.uint8)

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        for name in self._field_names:
            for ip in data.find_all_occurrences(f"{name}_wire_bp"):
                parent = data.get_parent_of_path(list(ip))
                plane = self._decode(*(parent[f"{name}{sfx}"] for sfx in _SUFFIXES))
                for sfx in _SUFFIXES:
                    parent.remove_field(f"{name}{sfx}")
                parent.add_data_field(name, DType.UINT8)
                parent[name] = plane
        return data

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        found_any = False
        for name in self._field_names:
            for ip in data_empty.find_all_occurrences(f"{name}_wire_bp"):
                found_any = True
                parent = data_empty.get_parent_of_path(list(ip))
                for sfx, t in zip(_SUFFIXES, (DType.UINT8, DType.INT32, DType.INT16,
                                              DType.UINT8)):
                    fname = f"{name}{sfx}"
                    if not parent.path_exists(fname):
                        raise KeyError(
                            f"WirePlaneUnpacker expects '{fname}' (produced "
                            "by WirePlanePacker) next to the plane at "
                            f"{list(ip)[:-1]}"
                        )
                    if parent.get_type_of_field(fname) != t:
                        raise TypeError(
                            f"WirePlaneUnpacker: '{fname}' must be {t}, got "
                            f"{parent.get_type_of_field(fname)}"
                        )
                for sfx in _SUFFIXES:
                    parent.remove_field(f"{name}{sfx}")
                parent.add_data_field(name, DType.UINT8)
        if not found_any:
            raise KeyError(
                f"WirePlaneUnpacker: no '<name>_wire_bp' fields for any of "
                f"{self._field_names} — is WirePlanePacker ahead of this step?"
            )
        return data_empty
