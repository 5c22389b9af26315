"""Coefficient-domain ("DCT") host-to-device wire for JPEG image fields (port
of ``accvlab_tpu/pipeline/processing_steps/dct_wire.py``).

The pixel wires (:mod:`image_decoder`, :mod:`wire_compression`) run the
whole JPEG decode on the host and ship pixels. This wire stops the host's
decode after the entropy (Huffman) half and ships the **quantized DCT
coefficients**. The card does the rest, on batched tensors with plain torch
ops:

    bit-unpack -> exception patch -> DC predictor inverse -> de-zigzag ->
    dequantize -> scaled IDCT (one float32 matmul) -> crop -> linear resize
    (two float32 matmuls) -> planar Y + subsampled CbCr

which :class:`YCbCrToRGBConverter` then turns into RGB, as on the YUV wire.

Wire format, per image field ``F`` of one sample and component set ``cs``
in ``y`` (luma) and ``c`` (Cb over Cr along the block rows); the executor
stacks the samples, so on the card every field has a leading batch
dimension:

* ``F_dct{cs}{g}_bp``  uint8 ``(b_g, nb_g*bh, bwp/8)``: bitplanes, LSB
  first, of the zigzag-mapped values of band group ``g`` (bands in JPEG
  zigzag order, grouped by frequency diagonal);
* ``F_dct{cs}_excw``  uint32 ``(E,)``: one patched-exception list per
  component set, one word per slot, ``flat index << 14 | zigzag value``
  into the concatenated ``(m*m, bh, bwp)`` band array, padded with the
  index ``m*m*bh*bwp``. Where that index needs more than 18 bits the list
  is ``F_dct{cs}_excp`` int32 + ``F_dct{cs}_excv`` int16 instead;
* ``F_dct{cs}_mode``  uint8 zeros, whose SHAPE ``(mode+1,)`` carries the DC
  band's spatial predictor (0 none, 1 vertical, 2 plane);
* ``F_dct_quant``  int32 ``(2, m, m)``: the luma and chroma quantization
  tables, natural order.

``b_g``, the DC mode and ``E`` are chosen per batch over every sample and
camera, so the fields of one batch have one shape. The host fields are
byte-identical to the JAX package's; the decoded planes are within 1 of its
(float32 sums in another order, then rounded).
"""

from __future__ import annotations

import os
import time
from typing import Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from .pipeline_step_base import BatchLevelStepBase, PipelineStepBase
from .wire_compression import _EXC_BITS, _zigzag, optimal_width_from_fits
from .. import dct_native, native_jpeg
from ..dtypes import DType
from ..operators.image_ops import linear_resize_matrix
from ..sample_data_group import SampleDataGroup
from ..._device import F32MatmulScope, device_of

#: zigzag of the DC plane-predictor residual (+-4*2047) needs 14 bits
_MAX_BITS = 14
#: exceptions pack into ONE uint32 word (``pos << 14 | zigzag``) when every
#: flat position of the concatenated band array fits the remaining 18 bits
_PACKED_EXC_POS_LIMIT = 1 << (32 - _MAX_BITS)
_MIN_EXC_BUCKET = 64

_MODE_NONE, _MODE_VERTICAL, _MODE_PLANE = 0, 1, 2
_COMPSETS = ("y", "c")

#: a named partition or an explicit (start, end) sequence (see band_groups)
Grouping = Union[str, Iterable[Tuple[int, int]]]


# --------------------------------------------------------------------------- #
# static layout, shared by packer and unpacker
# --------------------------------------------------------------------------- #


def select_m(source_hw, out_hw) -> int:
    """Smallest M in 1..8 whose M/8-scaled size covers ``out_hw``
    (:func:`native_jpeg.select_scale_m`)."""
    return native_jpeg.select_scale_m(source_hw, out_hw)


def band_order(m: int) -> List[Tuple[int, int]]:
    """The ``m*m`` (u, v) frequency pairs in zigzag (by-diagonal) order."""
    out = []
    for s in range(2 * m - 1):
        for u in range(max(0, s - m + 1), min(s, m - 1) + 1):
            out.append((u, s - u))
    return out


def band_groups(m: int, grouping: Grouping) -> List[Tuple[int, int]]:
    """Static partition of the zigzag band order into groups that share one
    bit width: ``(start, end)`` index pairs.

    * ``"band"``: one group per band (fewest bytes, most wire fields);
    * ``"split12"``: DC and the first diagonal alone, diagonals 2-5 split in
      half, the tails merged;
    * ``"diag8"``: the first six diagonals alone, the tails merged;
    * an explicit sequence of ``(start, end)`` pairs, such as the output of
      :func:`optimize_band_groups`. It must start with the DC group
      ``(0, 1)`` and tile ``[0, m*m)`` contiguously.
    """
    if not isinstance(grouping, str):
        groups = [(int(a), int(b)) for a, b in grouping]
        if not groups or groups[0] != (0, 1):
            raise ValueError(
                f"custom band grouping must start with the DC group (0, 1), got {groups[:1]}"
            )
        prev = 0
        for a, b in groups:
            if a != prev or b <= a:
                raise ValueError(
                    f"custom band grouping must tile [0, {m * m}) with contiguous "
                    f"(start, end) pairs; got {groups}"
                )
            prev = b
        if prev != m * m:
            raise ValueError(
                f"custom band grouping covers [0, {prev}) but m={m} has {m * m} bands"
            )
        return groups
    diag_sizes = [min(s, m - 1) - max(0, s - m + 1) + 1 for s in range(2 * m - 1)]
    bounds = np.cumsum([0] + diag_sizes)  # diagonal d = bands[bounds[d]:bounds[d+1]]
    nd = len(diag_sizes)
    if grouping == "band":
        return [(i, i + 1) for i in range(m * m)]
    if grouping == "diag8":
        cut = min(6, nd)
        groups = [(int(bounds[d]), int(bounds[d + 1])) for d in range(cut)]
        if nd > cut:
            mid = min(cut + 2, nd)
            groups.append((int(bounds[cut]), int(bounds[mid])))
            if mid < nd:
                groups.append((int(bounds[mid]), int(bounds[nd])))
        return groups
    if grouping == "split12":
        groups = []
        for d in range(min(2, nd)):
            groups.append((int(bounds[d]), int(bounds[d + 1])))
        for d in range(2, min(6, nd)):
            a, b = int(bounds[d]), int(bounds[d + 1])
            h = (b - a + 1) // 2
            groups.append((a, a + h))
            if a + h < b:
                groups.append((a + h, b))
        if nd > 6:
            mid = min(8, nd)
            groups.append((int(bounds[6]), int(bounds[mid])))
            if mid < nd:
                groups.append((int(bounds[mid]), int(bounds[nd])))
        return groups
    raise ValueError(
        "grouping must be 'band', 'split12', 'diag8' or a sequence of (start, end) pairs, "
        f"got {grouping!r}"
    )


def _pad8(n: int) -> int:
    return (n + 7) // 8 * 8


class _Geometry:
    """Everything both halves must agree on, derived from the constructor
    arguments.

    ``grid`` holds the PACKED component-set grids: luma ``(bh_y,
    pad8(bw_y))``, chroma ``(2*bh_c, pad8(bw_c))`` (Cb over Cr along block
    rows; the column pad adds zero blocks whose pixels land beyond the crop).
    """

    def __init__(self, source_hw, out_hw):
        self.source_hw = (int(source_hw[0]), int(source_hw[1]))
        self.out_hw = (int(out_hw[0]), int(out_hw[1]))
        if (self.out_hw[0] | self.out_hw[1]) & 1:
            raise ValueError(f"out_hw must be even (4:2:0 chroma), got {self.out_hw}")
        self.m = select_m(self.source_hw, self.out_hw)
        sh, sw = self.source_hw
        m = self.m
        # libjpeg block grids (jdinput.c): ceil(dim/8) for luma, ceil(dim/16)
        # for 4:2:0 chroma
        self.blocks_y = ((sh + 7) // 8, (sw + 7) // 8)
        self.blocks_c = ((sh + 15) // 16, (sw + 15) // 16)
        self.grid = {
            "y": (self.blocks_y[0], _pad8(self.blocks_y[1])),
            "c": (2 * self.blocks_c[0], _pad8(self.blocks_c[1])),
        }
        # pixel crops of the M/8-scaled planes (per COMPONENT, not compset)
        ch, cw = (sh + 1) // 2, (sw + 1) // 2
        self.crop = {
            "y": ((sh * m + 7) // 8, (sw * m + 7) // 8),
            "c": ((ch * m + 7) // 8, (cw * m + 7) // 8),
        }
        self.out = {"y": self.out_hw, "c": (self.out_hw[0] // 2, self.out_hw[1] // 2)}
        # exception wire format, static per geometry: one packed uint32 word
        # per exception when every flat band-array position fits 18 bits,
        # else pos32 + val16
        self.total = {cs: self.m * self.m * g[0] * g[1] for cs, g in self.grid.items()}
        self.packed_exc = {cs: t < _PACKED_EXC_POS_LIMIT for cs, t in self.total.items()}
        self.exc_bits = {cs: 32 if p else _EXC_BITS for cs, p in self.packed_exc.items()}


def _field_names(name: str, groups, geo: _Geometry) -> List[str]:
    return list(_field_types(name, groups, geo))


def _field_types(name: str, groups, geo: _Geometry) -> dict:
    t = {}
    for cs in _COMPSETS:
        for g in range(len(groups)):
            t[f"{name}_dct{cs}{g}_bp"] = DType.UINT8
        if geo.packed_exc[cs]:
            t[f"{name}_dct{cs}_excw"] = DType.UINT32
        else:
            t[f"{name}_dct{cs}_excp"] = DType.INT32
            t[f"{name}_dct{cs}_excv"] = DType.INT16
        t[f"{name}_dct{cs}_mode"] = DType.UINT8
    t[f"{name}_dct_quant"] = DType.INT32
    return t


# --------------------------------------------------------------------------- #
# host encode
# --------------------------------------------------------------------------- #


def _dc_residual(dc: np.ndarray, mode: int) -> np.ndarray:
    """Spatial predictor residuals of the DC band plane (int16 in and out),
    the residual of the pixel codec (:mod:`wire_compression`) applied to
    the DC coefficient image."""
    d = dc.astype(np.int16)
    if mode == _MODE_NONE:
        return d
    rv = d.copy()
    rv[1:] -= d[:-1]
    if mode == _MODE_VERTICAL:
        rv[0, 1:] -= d[0, :-1]
        return rv
    r2 = rv.copy()
    r2[:, 1:] -= rv[:, :-1]
    return r2


class _CompsetEncoder:
    """Encode state of one (sample, occurrence, component set) between the
    packer's two batch passes, behind one interface for two backends.

    The native engine (``pipeline/csrc/dctpack.cpp``) does the zigzag, the
    per-group width summaries (all three DC predictors in one sweep) and the
    bitplane and exception emit in single passes; the numpy backend builds
    the zigzag band array and the DC residuals. Both give byte-identical
    wire fields. The numpy backend runs only when ``dct_native.get_lib`` is
    patched to return ``None``: a library that does not build raises.
    """

    def __init__(self, bands: np.ndarray, groups):
        # bands: (m*m, bh, bwp) int16, zigzag band order; group 0 is the DC
        # band alone in every grouping
        if groups[0] != (0, 1):
            raise ValueError(f"band group 0 must be the DC band alone, got {groups[0]}")
        bands = np.ascontiguousarray(bands, np.int16)
        self.n_per_group = [int((b - a) * bands.shape[1] * bands.shape[2]) for a, b in groups]
        self._bands = bands
        self._groups = groups
        bounds = [a for a, _ in groups] + [groups[-1][1]]
        res = dct_native.analyze(bands, bounds)
        self._f: dict = {}  # (g, mode) -> int64 (15,): count(zigzag < 2^b)
        if res is not None:
            self._native = True
            fits, dc3 = res
            for g in range(1, len(groups)):
                self._f[(g, _MODE_NONE)] = fits[g].astype(np.int64)
            for mode in (_MODE_NONE, _MODE_VERTICAL, _MODE_PLANE):
                self._f[(0, mode)] = dc3[mode].astype(np.int64)
            self.zz = None
            self.dc_zz = None
        else:
            self._build_numpy_state()

    def _build_numpy_state(self):
        """The numpy backend's encode state."""
        self._native = False
        bands, groups = self._bands, self._groups
        self.zz = _zigzag(bands)  # uint16; band 0 = mode-NONE DC
        self.dc_zz = {mode: _zigzag(_dc_residual(bands[0], mode))
                      for mode in (_MODE_VERTICAL, _MODE_PLANE)}
        self.dc_zz[_MODE_NONE] = self.zz[0]

        def to_fits(zz):
            cum = np.cumsum(np.bincount(zz.ravel(), minlength=1 << _MAX_BITS), dtype=np.int64)
            return cum[(1 << np.arange(_MAX_BITS + 1)) - 1]

        for mode, dz in self.dc_zz.items():
            self._f[(0, mode)] = to_fits(dz)
        for g, (a, b) in enumerate(groups[1:], start=1):
            self._f[(g, _MODE_NONE)] = to_fits(self.zz[a:b])

    def group_zz(self, g: int, dc_mode: int) -> np.ndarray:
        a, b = self._groups[g]
        if a == 0:  # group containing the DC band
            zz = self.zz[a:b]
            if dc_mode != _MODE_NONE:
                zz = zz.copy()
                zz[0] = self.dc_zz[dc_mode]
            return zz
        return self.zz[a:b]

    def fits(self, g: int, dc_mode: int) -> np.ndarray:
        """``fits[b] = count(zigzag < 2**b)`` for b in 0..14: everything the
        width and mode chooser needs from this group's values."""
        return self._f[(g, dc_mode if g == 0 else _MODE_NONE)]

    def exceptions_at(self, g: int, dc_mode: int, b: int) -> int:
        return self.n_per_group[g] - int(self.fits(g, dc_mode)[b])

    def pack_group_into(self, g: int, dc_mode: int, b: int, excp, excv, ne: int):
        """Pack group ``g`` into a new bitplane array; its exceptions
        (positions in the concatenated band space) go to the unified list
        from ``ne`` on. Returns ``(bp, new_ne)``; ``new_ne`` is the TRUE count
        (the caller raises if it exceeds the capacity)."""
        a, b_end = self._groups[g]
        bh, bwp = self._bands.shape[1], self._bands.shape[2]
        bp = np.empty((b, (b_end - a) * bh, bwp // 8), np.uint8)
        if self._native:
            new_ne = dct_native.pack_group(self._bands, a, b_end, dc_mode, b, bp, excp, excv, ne)
            if new_ne is None:
                raise RuntimeError("the native DCT band encoder went away between analyze and "
                                   "pack")
            return bp, new_ne
        zz = self.group_zz(g, dc_mode)
        bp[...] = _pack_group(zz, b)
        pos = np.flatnonzero(zz >= (1 << b))
        take = min(pos.size, max(0, excp.size - ne))
        offset = a * bh * bwp
        excp[ne: ne + take] = pos[:take].astype(np.int32) + offset
        excv[ne: ne + take] = zz.reshape(-1)[pos[:take]].astype(np.int16)
        return bp, ne + pos.size


def _optimal_width(fits: np.ndarray, n: int, exc_bits: int = _EXC_BITS) -> Tuple[int, int]:
    """The shared width-cost model (:func:`wire_compression.optimal_width_from_fits`)
    for DCT bands; ``exc_bits`` is 32 on packed-exception geometries."""
    return optimal_width_from_fits(fits, n, _MAX_BITS, exc_bits)


def _exc_bucket(n: int) -> int:
    """Exception-list capacity bucket: powers of two up to 1024, then
    multiples of 512."""
    cap = _MIN_EXC_BUCKET
    while cap < n and cap < 1024:
        cap *= 2
    if n > cap:
        cap = (n + 511) // 512 * 512
    return cap


def _pack_group(zz: np.ndarray, b: int) -> np.ndarray:
    """Bitplanes ``(b, rows, cols/8)`` of one group, flattened to 2-D rows."""
    nb, bh, bwp = zz.shape
    flat = zz.reshape(nb * bh, bwp)
    planes = np.empty((b, nb * bh, bwp // 8), np.uint8)
    for k in range(b):
        planes[k] = np.packbits(((flat >> k) & 1).astype(np.uint8), axis=-1)
    return planes


class DCTWirePacker(BatchLevelStepBase):
    """Host batch-level step: JPEG bytes -> quantized-coefficient wire.

    Takes the place of ``ImageDecoder`` + ``WirePlanePacker`` for JPEG
    sources: consumes the encoded-bytes field ``image_name`` and emits the
    ``<image_name>_dct*`` fields of the module docstring. Pair it with
    :class:`DCTWireUnpacker` (same constructor arguments), then
    :class:`YCbCrToRGBConverter`.

    Needs the native libjpeg decoder (raises at construction without it;
    nothing falls back to a pixel wire), baseline or progressive JPEGs in
    grayscale or YCbCr 4:2:0, and one source size ``source_hw`` for every
    image.

    Args:
        image_name: encoded-JPEG field name.
        source_hw: (height, width) every source JPEG must have.
        out_hw: the even (height, width) the unpacker reconstructs.
        grouping: band-group partition: ``"band"``, ``"split12"`` (the
            default), ``"diag8"`` or explicit ``(start, end)`` pairs such as
            :func:`optimize_band_groups`'s.
        num_threads: per-image encode threads (the entropy decode and the
            native analyze and pack release the interpreter lock). Default
            ``min(4, cpu_count)``; 1 runs serially. The wire is
            byte-identical either way.
    """

    def __init__(self, image_name: str, source_hw, out_hw, grouping: Grouping = "split12",
                 num_threads: Optional[int] = None):
        super().__init__()
        if not isinstance(image_name, str):
            raise ValueError("DCTWirePacker needs a string image_name")
        if not native_jpeg.available():
            raise RuntimeError(
                "DCTWirePacker needs the native libjpeg decoder, which did not build: "
                f"{native_jpeg.build_error()}"
            )
        self._image_name = image_name
        self._geo = _Geometry(source_hw, out_hw)
        self._grouping = grouping
        self._groups = band_groups(self._geo.m, grouping)
        self._order = band_order(self._geo.m)
        if num_threads is None:
            num_threads = min(4, os.cpu_count() or 1)
        self._num_threads = max(1, int(num_threads))
        self._pool = None
        #: the most recent batch's choices, written by the producer thread,
        #: for monitoring: {"m", "dc_mode", "widths", "exc_capacity",
        #: "exc_format", "raw_bytes", "packed_bytes"} (the JAX package's keys)
        self.last_batch_stats: dict = {}
        #: the most recent batch's host seconds, summed over its images:
        #: {"entropy_decode", "analyze", "pack", "images"}
        self.last_batch_seconds: dict = {}

    def __getstate__(self):
        # process workers pickle host steps; the thread pool is per process
        d = self.__dict__.copy()
        d["_pool"] = None
        return d

    @property
    def groups(self) -> List[Tuple[int, int]]:
        """The band groups this packer writes."""
        return list(self._groups)

    def _read_bands(self, encoded: np.ndarray) -> dict:
        """Entropy-decode one JPEG into zigzag-ordered band arrays per
        component set, plus the quantization tables."""
        geo = self._geo
        info = native_jpeg.dct_info(encoded)
        if info["src_hw"] != geo.source_hw:
            raise ValueError(
                f"DCTWirePacker: source is {info['src_hw']}, constructed for {geo.source_hw} "
                "(batch-uniform source sizes required)"
            )
        y, cb, cr, quant = native_jpeg.read_dct(encoded, geo.m, info)
        m = geo.m
        uu = np.array([u for u, _ in self._order])
        vv = np.array([v for _, v in self._order])

        def to_bands(comp, grid):
            # (bh, bw, m, m) -> (m*m, bh, bwp), zigzag band order + column pad
            bands = np.ascontiguousarray(
                comp.reshape(comp.shape[0], comp.shape[1], m * m).transpose(2, 0, 1)[uu * m + vv]
            )
            bh, bwp = grid
            if bands.shape[2] < bwp:
                bands = np.pad(bands, ((0, 0), (0, 0), (0, bwp - bands.shape[2])))
            return bands

        return {
            "y": to_bands(y, geo.grid["y"]),
            "c": to_bands(np.concatenate([cb, cr], axis=0), geo.grid["c"]),
            "quant": quant.astype(np.int32),
        }

    def _process_batch(self, samples: List[SampleDataGroup]) -> List[SampleDataGroup]:
        geo, groups = self._geo, self._groups
        # pass 1: entropy decode + per-group width summaries, summed over the
        # batch (per compset, and per DC mode for group 0), so that widths and
        # mode minimise the batch's total cost with batch-uniform shapes. The
        # per-image work runs on a small thread pool in order, so the wire is
        # byte-identical to the serial path.
        jobs = []  # (sample_idx, path, encoded)
        for si, sdg in enumerate(samples):
            for ip in sdg.find_all_occurrences(self._image_name):
                jobs.append((si, tuple(ip), np.asarray(sdg.get_item_in_path(ip), np.uint8)))
        if not jobs:
            raise KeyError(f"DCTWirePacker: no occurrences of '{self._image_name}'")

        def encode_one(job):
            si, ip, encoded = job
            t0 = time.perf_counter()
            data = self._read_bands(encoded)
            t1 = time.perf_counter()
            ce = {cs: _CompsetEncoder(data[cs], groups) for cs in _COMPSETS}
            return si, ip, ce, data["quant"], (t1 - t0, time.perf_counter() - t1)

        if self._num_threads > 1 and len(jobs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            if self._pool is None:
                self._pool = ThreadPoolExecutor(self._num_threads, thread_name_prefix="dct-wire")
            encs = list(self._pool.map(encode_one, jobs))
        else:
            encs = [encode_one(j) for j in jobs]
        fits_sum = {}
        for _, _, ce, _, _ in encs:
            for cs in _COMPSETS:
                for g in range(len(groups)):
                    modes = ((_MODE_NONE, _MODE_VERTICAL, _MODE_PLANE) if groups[g][0] == 0
                             else (_MODE_NONE,))
                    for mode in modes:
                        key = (cs, g, mode)
                        f = ce[cs].fits(g, mode)
                        fits_sum[key] = f if key not in fits_sum else fits_sum[key] + f
        n_imgs = len(encs)
        # the DC mode (joint over the DC group) and the widths
        widths = {}
        dc_mode = {}
        for cs in _COMPSETS:
            best = None
            for mode in (_MODE_NONE, _MODE_VERTICAL, _MODE_PLANE):
                b, cost = _optimal_width(fits_sum[(cs, 0, mode)],
                                         encs[0][2][cs].n_per_group[0] * n_imgs, geo.exc_bits[cs])
                if best is None or cost < best[0]:
                    best = (cost, mode, b)
            _, dc_mode[cs], b0 = best
            ws = [b0]
            for g in range(1, len(groups)):
                b, _ = _optimal_width(fits_sum[(cs, g, _MODE_NONE)],
                                      encs[0][2][cs].n_per_group[g] * n_imgs, geo.exc_bits[cs])
                ws.append(b)
            widths[cs] = ws
        # one exception capacity per compset for the whole batch
        cap = {cs: 0 for cs in _COMPSETS}
        for _, _, ce, _, _ in encs:
            for cs in _COMPSETS:
                n = sum(ce[cs].exceptions_at(g, dc_mode[cs], b) for g, b in enumerate(widths[cs]))
                cap[cs] = max(cap[cs], n)
        cap = {cs: _exc_bucket(n) for cs, n in cap.items()}

        # pass 2: pack (on the same pool) and write the fields (this thread)
        stats = {
            "m": geo.m,
            "dc_mode": dict(dc_mode),
            "widths": {cs: list(widths[cs]) for cs in _COMPSETS},
            "exc_capacity": dict(cap),
            "exc_format": {cs: "packed32" if geo.packed_exc[cs] else "pos32+val16"
                           for cs in _COMPSETS},
            "raw_bytes": 0,
            "packed_bytes": 0,
        }

        def pack_one(enc_entry):
            si, ip, ce, quant, _ = enc_entry
            t0 = time.perf_counter()
            fields = {}
            for cs in _COMPSETS:
                enc = ce[cs]
                e = cap[cs]
                excp = np.full((e,), geo.total[cs], np.int32)  # out of range -> dropped
                excv = np.zeros((e,), np.int16)
                ne = 0
                for g, b in enumerate(widths[cs]):
                    planes, ne = enc.pack_group_into(g, dc_mode[cs], b, excp, excv, ne)
                    fields[f"dct{cs}{g}_bp"] = planes
                if ne > e:
                    raise RuntimeError(
                        f"DCT wire: {ne} exceptions exceed the sized capacity {e} (the "
                        "capacity comes from the same histograms: this is a bug)"
                    )
                if geo.packed_exc[cs]:
                    # one uint32 word per slot: pos << 14 | zigzag; padding
                    # slots carry pos == total, still out of range
                    fields[f"dct{cs}_excw"] = ((excp.astype(np.uint32) << _MAX_BITS)
                                               | excv.astype(np.uint32))
                else:
                    fields[f"dct{cs}_excp"] = excp
                    fields[f"dct{cs}_excv"] = excv
                fields[f"dct{cs}_mode"] = np.zeros((dc_mode[cs] + 1,), np.uint8)
            fields["dct_quant"] = quant
            return si, ip, fields, time.perf_counter() - t0

        if self._pool is not None and len(encs) > 1:
            packed = list(self._pool.map(pack_one, encs))
        else:
            packed = [pack_one(e) for e in encs]
        for si, ip, fields, _ in packed:
            parent = samples[si].get_parent_of_path(list(ip))
            name = ip[-1]
            parent.remove_field(name)
            for fname, t in _field_types(name, groups, geo).items():
                parent.add_data_field(fname, t)
            for sfx, arr in fields.items():
                parent[f"{name}_{sfx}"] = arr
                stats["packed_bytes"] += arr.nbytes
            for cs in _COMPSETS:
                stats["raw_bytes"] += geo.out[cs][0] * geo.out[cs][1] * (1 if cs == "y" else 2)
        self.last_batch_stats = stats
        self.last_batch_seconds = {
            "entropy_decode": sum(e[4][0] for e in encs),
            "analyze": sum(e[4][1] for e in encs),
            "pack": sum(p[3] for p in packed),
            "images": n_imgs,
        }
        return samples

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        paths = data_empty.find_all_occurrences(self._image_name)
        if len(paths) == 0:
            raise KeyError(f"DCTWirePacker: no occurrences of '{self._image_name}'")
        for ip in paths:
            t = data_empty.get_type_of_item_in_path(ip)
            if t != DType.UINT8:
                raise TypeError(f"Encoded image field at {ip} must be UINT8, got {t}")
            parent = data_empty.get_parent_of_path(list(ip))
            parent.remove_field(ip[-1])
            for fname, ft in _field_types(ip[-1], self._groups, self._geo).items():
                parent.add_data_field(fname, ft)
        return data_empty


# --------------------------------------------------------------------------- #
# device decode
# --------------------------------------------------------------------------- #


def _idct_basis(m: int) -> np.ndarray:
    """m-point scaled-IDCT basis ``B[x, u] = (c_u/2) cos((2x+1)u pi/(2m))``,
    the float form of libjpeg's M/8 scaled IDCT. ``plane = B @ coeff @ B.T``
    per block."""
    x = np.arange(m)[:, None].astype(np.float64)
    u = np.arange(m)[None, :].astype(np.float64)
    b = 0.5 * np.cos((2 * x + 1) * u * np.pi / (2 * m))
    b[:, 0] *= 1.0 / np.sqrt(2.0)
    return b.astype(np.float32)


def _idct_matrix(m: int) -> np.ndarray:
    """``(m*m, m*m)`` float32 ``K[x*m + y, u*m + v] = B[x, u] * B[y, v]``: the
    whole 2-D block IDCT as one matrix over the natural-order coefficients
    (the products of the float32 basis, rounded once)."""
    b = _idct_basis(m).astype(np.float64)
    return np.kron(b, b).astype(np.float32)


class DCTWireUnpacker(PipelineStepBase):
    """Device step: reconstruct Y + CbCr fields from the DCT wire, batched.

    Every occurrence of the field (every camera) is stacked along the batch
    dimension and decoded by one set of launches:

    1. bit-unpack: the groups of one width share one shift-and-weight pass
       over their bitplanes;
    2. exception patch: one scatter per component set into ``(N, total +
       1)``, whose extra column takes the padding index and is cut off (no
       mask, no host read);
    3. un-zigzag, the DC predictor's inverse cumulative sums (int32),
       de-zigzag (one gather) and dequantize: the integer coefficients;
    4. the scaled IDCT as one float32 matmul with the Kronecker basis, +128,
       clip;
    5. crop + resize as two float32 matmuls with
       :func:`~..operators.image_ops.linear_resize_matrix` weights (zero
       columns beyond the crop), round half to even, clip, uint8.

    Constant tensors (basis, de-zigzag order, resize weights) are made once
    per device. Constructor arguments must match the paired
    :class:`DCTWirePacker`. Outputs: ``image_name`` as uint8 ``(B, out_h,
    out_w)`` luma plus ``<image_name>_cbcr`` uint8 ``(B, out_h/2, out_w/2,
    2)``, the YUV 4:2:0 wire's layout.
    """

    placement = "device"

    def __init__(self, image_name: str, source_hw, out_hw, grouping: Grouping = "split12"):
        super().__init__()
        if not isinstance(image_name, str):
            raise ValueError("DCTWireUnpacker needs a string image_name")
        self._image_name = image_name
        self._geo = _Geometry(source_hw, out_hw)
        self._groups = band_groups(self._geo.m, grouping)
        m = self._geo.m
        inv = np.empty(m * m, np.int64)
        for p, (u, v) in enumerate(band_order(m)):
            inv[u * m + v] = p
        self._inv_perm = inv
        self._consts: dict = {}

    @property
    def chroma_field_name(self) -> str:
        return f"{self._image_name}_cbcr"

    def _constants(self, device: torch.device) -> dict:
        """Per-device constant tensors, made on first use."""
        key = (device.type, device.index)
        c = self._consts.get(key)
        if c is None:
            geo = self._geo
            m = geo.m
            c = {"inv_perm": torch.from_numpy(self._inv_perm).to(device),
                 "idct": torch.from_numpy(_idct_matrix(m)).to(device),
                 # the bit order of np.packbits: the byte's bit 7 first
                 "shifts": torch.arange(7, -1, -1, dtype=torch.uint8, device=device),
                 "planes": torch.arange(_MAX_BITS + 1, dtype=torch.int16, device=device)}
            for cs in _COMPSETS:
                bh, bwp = geo.grid[cs]
                rows = geo.blocks_c[0] * m if cs == "c" else bh * m
                (ch, cw), (oh, ow) = geo.crop[cs], geo.out[cs]
                # weights for the uncropped plane: zero beyond the crop
                wh = torch.zeros((oh, rows), dtype=torch.float32)
                wh[:, :ch] = linear_resize_matrix(ch, oh)
                ww = torch.zeros((bwp * m, ow), dtype=torch.float32)
                ww[:cw] = linear_resize_matrix(cw, ow).T
                c[f"resize_h_{cs}"] = wh.to(device)
                c[f"resize_w_{cs}"] = ww.to(device)
            self._consts[key] = c
        return c

    # ------------------------------------------------------------------ #

    def _unpack_groups(self, get, cs: str) -> torch.Tensor:
        """Bitplanes -> zigzag values ``(N, m*m*bh*bwp + 1)`` int32 in band
        order, the last column zero. ``get`` maps a field suffix (e.g.
        ``"dcty0_bp"``) to its batched tensor."""
        bh, bwp = self._geo.grid[cs]
        bps = []
        for g, (a, b_end) in enumerate(self._groups):
            bp = get(f"dct{cs}{g}_bp")
            nb = b_end - a
            if bp.ndim != 4 or bp.shape[2] != nb * bh or bp.shape[3] * 8 != bwp:
                raise ValueError(
                    f"DCTWireUnpacker: 'dct{cs}{g}_bp' is {tuple(bp.shape)}, expected (N, b, "
                    f"{nb * bh}, {bwp // 8}): source_hw/out_hw/grouping must match the packer"
                )
            bps.append(bp)
        n, dev = bps[0].shape[0], bps[0].device
        sizes = [(b_end - a) * bh * bwp for a, b_end in self._groups]
        pieces: List[Optional[torch.Tensor]] = [None] * len(bps)
        by_width: dict = {}
        for g, bp in enumerate(bps):
            if bp.shape[1] > 0:
                by_width.setdefault(bp.shape[1], []).append(g)
        consts = self._constants(dev)
        for b, gs in by_width.items():
            # the groups of one width: rows concatenated, one shift-and-weight
            # pass (bit 7 - j of byte c of plane k is bit k of column 8c + j)
            x = bps[gs[0]] if len(gs) == 1 else torch.cat([bps[g] for g in gs], dim=2)
            bits = (x.unsqueeze(-1) >> consts["shifts"]) & 1
            if b > 1:
                planes = consts["planes"][:b].view(1, b, 1, 1, 1)
                vals = torch.sum(bits.to(torch.int16) << planes, dim=1, dtype=torch.int32)
            else:
                vals = bits[:, 0].to(torch.int32)
            for g, piece in zip(gs, torch.split(vals.reshape(n, -1), [sizes[g] for g in gs], 1)):
                pieces[g] = piece
        # zero-width groups and the extra column: slices of one zeros tensor
        zeros = torch.zeros((n, max([sizes[g] for g, p in enumerate(pieces) if p is None]
                                    + [1])), dtype=torch.int32, device=dev)
        parts = [p if p is not None else zeros[:, :sizes[g]] for g, p in enumerate(pieces)]
        return torch.cat(parts + [zeros[:, :1]], dim=1)

    def _exceptions(self, get, cs: str):
        """The exception list's ``(positions int64, values int32)``, both
        ``(N, E)``; padding slots and anything out of range point at the
        extra column ``total``."""
        total = self._geo.total[cs]
        if self._geo.packed_exc[cs]:
            w = get(f"dct{cs}_excw")
            if w.dtype == torch.uint32:  # shifts of uint32 are not implemented
                w = w.view(torch.int32)
            # the mask undoes the sign extension of positions >= 2^17
            pos = ((w >> _MAX_BITS) & ((1 << (32 - _MAX_BITS)) - 1)).to(torch.int64)
            val = w & ((1 << _MAX_BITS) - 1)
        else:
            pos = get(f"dct{cs}_excp").to(torch.int64)
            pos = torch.where(pos < 0, pos + total, pos)  # a negative index wraps once
            val = get(f"dct{cs}_excv").to(torch.int32)
        pos = torch.where((pos >= 0) & (pos < total), pos, total)
        return pos, val

    def _coefficients(self, get, cs: str, quant: torch.Tensor) -> torch.Tensor:
        """Dequantized integer coefficients, natural order: ``(N, m*m,
        bh*bwp)`` int32 with row ``u*m + v``. ``quant``: ``(N, m, m)``."""
        geo = self._geo
        m = geo.m
        bh, bwp = geo.grid[cs]
        total = geo.total[cs]
        zz = self._unpack_groups(get, cs)
        pos, val = self._exceptions(get, cs)
        zz.scatter_(1, pos, val)
        zz = zz[:, :total].reshape(-1, m * m, bh, bwp)
        res = (zz >> 1) ^ -(zz & 1)
        # DC band: invert the spatial predictor (its mode rides in the shape
        # of the mode field)
        mode = get(f"dct{cs}_mode").shape[1] - 1
        dc = res[:, 0]
        if mode == _MODE_PLANE:
            res[:, 0] = torch.cumsum(torch.cumsum(dc, dim=2, dtype=torch.int32), dim=1,
                                     dtype=torch.int32)
        elif mode == _MODE_VERTICAL:
            dc = torch.cat([torch.cumsum(dc[:, :1], dim=2, dtype=torch.int32), dc[:, 1:]], dim=1)
            res[:, 0] = torch.cumsum(dc, dim=1, dtype=torch.int32)
        inv_perm = self._constants(res.device)["inv_perm"]
        coef = res.reshape(-1, m * m, bh * bwp).index_select(1, inv_perm)
        return coef * quant.reshape(-1, m * m, 1)

    def _plane(self, coef: torch.Tensor, cs: str) -> torch.Tensor:
        """Scaled IDCT of one component set's coefficients: float32 ``(N,
        bh*m, bwp*m)``, clipped to [0, 255]."""
        geo = self._geo
        m = geo.m
        bh, bwp = geo.grid[cs]
        k = self._constants(coef.device)["idct"]
        px = torch.matmul(k, coef.to(torch.float32))  # (N, x*m + y, h*bwp + w)
        plane = px.reshape(-1, m, m, bh, bwp).permute(0, 3, 1, 4, 2).reshape(-1, bh * m, bwp * m)
        return plane.add_(128.0).clamp_(0.0, 255.0)

    def _resize(self, plane: torch.Tensor, cs: str) -> torch.Tensor:
        """Crop + linear resize of ``(..., rows, cols)`` float planes to
        ``geo.out[cs]``, rounded half to even and clipped: uint8."""
        c = self._constants(plane.device)
        out = torch.matmul(c[f"resize_h_{cs}"], torch.matmul(plane, c[f"resize_w_{cs}"]))
        return out.round_().clamp_(0.0, 255.0).to(torch.uint8)

    def coefficients(self, get) -> dict:
        """The integer coefficients of both component sets (the decode's
        exact half): ``{"y": ..., "c": ...}``, each int32 ``(N, m*m, bh*bwp)``
        in natural order, dequantized. ``get`` as for :meth:`decode_fields`."""
        quant = get("dct_quant")
        return {cs: self._coefficients(get, cs, quant[:, i]) for i, cs in enumerate(_COMPSETS)}

    def decode_fields(self, get):
        """Decode a batch: ``get`` maps a field suffix (e.g. ``"dcty0_bp"``,
        ``"dct_quant"``) to its batched tensor (leading dimension N). Returns
        ``(y, cbcr)``: uint8 ``(N, out_h, out_w)`` and ``(N, out_h/2,
        out_w/2, 2)`` on the tensors' device."""
        geo = self._geo
        quant = get("dct_quant")
        if tuple(quant.shape[1:]) != (2, geo.m, geo.m):
            raise ValueError(f"DCTWireUnpacker: 'dct_quant' is {tuple(quant.shape)}, expected "
                             f"(N, 2, {geo.m}, {geo.m}): source_hw/out_hw must match the packer")
        with F32MatmulScope():
            coef = self.coefficients(get)
            y = self._resize(self._plane(coef["y"], "y"), "y")
            # chroma compset = Cb over Cr along block rows: (N, 2, half, cols)
            c_plane = self._plane(coef["c"], "c")
            c_plane = c_plane.reshape(c_plane.shape[0], 2, -1, c_plane.shape[2])
            cbcr = self._resize(c_plane, "c").permute(0, 2, 3, 1)
        return y, cbcr

    def stacked_fields(self, data: SampleDataGroup):
        """Every occurrence's wire fields stacked along the batch dimension
        (one ``torch.cat`` per field; uint32 words viewed as int32): returns
        ``(parents, fields)``, the groups holding the occurrences, in order,
        and a dict keyed by field suffix for :meth:`decode_fields`."""
        name = self._image_name
        parents = [data.get_parent_of_path(list(ip))
                   for ip in data.find_all_occurrences(f"{name}_dct_quant")]

        def leaf(parent, fname):
            v = parent[fname]
            return v.view(torch.int32) if v.dtype == torch.uint32 else v

        fields = {}
        for fname in _field_names(name, self._groups, self._geo):
            vals = [leaf(p, fname) for p in parents]
            fields[fname[len(name) + 1:]] = vals[0] if len(vals) == 1 else torch.cat(vals, 0)
        return parents, fields

    def _process(self, data: SampleDataGroup) -> SampleDataGroup:
        name = self._image_name
        parents, fields = self.stacked_fields(data)
        if not parents:
            return data
        y, cbcr = self.decode_fields(fields.__getitem__)
        n = y.shape[0] // len(parents)
        for i, parent in enumerate(parents):
            for fname in _field_names(name, self._groups, self._geo):
                parent.remove_field(fname)
            parent.add_data_field(name, DType.UINT8)
            parent[name] = y[i * n:(i + 1) * n]
            parent.add_data_field(self.chroma_field_name, DType.UINT8)
            parent[self.chroma_field_name] = cbcr[i * n:(i + 1) * n]
        return data

    def _check_and_adjust_data_format_input_to_output(
        self, data_empty: SampleDataGroup
    ) -> SampleDataGroup:
        name = self._image_name
        paths = data_empty.find_all_occurrences(f"{name}_dct_quant")
        if len(paths) == 0:
            raise KeyError(
                f"DCTWireUnpacker: no '{name}_dct_quant' fields — is DCTWirePacker (same "
                "arguments) ahead of this step?"
            )
        for ip in paths:
            parent = data_empty.get_parent_of_path(list(ip))
            types = _field_types(name, self._groups, self._geo)
            for fname, t in types.items():
                if not parent.path_exists(fname):
                    raise KeyError(
                        f"DCTWireUnpacker expects '{fname}' (produced by DCTWirePacker with "
                        "the same arguments)"
                    )
                if parent.get_type_of_field(fname) != t:
                    raise TypeError(
                        f"DCTWireUnpacker: '{fname}' must be {t}, got "
                        f"{parent.get_type_of_field(fname)}"
                    )
            for fname in types:
                parent.remove_field(fname)
            parent.add_data_field(name, DType.UINT8)
            parent.add_data_field(self.chroma_field_name, DType.UINT8)
        return data_empty


# --------------------------------------------------------------------------- #
# functional API (outside the pipeline)
# --------------------------------------------------------------------------- #


def optimize_band_groups(jpeg_samples: Iterable[np.ndarray], source_hw, out_hw,
                         max_groups: int = 12,
                         field_cost_bits: int = 256) -> Tuple[Tuple[int, int], ...]:
    """Content-tuned static band partition: the best contiguous grouping of
    the ``m*m`` zigzag bands into at most ``max_groups`` groups, minimising
    the packer's own wire-cost model (bitplane bits + exception cost, summed
    over both component sets) plus ``field_cost_bits`` per group.

    Per-band value histograms add up, so the cost of any candidate group is
    the width-optimal cost of its summed histogram, and a dynamic program
    over contiguous partitions is exact for this model. Pass the result as
    the ``grouping`` of BOTH :class:`DCTWirePacker` and
    :class:`DCTWireUnpacker`.

    Args:
        jpeg_samples: a few encoded JPEGs (uint8 arrays) of the target
            content, all of size ``source_hw``.
        source_hw / out_hw: as for :class:`DCTWirePacker`.
        max_groups: groups per component set, the fixed DC group included.
        field_cost_bits: modeled overhead per group and component set.

    Returns:
        Tuple of ``(start, end)`` pairs, valid as a ``grouping``.
    """
    geo = _Geometry(source_hw, out_hw)
    n_bands = geo.m * geo.m
    if max_groups < 2:
        raise ValueError(f"max_groups must be >= 2, got {max_groups}")
    if n_bands == 1:  # m=1: the DC band is the whole spectrum
        return ((0, 1),)
    per_band = band_groups(geo.m, "band")
    probe = DCTWirePacker("image", source_hw, out_hw, grouping="band", num_threads=1)
    # summed per-band fits and value counts per compset (bands >= 1: the DC
    # band is its own fixed group)
    fits = {cs: None for cs in _COMPSETS}
    nval = {cs: 0 for cs in _COMPSETS}
    n_imgs = 0
    for jpeg in jpeg_samples:
        data = probe._read_bands(np.asarray(jpeg, np.uint8))
        n_imgs += 1
        for cs in _COMPSETS:
            enc = _CompsetEncoder(data[cs], per_band)
            f = np.stack([enc.fits(g, _MODE_NONE) for g in range(1, n_bands)])
            fits[cs] = f if fits[cs] is None else fits[cs] + f
            nval[cs] = enc.n_per_group[1]  # the same for every band
    if n_imgs == 0:
        raise ValueError("optimize_band_groups needs at least one JPEG")

    # cost of grouping bands [a, b) (1-based band indices -> rows a-1..b-1)
    pre = {cs: np.cumsum(fits[cs], axis=0) for cs in _COMPSETS}
    memo: dict = {}

    def group_cost(a: int, b: int) -> float:
        if (a, b) not in memo:
            c = field_cost_bits * len(_COMPSETS)
            for cs in _COMPSETS:
                s = pre[cs][b - 2] - (pre[cs][a - 2] if a > 1 else 0)
                _, bits = _optimal_width(s, (b - a) * nval[cs] * n_imgs, geo.exc_bits[cs])
                c += bits
            memo[(a, b)] = c
        return memo[(a, b)]

    # DP over bands 1..n_bands-1 with at most max_groups-1 groups
    n = n_bands - 1
    k_max = min(max_groups - 1, n)
    inf = float("inf")
    best = [[inf] * (n + 1) for _ in range(k_max + 1)]
    back = [[0] * (n + 1) for _ in range(k_max + 1)]
    best[0][0] = 0.0
    for k in range(1, k_max + 1):
        for j in range(k, n + 1):
            for i in range(k - 1, j):
                if best[k - 1][i] == inf:
                    continue
                c = best[k - 1][i] + group_cost(i + 1, j + 1)
                if c < best[k][j]:
                    best[k][j] = c
                    back[k][j] = i
    k_best = min(range(1, k_max + 1), key=lambda k: (best[k][n], k))
    bounds = [n]
    k, j = k_best, n
    while k > 0:
        j = back[k][j]
        bounds.append(j)
        k -= 1
    bounds.reverse()  # [0, ..., n] in band-1-based coordinates
    groups = [(0, 1)] + [(bounds[i] + 1, bounds[i + 1] + 1) for i in range(len(bounds) - 1)]
    return tuple((int(a), int(b)) for a, b in groups)


def compress_jpeg_dct(jpeg_bytes, out_hw, grouping: Grouping = "split12"):
    """Host-side encode of one JPEG to the DCT wire format.

    Returns a dict of numpy wire arrays keyed by field SUFFIX
    (``"dcty0_bp"``, ..., ``"dct_quant"``) plus ``"source_hw"``; feed it to
    :func:`decompress_jpeg_dct`. Widths and mode are chosen per call, so two
    calls may give different shapes; batch through :class:`DCTWirePacker`
    for batch-uniform shapes.
    """
    jpeg_bytes = np.asarray(jpeg_bytes, np.uint8)
    source_hw = native_jpeg.probe(jpeg_bytes)
    packer = DCTWirePacker("image", source_hw, out_hw, grouping=grouping, num_threads=1)
    s = SampleDataGroup()
    s.add_data_field("image", DType.UINT8)
    s["image"] = jpeg_bytes
    (out,) = packer._process_batch([s])
    fields = {fname[len("image_"):]: np.asarray(out[fname])
              for fname in _field_names("image", packer._groups, packer._geo)}
    fields["source_hw"] = source_hw
    return fields


def decompress_jpeg_dct(fields, out_hw, grouping: Grouping = "split12", device=None):
    """Decode :func:`compress_jpeg_dct`'s output.

    ``fields`` is the suffix-keyed mapping (``"source_hw"`` rides along as a
    tuple) of numpy arrays or tensors of one image. The decode runs on the
    tensors' device, or on ``device`` for numpy arrays (the card by
    default; ``device="cpu"`` for the plain run). Returns ``(y, cbcr)``: the
    uint8 luma plane at ``out_hw`` and the half-resolution CbCr, the YUV
    4:2:0 wire's layout (:func:`accvlab_tpu_torch.color.ycbcr420_to_rgb`
    completes the decode).
    """
    unpacker = DCTWireUnpacker("image", fields["source_hw"], out_hw, grouping=grouping)
    first = next(v for k, v in fields.items() if k != "source_hw")
    dev = device_of(first, device)

    def batched(v):
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if t.dtype == torch.uint32:
            t = t.view(torch.int32)
        return t.to(dev)[None]

    tensors = {k: batched(v) for k, v in fields.items() if k != "source_hw"}
    y, cbcr = unpacker.decode_fields(lambda sfx: tensors[sfx])
    return y[0], cbcr[0]
