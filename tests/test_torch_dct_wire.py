"""The DCT wire of the port (``accvlab_tpu_torch/pipeline/processing_steps/dct_wire.py``,
``pipeline/dct_native.py``) against the JAX package's, on the same JPEGs.

The JPEGs are made from a numpy seed and encoded by PIL, as in
tests/test_dct_wire.py. Held:

* the packer's wire fields and ``last_batch_stats`` byte for byte, in every
  grouping (``split12``, ``band``, ``diag8``, the DP grouping), on the
  split-exception geometry, on odd source sizes, grayscale and progressive
  JPEGs; the native encoder against the numpy one; threads against serial;
* ``optimize_band_groups`` equal to JAX's, ``m == 1`` included;
* the integer decode (exceptions, DC predictor inverse, de-zigzag,
  dequantize) bitwise against the packer's own bands times the tables;
* the planes within |Δ| ≤ 1 of JAX's ``DCTWireUnpacker`` (the IDCT and
  resize sum float32 products in another order, then round), with the share
  of differing values at most ``PLANE_SHARE``;
* JAX's quality contract against the pixel path (libjpeg's own decode):
  luma within 2 at m ≥ 6 and 6 below; chroma mean ≤ 6, p99 ≤ 24, max ≤ 48;
* the functional API, the format and geometry errors where JAX raises them;
* the slice: ``build_pipeline(device="cpu", wire="dct")`` with augmentation
  off against the JAX pipeline with the same steps.
"""

import io

import numpy as np
import pytest
import torch

import accvlab_tpu.pipeline as jpipe
import accvlab_tpu.pipeline.processing_steps as jsteps
import accvlab_tpu.pipeline.processing_steps.dct_wire as jdct
from accvlab_tpu.pipeline.inputs import DataProvider as JDataProvider
from accvlab_tpu.pipeline.inputs import ShuffledShardedInputCallable as JInput
import accvlab_tpu_torch.pipeline.processing_steps.dct_wire as tdct
from accvlab_tpu_torch.bench_pipeline import build_pipeline, dct_grouping
from accvlab_tpu_torch.pipeline import DType, PipelineDefinition, SampleDataGroup, dct_native
from accvlab_tpu_torch.pipeline import native_jpeg
from accvlab_tpu_torch.pipeline.inputs import DataProvider, ShuffledShardedInputCallable
from accvlab_tpu_torch.pipeline.inputs.multicam_jpeg import (
    MultiCameraJpegProvider,
    encode_bench_jpegs,
)
from accvlab_tpu_torch.pipeline.inputs.multicam_synthetic import fill_sample, sample_structure
from accvlab_tpu_torch.pipeline.operators.image_ops import linear_resize_matrix
from accvlab_tpu_torch.pipeline.processing_steps import (
    DCTWirePacker,
    DCTWireUnpacker,
    compress_jpeg_dct,
    decompress_jpeg_dct,
    optimize_band_groups,
)

SRC_HW = (372, 1024)
OUT_HW = (256, 704)
SMALL_HW = (96, 256)
SMALL_OUT = (64, 176)
#: the most planes may differ (by 1) from JAX's decode
PLANE_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_jpeg(seed=0, hw=SRC_HW, quality=90, mode="RGB", **save_kwargs):
    from PIL import Image

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (hw[0] // 8, hw[1] // 8, 3), np.uint8)
    img = Image.fromarray(base).resize((hw[1], hw[0]), Image.BILINEAR)
    if mode != "RGB":
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=quality, **save_kwargs)
    return np.frombuffer(buf.getvalue(), np.uint8).copy()


def noisy_jpeg(hw, seed=0, quality=95):
    """High-entropy content: wide values and many exceptions."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (hw[0], hw[1], 3), np.uint8)
    img[::2, ::2] = 255
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return np.frombuffer(buf.getvalue(), np.uint8).copy()


def sample(pkg_sdg, pkg_dtype, jpeg):
    s = pkg_sdg()
    s.add_data_field("image", pkg_dtype.UINT8)
    s["image"] = jpeg
    return s


def pack_both(jpegs, grouping="split12", src_hw=SRC_HW, out_hw=OUT_HW, num_threads=1):
    """Both packers on the same JPEGs: ``(jax samples, jax stats, torch
    samples, torch packer)``."""
    jp = jsteps.DCTWirePacker("image", src_hw, out_hw, grouping=grouping, num_threads=num_threads)
    tp = DCTWirePacker("image", src_hw, out_hw, grouping=grouping, num_threads=num_threads)
    js = jp._process_batch([sample(jpipe.SampleDataGroup, jpipe.DType, j) for j in jpegs])
    ts = tp._process_batch([sample(SampleDataGroup, DType, j) for j in jpegs])
    return js, jp.last_batch_stats, ts, tp


def wire_fields(samples, packer):
    names = tdct._field_names("image", packer._groups, packer._geo)
    return [{n: np.asarray(s[n]) for n in names} for s in samples]


def assert_fields_equal(js, ts, packer):
    jf, tf = wire_fields(js, packer), wire_fields(ts, packer)
    for a, b in zip(jf, tf):
        assert a.keys() == b.keys()
        for n in a:
            assert a[n].dtype == b[n].dtype and a[n].shape == b[n].shape, n
            np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def batched_get(samples, packer):
    """``get`` over the stacked fields of the samples, as the executor hands
    them to the device step."""
    fields = {}
    for n in tdct._field_names("image", packer._groups, packer._geo):
        t = torch.from_numpy(np.stack([np.asarray(s[n]) for s in samples]))
        fields[n[len("image_"):]] = t.view(torch.int32) if t.dtype == torch.uint32 else t
    return lambda sfx: fields[sfx]


def jax_planes(samples, src_hw, out_hw, grouping):
    """JAX's decode of each sample, as one jitted program (its
    ``decode_fields``, what its step runs per sample under ``vmap``)."""
    import jax

    ju = jsteps.DCTWireUnpacker("image", src_hw, out_hw, grouping=grouping)
    names = jdct._field_names("image", ju._groups, ju._geo)
    decode = jax.jit(lambda fields: ju.decode_fields(lambda sfx: fields[sfx]))
    outs = []
    for s in samples:
        y, cbcr = decode({n[len("image_"):]: np.asarray(s[n]) for n in names})
        outs.append((np.asarray(y), np.asarray(cbcr)))
    return outs


def torch_planes(samples, packer, src_hw, out_hw, grouping):
    tu = DCTWireUnpacker("image", src_hw, out_hw, grouping=grouping)
    y, cbcr = tu.decode_fields(batched_get(samples, packer))
    return y.numpy(), cbcr.numpy()


def assert_within_one(got, want, what):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    share = float(np.mean(d > 0))
    assert d.max() <= 1 and share <= PLANE_SHARE, f"{what}: max {d.max()}, share {share}"
    return share


# --------------------------------------------------------------------------- #
# static layout
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("m", range(1, 9))
def test_band_order_and_groups_equal_jax(m):
    assert tdct.band_order(m) == jdct.band_order(m)
    for grouping in ("band", "split12", "diag8", [(0, 1), (1, m * m)] if m > 1 else [(0, 1)]):
        assert tdct.band_groups(m, grouping) == jdct.band_groups(m, grouping)
    np.testing.assert_array_equal(tdct._idct_basis(m), jdct._idct_basis(m))


@pytest.mark.parametrize("src,out", [(SRC_HW, OUT_HW), ((371, 1021), OUT_HW), ((744, 2048),
                                     (512, 1408)), ((372, 1024), (46, 128)), ((100, 100),
                                     (200, 200)), ((18, 30), (4, 8))])
def test_geometry_equals_jax(src, out):
    j, t = jdct._Geometry(src, out), tdct._Geometry(src, out)
    for attr in ("m", "blocks_y", "blocks_c", "grid", "crop", "out", "total", "packed_exc",
                 "exc_bits"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert tdct.select_m(src, out) == jdct.select_m(src, out)


@pytest.mark.parametrize("in_size,out_size", [(279, 256), (768, 704), (140, 128), (7, 16),
                                               (2, 1)])
def test_linear_resize_matrix_equals_jax(in_size, out_size):
    """The resize weights bitwise against the function ``jax.image.resize``
    builds them with, op by op; and within 2^-20 of the weights in its
    compiled program (``jax.image.resize`` of an identity along one axis),
    where the compiler may fuse the sample position's multiply-add: one
    float32 step of a position near 700 moves a weight by 2^-21."""
    import jax
    import jax.numpy as jnp
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    got = linear_resize_matrix(in_size, out_size).numpy()
    want = np.asarray(compute_weight_mat(in_size, out_size, out_size / in_size, 0.0,
                                         _fill_triangle_kernel, False)).T
    np.testing.assert_array_equal(got, want)
    compiled = np.asarray(jax.image.resize(jnp.eye(in_size, dtype=jnp.float32),
                                           (out_size, in_size), method="linear",
                                           antialias=False))
    assert np.abs(got - compiled).max() <= 2.0 ** -20


@pytest.mark.parametrize("bad", [((0, 2), (2, 36)), ((0, 1), (2, 36)), ((0, 1), (1, 20)),
                                 ((0, 1), (1, 40)), ((0, 1), (20, 1)), "split13"])
def test_grouping_validation_like_jax(bad):
    with pytest.raises(ValueError):
        jdct.band_groups(6, bad)
    with pytest.raises(ValueError):
        tdct.band_groups(6, bad)


def test_width_model_and_buckets_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(1, 10_000))
        fits = np.sort(rng.integers(0, n + 1, 15))
        fits[-1] = n
        for bits in (32, 48):
            assert tdct._optimal_width(fits, n, bits) == jdct._optimal_width(fits, n, bits)
    for n in (0, 1, 63, 64, 65, 700, 1024, 1025, 5000):
        assert tdct._exc_bucket(n) == jdct._exc_bucket(n)
    dc = rng.integers(-2047, 2048, (7, 9)).astype(np.int16)
    for mode in (0, 1, 2):
        np.testing.assert_array_equal(tdct._dc_residual(dc, mode), jdct._dc_residual(dc, mode))


# --------------------------------------------------------------------------- #
# host encode: byte for byte
# --------------------------------------------------------------------------- #

PACK_CASES = {
    # name: (jpegs, src_hw, out_hw, grouping)
    "split12_bench": (lambda: [make_jpeg(s) for s in range(2)], SRC_HW, OUT_HW, "split12"),
    "band_small": (lambda: [make_jpeg(s, SMALL_HW) for s in range(3)], SMALL_HW, SMALL_OUT,
                   "band"),
    "diag8_small": (lambda: [make_jpeg(s, SMALL_HW) for s in range(3)], SMALL_HW, SMALL_OUT,
                    "diag8"),
    "dp_small": (lambda: [make_jpeg(s, SMALL_HW) for s in range(3)], SMALL_HW, SMALL_OUT, "dp"),
    "split_exceptions": (lambda: [make_jpeg(1, (744, 2048))], (744, 2048), (512, 1408),
                         "split12"),
    "odd_source": (lambda: [make_jpeg(4, (371, 1021))], (371, 1021), OUT_HW, "split12"),
    "grayscale": (lambda: [make_jpeg(0, SMALL_HW, mode="L")], SMALL_HW, SMALL_OUT, "split12"),
    "progressive": (lambda: [make_jpeg(2, SMALL_HW, progressive=True), make_jpeg(3, SMALL_HW)],
                    SMALL_HW, SMALL_OUT, "split12"),
    "noisy_small_m": (lambda: [noisy_jpeg((60, 90))], (60, 90), (16, 24), "band"),
}


def case(name):
    make, src, out, grouping = PACK_CASES[name]
    jpegs = make()
    if grouping == "dp":
        grouping = jsteps.optimize_band_groups(jpegs, src, out, max_groups=8)
        assert optimize_band_groups(jpegs, src, out, max_groups=8) == grouping
    return jpegs, src, out, grouping


@pytest.mark.parametrize("name", sorted(PACK_CASES))
def test_packer_fields_and_stats_equal_jax(name):
    jpegs, src, out, grouping = case(name)
    js, jstats, ts, tp = pack_both(jpegs, grouping, src, out)
    assert tp.last_batch_stats == jstats
    assert_fields_equal(js, ts, tp)
    exp = "packed32" if tp._geo.packed_exc["y"] else "pos32+val16"
    assert jstats["exc_format"]["y"] == exp
    assert tp.last_batch_seconds["images"] == len(jpegs)


def test_native_and_numpy_encoders_equal(monkeypatch):
    jpegs = [make_jpeg(s, SMALL_HW) for s in range(2)] + [noisy_jpeg(SMALL_HW)]
    _, _, native, tp = pack_both(jpegs, "split12", SMALL_HW, SMALL_OUT)
    native_stats = tp.last_batch_stats
    monkeypatch.setattr(dct_native, "get_lib", lambda: None)
    packer = DCTWirePacker("image", SMALL_HW, SMALL_OUT, num_threads=1)
    numpy_out = packer._process_batch([sample(SampleDataGroup, DType, j) for j in jpegs])
    assert packer.last_batch_stats == native_stats
    assert_fields_equal(native, numpy_out, packer)


def test_threaded_encode_matches_serial():
    jpegs = [make_jpeg(s, SMALL_HW) for s in range(5)]
    _, stats, serial, tp = pack_both(jpegs, "split12", SMALL_HW, SMALL_OUT, num_threads=1)
    threaded = DCTWirePacker("image", SMALL_HW, SMALL_OUT, num_threads=3)
    out = threaded._process_batch([sample(SampleDataGroup, DType, j) for j in jpegs])
    assert threaded.last_batch_stats == stats
    assert_fields_equal(serial, out, tp)


def test_packer_pickles_without_pool():
    import pickle

    packer = DCTWirePacker("image", SMALL_HW, SMALL_OUT, num_threads=3)
    packer._process_batch([sample(SampleDataGroup, DType, make_jpeg(s, SMALL_HW))
                           for s in range(2)])
    assert packer._pool is not None
    clone = pickle.loads(pickle.dumps(packer))
    assert clone._pool is None
    (out,) = clone._process_batch([sample(SampleDataGroup, DType, make_jpeg(0, SMALL_HW))])
    assert out.path_exists("image_dct_quant")


@pytest.mark.parametrize("src,out,max_groups", [(SRC_HW, OUT_HW, 16), (SMALL_HW, SMALL_OUT, 12),
                                                (SRC_HW, (46, 128), 8)])
def test_optimize_band_groups_equals_jax(src, out, max_groups):
    jpegs = [make_jpeg(s, src) for s in range(2)]
    got = optimize_band_groups(jpegs, src, out, max_groups=max_groups)
    assert got == jsteps.optimize_band_groups(jpegs, src, out, max_groups=max_groups)
    assert len(got) <= max_groups
    with pytest.raises(ValueError):
        optimize_band_groups(jpegs, src, out, max_groups=1)
    if tdct.select_m(src, out) == 1:  # the DC band is the whole spectrum
        assert got == ((0, 1),)
    else:
        with pytest.raises(ValueError):
            optimize_band_groups([], src, out)


# --------------------------------------------------------------------------- #
# device decode
# --------------------------------------------------------------------------- #


def expected_coefficients(packer, jpeg):
    """The packer's own bands times the quantization tables, natural order:
    ``{cs: (m*m, bh*bwp) int32}``."""
    data = packer._read_bands(jpeg)
    m = packer._geo.m
    zz_of = {uv: p for p, uv in enumerate(tdct.band_order(m))}
    out = {}
    for i, cs in enumerate(("y", "c")):
        bands = data[cs].astype(np.int32)
        rows = [bands[zz_of[(u, v)]].reshape(-1) * data["quant"][i, u, v]
                for u in range(m) for v in range(m)]
        out[cs] = np.stack(rows)
    return out


@pytest.mark.parametrize("name", ["split12_bench", "band_small", "dp_small", "split_exceptions",
                                  "grayscale", "progressive", "noisy_small_m"])
def test_integer_decode_bitwise(name):
    jpegs, src, out, grouping = case(name)
    packer = DCTWirePacker("image", src, out, grouping=grouping, num_threads=1)
    samples = packer._process_batch([sample(SampleDataGroup, DType, j) for j in jpegs])
    coef = DCTWireUnpacker("image", src, out, grouping=grouping).coefficients(
        batched_get(samples, packer))
    for i, jpeg in enumerate(jpegs):
        want = expected_coefficients(packer, jpeg)
        for cs in ("y", "c"):
            assert coef[cs].dtype == torch.int32
            np.testing.assert_array_equal(coef[cs][i].numpy(), want[cs], err_msg=cs)


@pytest.mark.parametrize("dc_mode", [0, 1, 2])
@pytest.mark.parametrize("widths", [(0, 0), (1, 1), (3, 2), (12, 0), (14, 9)])
def test_integer_decode_of_forced_modes_and_widths(dc_mode, widths):
    """Every DC predictor and narrow, zero and wide widths (exceptions in
    both formats), on synthetic bands within the reader's |coef| <= 2047."""
    rng = np.random.default_rng(7 * dc_mode + widths[0])
    # source 40x128 to 10x32: m = 2, a luma grid of 5 x 16 blocks
    m, bh, bwp = 2, 5, 16
    small = rng.geometric(0.5, size=(m * m, bh, bwp)).astype(np.int16) - 1
    bands = small * rng.choice(np.array([-1, 1], np.int16), size=small.shape)
    tail = rng.random(bands.shape) < 0.05
    bands[tail] = rng.integers(-2047, 2048, int(tail.sum()))
    groups = [(0, 1), (1, m * m)]
    quant = rng.integers(1, 50, (m, m)).astype(np.int32)
    enc = tdct._CompsetEncoder(bands, groups)
    total = m * m * bh * bwp
    cap = tdct._exc_bucket(sum(enc.exceptions_at(g, dc_mode, b) for g, b in enumerate(widths)))
    excp = np.full((cap,), total, np.int32)
    excv = np.zeros((cap,), np.int16)
    fields, ne = {}, 0
    for g, b in enumerate(widths):
        fields[f"dcty{g}_bp"], ne = enc.pack_group_into(g, dc_mode, b, excp, excv, ne)
    zz_order = {uv: p for p, uv in enumerate(tdct.band_order(m))}
    want = np.stack([bands[zz_order[(u, v)]].reshape(-1).astype(np.int32) * quant[u, v]
                     for u in range(m) for v in range(m)])
    unpacker = DCTWireUnpacker("image", (40, 128), (10, 32), groups)
    assert unpacker._geo.m == m and unpacker._geo.grid["y"] == (bh, bwp)
    for packed in (True, False):
        unpacker._geo.packed_exc["y"] = packed  # both exception formats on one geometry
        f = dict(fields, dcty_mode=np.zeros((dc_mode + 1,), np.uint8))
        if packed:
            f["dcty_excw"] = ((excp.astype(np.uint32) << 14) | excv.astype(np.uint32))
        else:
            f["dcty_excp"], f["dcty_excv"] = excp, excv
        t = {k: torch.from_numpy(v)[None] for k, v in f.items()}
        got = unpacker._coefficients(lambda sfx: t[sfx], "y", torch.from_numpy(quant)[None])
        np.testing.assert_array_equal(got[0].numpy(), want, err_msg=f"packed={packed}")


def test_packed_word_positions_above_2_17():
    """A packed exception word whose position has bit 17 set reads back as a
    negative int32: the mask after the shift restores the position."""
    unpacker = DCTWireUnpacker("image", SRC_HW, OUT_HW)
    total = unpacker._geo.total["y"]
    pos = np.array([(1 << 17) + 5, total - 1, 3, total], np.uint32)
    val = np.array([9, 16383, 0, 0], np.uint32)
    words = torch.from_numpy((pos << 14) | val).view(torch.int32)[None]
    assert int(words[0, 0]) < 0
    p, v = unpacker._exceptions(lambda sfx: words, "y")
    np.testing.assert_array_equal(p[0].numpy(), pos.astype(np.int64))
    np.testing.assert_array_equal(v[0].numpy(), val.astype(np.int32))


@pytest.mark.parametrize("name", ["split12_bench", "diag8_small", "dp_small", "split_exceptions",
                                  "odd_source", "grayscale", "progressive", "noisy_small_m"])
def test_planes_within_one_of_jax(name):
    jpegs, src, out, grouping = case(name)
    js, _, ts, tp = pack_both(jpegs, grouping, src, out)
    y, cbcr = torch_planes(ts, tp, src, out, grouping)
    for i, (jy, jc) in enumerate(jax_planes(js, src, out, grouping)):
        assert y[i].shape == jy.shape and cbcr[i].shape == jc.shape
        assert_within_one(y[i], jy, f"{name} luma {i}")
        assert_within_one(cbcr[i], jc, f"{name} chroma {i}")


def test_grouping_does_not_change_the_decode():
    jpegs = [make_jpeg(3, SMALL_HW)]
    ref = None
    for grouping in ("split12", "band", "diag8", ((0, 1), (1, 6), (6, 15), (15, 36))):
        packer = DCTWirePacker("image", SMALL_HW, SMALL_OUT, grouping=grouping, num_threads=1)
        samples = packer._process_batch([sample(SampleDataGroup, DType, j) for j in jpegs])
        got = torch_planes(samples, packer, SMALL_HW, SMALL_OUT, grouping)
        if ref is None:
            ref = got
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b, err_msg=str(grouping))


def test_quality_contract_against_pixel_path():
    """JAX's own contract (test_dct_wire.py's geometry fuzz and chroma
    bounds) against libjpeg's pixel decode, over random geometries."""
    rng = np.random.default_rng(7)
    groupings = ["band", "split12", "diag8"]
    for i in range(6):
        sh, sw = int(rng.integers(18, 160)), int(rng.integers(18, 200))
        oh = max(2, int(rng.integers(sh // 4, sh + 1)) // 2 * 2)
        ow = max(2, int(rng.integers(sw // 4, sw + 1)) // 2 * 2)
        jb = make_jpeg(seed=i, hw=(sh, sw), quality=int(rng.integers(55, 98)))
        grouping = groupings[i % 3]
        packer = DCTWirePacker("image", (sh, sw), (oh, ow), grouping=grouping, num_threads=1)
        samples = packer._process_batch([sample(SampleDataGroup, DType, jb)])
        y, cbcr = torch_planes(samples, packer, (sh, sw), (oh, ow), grouping)
        ref_y, ref_c = native_jpeg.decode_yuv420(jb, (oh, ow))
        tol = 2 if packer._geo.m >= 6 else 6
        ctx = f"case {i}: src=({sh},{sw}) out=({oh},{ow}) m={packer._geo.m}"
        assert np.abs(y[0].astype(int) - ref_y.astype(int)).max() <= tol, ctx
        assert cbcr[0].shape == (oh // 2, ow // 2, 2), ctx
    jb = make_jpeg(0)
    packer = DCTWirePacker("image", SRC_HW, OUT_HW, num_threads=1)
    samples = packer._process_batch([sample(SampleDataGroup, DType, jb)])
    y, cbcr = torch_planes(samples, packer, SRC_HW, OUT_HW, "split12")
    ref_y, ref_c = native_jpeg.decode_yuv420(jb, OUT_HW)
    assert np.abs(y[0].astype(int) - ref_y.astype(int)).max() <= 2
    d = np.abs(cbcr[0].astype(int) - ref_c.astype(int))
    assert d.mean() <= 6 and np.percentile(d, 99) <= 24 and d.max() <= 48


def test_grayscale_has_neutral_chroma():
    packer = DCTWirePacker("image", SMALL_HW, SMALL_OUT, num_threads=1)
    samples = packer._process_batch([sample(SampleDataGroup, DType,
                                            make_jpeg(0, SMALL_HW, mode="L"))])
    _, cbcr = torch_planes(samples, packer, SMALL_HW, SMALL_OUT, "split12")
    assert (cbcr == 128).all()


def test_step_stacks_occurrences_into_one_decode():
    """Cameras are decoded together: the decode's operator count does not
    grow with the occurrences, and each camera equals its own decode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    jpegs = [make_jpeg(s, SMALL_HW) for s in range(6)]
    packer = DCTWirePacker("image", SMALL_HW, SMALL_OUT, num_threads=1)
    fields = batched_get(packer._process_batch([sample(SampleDataGroup, DType, j)
                                                for j in jpegs]), packer)
    unpacker = DCTWireUnpacker("image", SMALL_HW, SMALL_OUT)

    types = tdct._field_types("image", packer._groups, packer._geo)

    def group(cams):
        cam = SampleDataGroup()
        for n, t in types.items():
            cam.add_data_field(n, t)
        root = SampleDataGroup()
        for c in range(cams):
            root.add_data_group_field(f"cam{c}", cam)
            for n in types:
                v = fields(n[len("image_"):])[2 * c:2 * c + 2]
                root[f"cam{c}"][n] = v.view(torch.uint32) if n.endswith("_excw") else v
        return root

    counts, outs = {}, {}
    for cams in (1, 3):
        data = group(cams)
        unpacker._constants(torch.device("cpu"))
        Count.n = 0
        with Count():
            outs[cams] = unpacker._process(data)
        counts[cams] = Count.n
    assert counts[3] - counts[1] <= 2 * len(tdct._field_names("image", packer._groups,
                                                             packer._geo))
    y, cbcr = unpacker.decode_fields(fields)
    for c in range(3):
        np.testing.assert_array_equal(outs[3][f"cam{c}"]["image"].numpy(), y[2 * c:2 * c + 2])
        np.testing.assert_array_equal(outs[3][f"cam{c}"]["image_cbcr"].numpy(),
                                      cbcr[2 * c:2 * c + 2])


# --------------------------------------------------------------------------- #
# functional API, formats, errors
# --------------------------------------------------------------------------- #


def test_functional_api_equals_jax_and_the_step():
    jb = make_jpeg(7, SMALL_HW)
    fields = compress_jpeg_dct(jb, SMALL_OUT)
    jfields = jsteps.compress_jpeg_dct(jb, SMALL_OUT)
    assert fields["source_hw"] == jfields["source_hw"] == SMALL_HW
    assert fields.keys() == jfields.keys()
    for k in fields:
        if k != "source_hw":
            np.testing.assert_array_equal(fields[k], jfields[k], err_msg=k)
            assert fields[k].dtype == jfields[k].dtype
    y, cbcr = decompress_jpeg_dct(fields, SMALL_OUT, device="cpu")
    assert y.shape == SMALL_OUT and cbcr.shape == (SMALL_OUT[0] // 2, SMALL_OUT[1] // 2, 2)
    import jax

    arrays = {k: v for k, v in jfields.items() if k != "source_hw"}
    jy, jc = jax.jit(lambda a: jsteps.decompress_jpeg_dct({**a, "source_hw": SMALL_HW},
                                                          SMALL_OUT))(arrays)
    assert_within_one(y.numpy(), np.asarray(jy), "luma")
    assert_within_one(cbcr.numpy(), np.asarray(jc), "chroma")
    # tensors decode on their own device, exactly as the step does
    t = {k: (torch.from_numpy(v) if k != "source_hw" else v) for k, v in fields.items()}
    y2, c2 = decompress_jpeg_dct(t, SMALL_OUT)
    packer = DCTWirePacker("image", SMALL_HW, SMALL_OUT, num_threads=1)
    samples = packer._process_batch([sample(SampleDataGroup, DType, jb)])
    sy, sc = torch_planes(samples, packer, SMALL_HW, SMALL_OUT, "split12")
    np.testing.assert_array_equal(y.numpy(), sy[0])
    np.testing.assert_array_equal(y2.numpy(), sy[0])
    np.testing.assert_array_equal(c2.numpy(), sc[0])


def test_decode_runs_its_matmuls_without_tf32(monkeypatch):
    """The functional decode runs outside the executor: its IDCT and resize
    matmuls run at full float32 precision, and the caller's setting comes
    back afterwards."""
    seen = []
    real = torch.matmul

    def recording(*a, **kw):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cuda.matmul.allow_tf32))
        return real(*a, **kw)

    fields = compress_jpeg_dct(make_jpeg(1, SMALL_HW), SMALL_OUT)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        monkeypatch.setattr(torch, "matmul", recording)
        decompress_jpeg_dct(fields, SMALL_OUT, device="cpu")
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert len(seen) == 6 and set(seen) == {("highest", False)}


def test_format_check_round_trips_blueprint_like_jax():
    for pkg, P, U in ((jpipe, jsteps.DCTWirePacker, jsteps.DCTWireUnpacker),
                      (None, DCTWirePacker, DCTWireUnpacker)):
        sdg_cls, dt = (jpipe.SampleDataGroup, jpipe.DType) if pkg else (SampleDataGroup, DType)
        bp = sample(sdg_cls, dt, make_jpeg()).get_empty_like_self()
        mid = P("image", SRC_HW, OUT_HW).check_input_data_format_and_set_output_data_format(bp)
        assert not mid.path_exists("image")
        out = U("image", SRC_HW, OUT_HW).check_input_data_format_and_set_output_data_format(mid)
        assert out.path_exists("image") and out.path_exists("image_cbcr")
        assert not out.path_exists("image_dct_quant")
    jmid = jsteps.DCTWirePacker("image", SRC_HW, OUT_HW).check_input_data_format_and_set_output_data_format(  # noqa: E501
        sample(jpipe.SampleDataGroup, jpipe.DType, make_jpeg()).get_empty_like_self())
    tmid = DCTWirePacker("image", SRC_HW, OUT_HW).check_input_data_format_and_set_output_data_format(  # noqa: E501
        sample(SampleDataGroup, DType, make_jpeg()).get_empty_like_self())
    assert tmid.field_names_flat == jmid.field_names_flat
    assert [t.name for t in tmid.field_types_flat] == [t.name for t in jmid.field_types_flat]


@pytest.mark.parametrize("what", ["mismatched_grouping", "missing_packer", "wrong_type",
                                  "odd_out_hw", "source_size", "not_a_string", "corrupt"])
def test_errors_where_jax_raises(what):
    def run(P, U, sdg_cls, dt):
        if what == "mismatched_grouping":
            mid = P("image", SRC_HW, OUT_HW, grouping="split12") \
                .check_input_data_format_and_set_output_data_format(
                    sample(sdg_cls, dt, make_jpeg()).get_empty_like_self())
            U("image", SRC_HW, OUT_HW, grouping="band") \
                .check_input_data_format_and_set_output_data_format(mid)
        elif what == "missing_packer":
            U("image", SRC_HW, OUT_HW).check_input_data_format_and_set_output_data_format(
                sample(sdg_cls, dt, make_jpeg()).get_empty_like_self())
        elif what == "wrong_type":
            s = sdg_cls()
            s.add_data_field("image", dt.INT32)
            P("image", SRC_HW, OUT_HW).check_input_data_format_and_set_output_data_format(s)
        elif what == "odd_out_hw":
            P("image", SRC_HW, (255, 704))
        elif what == "source_size":
            P("image", (400, 1024), OUT_HW)._process_batch([sample(sdg_cls, dt, make_jpeg())])
        elif what == "not_a_string":
            U(3, SRC_HW, OUT_HW)
        else:
            garbage = np.frombuffer(b"\xff\xd8" + b"\x00" * 64, np.uint8).copy()
            P("image", SRC_HW, OUT_HW)._process_batch([sample(sdg_cls, dt, garbage)])

    errors = []
    for args in ((jsteps.DCTWirePacker, jsteps.DCTWireUnpacker, jpipe.SampleDataGroup,
                  jpipe.DType), (DCTWirePacker, DCTWireUnpacker, SampleDataGroup, DType)):
        with pytest.raises((KeyError, TypeError, ValueError)) as e:
            run(*args)
        errors.append(type(e.value))
    assert errors[0] == errors[1]


def test_unpacker_rejects_fields_of_another_geometry():
    packer = DCTWirePacker("image", SMALL_HW, SMALL_OUT, num_threads=1)
    samples = packer._process_batch([sample(SampleDataGroup, DType, make_jpeg(0, SMALL_HW))])
    with pytest.raises(ValueError, match="must match the packer"):
        DCTWireUnpacker("image", (96, 264), SMALL_OUT).decode_fields(batched_get(samples, packer))


def test_packer_needs_native_libjpeg(monkeypatch):
    monkeypatch.setattr(native_jpeg, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native libjpeg"):
        DCTWirePacker("image", SRC_HW, OUT_HW)


# --------------------------------------------------------------------------- #
# the executor: zero-width groups across the transfer, the slice
# --------------------------------------------------------------------------- #


class _Provider(DataProvider):
    def __init__(self, jpegs):
        self._jpegs = jpegs

    @property
    def sample_data_structure(self):
        s = SampleDataGroup()
        s.add_data_field("image", DType.UINT8)
        return s

    def get_data(self, i):
        s = self.sample_data_structure
        s["image"] = self._jpegs[i % len(self._jpegs)]
        return s

    def get_number_of_samples(self):
        return len(self._jpegs)


def test_zero_width_groups_cross_the_transfer():
    """Smooth content leaves the high bands at width 0: their bitplane
    fields are empty, ride the executor's transfer as empty tensors, and
    the pipeline's decode equals the decode of the host fields."""
    jpegs = [make_jpeg(s, SMALL_HW, quality=50) for s in range(2)]
    steps = [DCTWirePacker("image", SMALL_HW, SMALL_OUT, grouping="band"),
             DCTWireUnpacker("image", SMALL_HW, SMALL_OUT, grouping="band")]
    pipe = PipelineDefinition(ShuffledShardedInputCallable(_Provider(jpegs), batch_size=2,
                                                           shuffle=False), steps) \
        .get_pipeline(batch_size=2, num_threads=1, device="cpu")
    try:
        out = pipe.run()
        widths = steps[0].last_batch_stats["widths"]
        assert 0 in widths["y"] and 0 in widths["c"]
    finally:
        pipe.stop()
    packer = DCTWirePacker("image", SMALL_HW, SMALL_OUT, grouping="band", num_threads=1)
    samples = packer._process_batch([sample(SampleDataGroup, DType, j) for j in jpegs])
    y, cbcr = torch_planes(samples, packer, SMALL_HW, SMALL_OUT, "band")
    np.testing.assert_array_equal(out["image"].numpy(), y)
    np.testing.assert_array_equal(out["image_cbcr"].numpy(), cbcr)


HW, CAMS, HM_HW, BATCH, SAMPLES = SMALL_HW, 2, (16, 44), 2, 8


class _JaxJpegProvider(JDataProvider):
    """The port's MultiCameraJpegProvider on the JAX package's classes."""

    def __init__(self):
        self._jpegs = encode_bench_jpegs(2 * CAMS, HW)

    @property
    def sample_data_structure(self):
        return sample_structure(jpipe.SampleDataGroup, jpipe.DType, CAMS)

    def get_data(self, i):
        return fill_sample(self.sample_data_structure, self._jpegs, i, CAMS, HW, 32, 10)

    def get_number_of_samples(self):
        return SAMPLES


def jax_dct_pipeline(grouping):
    s = jsteps
    steps = [
        s.DCTWirePacker("image", HW, SMALL_OUT, grouping=grouping),
        s.DCTWireUnpacker("image", HW, SMALL_OUT, grouping=grouping),
        s.YCbCrToRGBConverter("image"),
        s.AffineTransformer(
            output_hw=SMALL_OUT, resizing_mode=s.AffineTransformer.ResizingMode.STRETCH,
            image_field_names="image",
            transformation_steps=[
                s.AffineTransformer.UniformScaling(0.0, 0.9, 1.1),
                s.AffineTransformer.Translation(0.0, [-16.0, -16.0], [16.0, 16.0]),
            ],
        ),
        s.PhotoMetricDistorter(
            "image", min_max_brightness=[-16.0, 16.0], min_max_hue=[-10.0, 10.0],
            min_max_contrast=[0.8, 1.2], min_max_saturation=[0.8, 1.2],
            prob_brightness_aug=0.0, prob_hue_aug=0.0, prob_contrast_aug=0.0,
            prob_saturation_aug=0.0, prob_swap_channels=0.0,
        ),
        s.BoundingBoxToHeatmapConverter(
            annotation_field_name="annotations", bboxes_in_name="bboxes",
            heatmap_out_name="heatmap", heatmap_hw=HM_HW, image_hw_field_name="image_hw",
            categories_in_name="categories", num_categories=10,
            is_active_opt_out_name="active", center_opt_out_name="center",
            center_offset_opt_out_name="offset",
        ),
        s.ImageMeanStdDevNormalizer("image", mean=[103.5, 116.3, 123.7],
                                    std_dev=[57.4, 57.1, 58.4]),
    ]
    inp = JInput(_JaxJpegProvider(), batch_size=BATCH, shuffle=True)
    definition = jpipe.PipelineDefinition(inp, steps, check_data_format=False,
                                          copy_external_source_passthrough_outputs=False)
    return definition.get_pipeline(batch_size=BATCH, num_threads=2, seed=0)


def _outputs(pipe, n):
    outs = []
    try:
        for _ in range(n):
            outs.append({k: np.asarray(v) for k, v in pipe.run().items()})
    finally:
        pipe.stop()
    return outs


def test_slice_matches_jax_without_augmentation():
    """The DCT wire's slice: images within the propagated tolerance (a plane
    value 1 apart moves an RGB value by at most 1 + 1.772 before rounding,
    so 3 levels, and the warp may add 1: 4 levels over the smallest std,
    57.1), in a small share; heatmaps as in test_torch_slice.py; the rest
    exact."""
    pipe = build_pipeline(batch_size=BATCH, device="cpu", num_threads=2, hw=HW, num_cams=CAMS,
                          out_hw=SMALL_OUT, heatmap_hw=HM_HW, num_samples=SAMPLES, num_unique=2,
                          affine_prob=0.0, photometric_prob=0.0)  # the default wire: dct
    packer = next(s for s in pipe._host_steps if isinstance(s, DCTWirePacker))
    probe = [_JaxJpegProvider().get_data(i)["cameras"][0]["image"] for i in range(3)]
    grouping = jsteps.optimize_band_groups(probe, HW, SMALL_OUT, max_groups=16)
    assert tuple(packer.groups) == grouping
    torch_out = _outputs(pipe, 2)
    jax_out = _outputs(jax_dct_pipeline(grouping), 2)
    for j, t in zip(jax_out, torch_out):
        assert set(j) == set(t)
        for name in j:
            g, w = t[name], j[name]
            assert g.shape == w.shape and g.dtype == w.dtype, name
            if name.endswith(".image"):
                np.testing.assert_allclose(g, w, rtol=0, atol=4 / 57.1 + 1e-5, err_msg=name)
                assert float(np.mean(g != w)) < 0.01, name
            elif name.endswith("heatmap"):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)


def test_build_pipeline_groupings():
    provider = MultiCameraJpegProvider(num_samples=4, num_unique=1, hw=HW, num_cams=1)
    for g in ("split12", "band", "diag8"):
        assert dct_grouping(g, provider, HW, SMALL_OUT) == g
    pairs = ((0, 1), (1, 36))
    assert dct_grouping(list(pairs), provider, HW, SMALL_OUT) == pairs
    probe = [provider.get_data(i)["cameras"][0]["image"] for i in range(3)]  # bench.py's
    assert all(np.array_equal(provider.jpeg(i), p) for i, p in enumerate(probe))
    assert dct_grouping("dp5", provider, HW, SMALL_OUT) == jsteps.optimize_band_groups(
        probe, HW, SMALL_OUT, max_groups=5)
    for bad in ("dp", "dpx", "split", "DP16"):
        with pytest.raises(ValueError, match="grouping must be"):
            dct_grouping(bad, provider, HW, SMALL_OUT)
    pipe = build_pipeline(batch_size=1, device="cpu", num_threads=1, hw=HW, num_cams=1,
                          out_hw=SMALL_OUT, heatmap_hw=HM_HW, num_samples=2, num_unique=1,
                          grouping="band")
    try:
        packer = next(s for s in pipe._host_steps if isinstance(s, DCTWirePacker))
        assert packer.groups == tdct.band_groups(6, "band")
        out = pipe.run()
        assert tuple(out["cameras.[0].image"].shape) == (1,) + SMALL_OUT + (3,)
    finally:
        pipe.stop()

