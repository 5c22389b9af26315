"""The lossless plane codec of the YUV wire, in both packages.

The port's ``WirePlanePacker`` and ``compress_plane`` (the C++ encoder
``pipeline/csrc/wirepack.cpp``, a byte-identical copy of the JAX package's)
must write the same bytes as the JAX package's for the same planes, and as
the port's own numpy twin (``_residuals``/``_pack_fields``); the port's
batched ``WirePlaneUnpacker`` must give back every plane bit for bit:
random shapes and content, a constant plane (no bitplanes at all), spikes
(exceptions), both predictors, and the batched exception scatter whose
padding index of one sample would be the first element of the next.
"""

import numpy as np
import pytest
import torch

import accvlab_tpu.pipeline as jpipe
import accvlab_tpu.pipeline.processing_steps as jsteps
from accvlab_tpu.pipeline.processing_steps import wire_compression as jwc
from accvlab_tpu_torch.pipeline import DType, SampleDataGroup, wire_native
from accvlab_tpu_torch.pipeline.processing_steps import (
    WirePlanePacker,
    WirePlaneUnpacker,
    compress_plane,
    decompress_plane,
)
from accvlab_tpu_torch.pipeline.processing_steps import wire_compression as twc

SFX = ("bp", "excp", "excv", "mode")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_plane(kind, shape=(24, 32), seed=0):
    """The JAX package's test planes (tests/test_wire_compression.py)."""
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        from PIL import Image

        base = rng.integers(96, 192, (shape[0] // 8, shape[1] // 8), np.uint8)
        return np.asarray(Image.fromarray(base).resize(shape[::-1], Image.BILINEAR), np.uint8)
    if kind == "noise":
        return rng.integers(0, 256, shape, np.uint8)
    if kind == "constant":
        return np.full(shape, 137, np.uint8)
    if kind == "gradient":
        return ((np.arange(shape[0])[:, None] + np.arange(shape[1])[None, :]) % 256).astype(
            np.uint8)
    if kind == "spikes":
        p = np.full(shape, 100, np.uint8)
        idx = rng.integers(0, shape[0] * shape[1], 7)
        p.reshape(-1)[idx] = rng.integers(0, 256, 7)
        return p
    raise AssertionError(kind)


def fuzz_planes(seed=42, trials=30):
    """Shapes (2-D/3-D/4-D) and content mixes of the JAX package's fuzz test."""
    rng = np.random.default_rng(seed)
    for trial in range(trials):
        ndim = int(rng.integers(2, 5))
        h = int(rng.integers(1, 20))
        if ndim == 2:
            shape = (h, int(rng.integers(1, 12)) * 8)
        elif ndim == 3:
            w = int(rng.integers(1, 10))
            c = int(rng.integers(1, 5))
            while (w * c) % 8 != 0:
                c += 1
            shape = (h, w, c)
        else:
            shape = (h, 4, 2, int(rng.integers(1, 4)))
        kind = trial % 4
        if kind == 0:
            plane = rng.integers(0, 256, shape, np.uint8)
        elif kind == 1:
            plane = np.full(shape, int(rng.integers(0, 256)), np.uint8)
        elif kind == 2:  # smooth ramp + sparse spikes
            plane = (np.arange(np.prod(shape)) % 256).reshape(shape).astype(np.uint8)
            flat = plane.reshape(-1)
            idx = rng.integers(0, flat.size, max(1, flat.size // 50))
            flat[idx] = rng.integers(0, 256, idx.size)
        else:  # low-amplitude noise around a level
            plane = (128 + rng.integers(-6, 7, shape)).astype(np.uint8)
        yield trial, plane


def yuv_planes(n=3, hw=(32, 64), seed=0):
    """Y ``(H, W)`` and CbCr ``(H/2, W/2, 2)`` planes of smooth content."""
    rng = np.random.default_rng(seed)
    from PIL import Image

    out = []
    for _ in range(n):
        base = rng.integers(0, 255, (hw[0] // 8, hw[1] // 8, 3), np.uint8)
        img = np.asarray(Image.fromarray(base, "RGB").resize(hw[::-1], Image.BILINEAR)
                         .convert("YCbCr"), np.uint8)
        c16 = img[..., 1:].astype(np.uint16)
        cbcr = ((c16[0::2, 0::2] + c16[1::2, 0::2] + c16[0::2, 1::2] + c16[1::2, 1::2] + 2)
                >> 2).astype(np.uint8)
        out.append((img[..., 0].copy(), cbcr))
    return out


def decode_batched(fields_per_sample):
    """Stack per-sample wire fields and decode them in one batched call."""
    stacked = [torch.from_numpy(np.stack([f[s] for f in fields_per_sample])) for s in SFX]
    return WirePlaneUnpacker._decode(*stacked).numpy()


def pack_batch(step_cls, sdg_cls, dtype_cls, planes, names=("p",)):
    """``planes``: per sample, one plane per name. Returns the packed samples."""
    samples = []
    for per_name in planes:
        sdg = sdg_cls()
        for name, plane in zip(names, per_name):
            sdg.add_data_field(name, dtype_cls.UINT8)
            sdg[name] = plane
        samples.append(sdg)
    step = step_cls(list(names))
    return step, step._process_batch(samples)


def fields_of(sample, name):
    return {s: np.asarray(sample[f"{name}_wire_{s}"]) for s in SFX}


# ------------------------- encoder bytes -------------------------------- #


def test_compress_plane_bytes_equal_jax_fuzz():
    for trial, plane in fuzz_planes():
        got, want = compress_plane(plane), jwc.compress_plane(plane)
        for s in SFX:
            assert got[s].dtype == want[s].dtype and got[s].shape == want[s].shape, (trial, s)
            np.testing.assert_array_equal(got[s], want[s], err_msg=f"trial {trial} {s}")


@pytest.mark.parametrize("kind", ["smooth", "noise", "constant", "gradient", "spikes"])
def test_compress_plane_bytes_equal_jax_kinds(kind):
    plane = make_plane(kind, shape=(40, 64))
    got, want = compress_plane(plane), jwc.compress_plane(plane)
    for s in SFX:
        np.testing.assert_array_equal(got[s], want[s], err_msg=s)
        assert got[s].dtype == want[s].dtype


def test_packer_bytes_equal_jax_on_yuv_batch():
    planes = yuv_planes()
    tstep, tout = pack_batch(WirePlanePacker, SampleDataGroup, DType, planes,
                             ("image", "image_cbcr"))
    jstep, jout = pack_batch(jsteps.WirePlanePacker, jpipe.SampleDataGroup, jpipe.DType,
                             planes, ("image", "image_cbcr"))
    for t, j in zip(tout, jout):
        assert t.field_names_flat == j.field_names_flat
        for name in ("image", "image_cbcr"):
            got, want = fields_of(t, name), fields_of(j, name)
            for s in SFX:
                assert got[s].dtype == want[s].dtype
                np.testing.assert_array_equal(got[s], want[s], err_msg=f"{name} {s}")
    assert tstep.last_batch_stats == jstep.last_batch_stats
    assert tstep.last_batch_stats["image_cbcr"]["raw_bytes"] == 3 * 16 * 32 * 2


def test_packer_batch_with_mixed_content_equals_jax():
    """Constant, smooth and noise planes in one batch: one mode, one width,
    one exception capacity for the batch, as the JAX package chooses."""
    planes = [(make_plane(k),) for k in ("constant", "smooth", "noise")]
    tstep, tout = pack_batch(WirePlanePacker, SampleDataGroup, DType, planes)
    jstep, jout = pack_batch(jsteps.WirePlanePacker, jpipe.SampleDataGroup, jpipe.DType, planes)
    shapes = {tuple(v.shape for v in fields_of(t, "p").values()) for t in tout}
    assert len(shapes) == 1
    for t, j in zip(tout, jout):
        for s in SFX:
            np.testing.assert_array_equal(fields_of(t, "p")[s], fields_of(j, "p")[s])
    assert tstep.last_batch_stats == jstep.last_batch_stats


def test_native_encoder_matches_numpy_twin():
    rng = np.random.default_rng(7)
    cases = [
        rng.integers(0, 256, (24, 32), np.uint8),
        rng.integers(0, 256, (9, 8, 2), np.uint8),
        make_plane("smooth", shape=(40, 64)),
        np.full((5, 16), 77, np.uint8),
        rng.integers(0, 256, (1, 24), np.uint8),  # H=1
    ]
    for plane in cases:
        group = int(np.prod(plane.shape[2:], dtype=np.int64))
        p2d = np.ascontiguousarray(plane.reshape(plane.shape[0], -1))
        h1, h2 = wire_native.analyze(p2d, group)
        zz1, zz2 = twc._residuals(plane)
        np.testing.assert_array_equal(np.cumsum(h1), twc._hist_cum(zz1))
        np.testing.assert_array_equal(np.cumsum(h2), twc._hist_cum(zz2))
        for mode, zz in ((twc._MODE_VERTICAL, zz1), (twc._MODE_PLANE, zz2)):
            for b in (0, 2, 5, 9):
                cap = max(64, int((zz >= (1 << b)).sum()))
                got = wire_native.pack(p2d, group, mode, b, cap)
                want = twc._pack_fields(zz, b, cap)
                for g, w, what in zip(got, want, ("bp", "excp", "excv")):
                    np.testing.assert_array_equal(
                        g, w, err_msg=f"{plane.shape} mode={mode} b={b} {what}")


def test_numpy_twin_equals_jax_numpy_encoder():
    for _, plane in fuzz_planes(seed=5, trials=12):
        for t, j in zip(twc._residuals(plane), jwc._residuals(plane)):
            np.testing.assert_array_equal(t, j)
        zz = twc._residuals(plane)[1]
        cap = twc._next_pow2(int((zz >= 8).sum()))
        for got, want in zip(twc._pack_fields(zz, 3, cap), jwc._pack_fields(zz, 3, cap)):
            np.testing.assert_array_equal(got, want)


def test_native_encoder_checks_layout():
    with pytest.raises(TypeError, match="2-D uint8"):
        wire_native.analyze(np.zeros((4, 8), np.int16), 1)
    with pytest.raises(ValueError, match="C-contiguous"):
        wire_native.analyze(np.zeros((4, 16), np.uint8)[:, ::2], 1)
    with pytest.raises(ValueError, match="divisible by 8"):
        wire_native.analyze(np.zeros((4, 12), np.uint8), 1)
    with pytest.raises(ValueError, match="group"):
        wire_native.analyze(np.zeros((4, 16), np.uint8), 3)


def test_width_model_and_zigzag_equal_jax():
    r = np.array([0, -1, 1, -2, 2, -255, 255, 510, -510], np.int16)
    np.testing.assert_array_equal(twc._zigzag(r), jwc._zigzag(r))
    zz = np.full((1000,), 7, np.uint16)
    zz[:5] = 510
    for values in (np.zeros((100,), np.uint16), np.full((100,), 31, np.uint16), zz):
        assert twc._optimal_width(values) == jwc._optimal_width(values)
    assert twc._optimal_width(zz)[0] == 3
    for n in (0, 1, 64, 65, 1000):
        assert twc._next_pow2(n) == jwc._next_pow2(n)
    fits = [0, 10, 50, 90, 99, 100, 100, 100, 100, 100, 100]
    assert twc.optimal_width_from_fits(fits, 100, 10) == jwc.optimal_width_from_fits(
        fits, 100, 10)


# ------------------------- decode --------------------------------------- #


def test_decode_fuzz_bitwise():
    for trial, plane in fuzz_planes():
        got = decompress_plane(compress_plane(plane)).numpy()
        assert got.shape == plane.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, plane, err_msg=f"trial {trial} shape {plane.shape}")


def test_decode_equals_jax_decode():
    import jax

    for trial, plane in fuzz_planes(seed=3, trials=8):
        fields = compress_plane(plane)
        want = np.asarray(jax.jit(jwc.decompress_plane)(fields))
        np.testing.assert_array_equal(decompress_plane(fields).numpy(), want)


def test_constant_plane_has_no_bitplanes():
    planes = [(make_plane("constant"),), (make_plane("constant"),)]
    _, out = pack_batch(WirePlanePacker, SampleDataGroup, DType, planes)
    fields = [fields_of(s, "p") for s in out]
    assert fields[0]["bp"].shape[0] == 0
    assert int((fields[0]["excp"] < 24 * 32).sum()) <= 1  # the raw top-left value
    got = decode_batched(fields)
    np.testing.assert_array_equal(got, np.stack([p[0] for p in planes]))


def test_spike_plane_uses_exceptions():
    plane = make_plane("spikes")
    fields = compress_plane(plane)
    n_exc = int((fields["excp"] < plane.size).sum())
    assert 0 < n_exc <= 29 and fields["bp"].shape[0] <= 2
    np.testing.assert_array_equal(decompress_plane(fields).numpy(), plane)


def test_both_predictor_modes_decode():
    modes = set()
    for kind in ("noise", "smooth", "gradient"):
        plane = make_plane(kind, shape=(64, 96))
        fields = compress_plane(plane)
        modes.add(fields["mode"].shape[0])
        np.testing.assert_array_equal(decompress_plane(fields).numpy(), plane)
    assert modes == {1, 2}


def test_batched_scatter_padding_stays_in_its_sample():
    """Sample 0 has exceptions and padding slots (index H*Wr); sample 1's
    first element is a real nonzero value that is not an exception. A
    scatter into the flattened batch would write sample 0's padding onto it."""
    h, w = 24, 32
    spikes = make_plane("spikes", (h, w))
    # low-amplitude content sets a few bits of width for the batch; the
    # top-left value 2 (zigzag 4) fits them
    second = (2 + np.random.default_rng(1).integers(0, 3, (h, w))).astype(np.uint8)
    second[0, 0] = 2
    _, out = pack_batch(WirePlanePacker, SampleDataGroup, DType, [(spikes,), (second,)])
    fields = [fields_of(s, "p") for s in out]
    assert (fields[0]["excp"] == h * w).any() and (fields[0]["excp"] < h * w).any()
    assert not (fields[1]["excp"] == 0).any()
    got = decode_batched(fields)
    np.testing.assert_array_equal(got[1], second)
    np.testing.assert_array_equal(got[0], spikes)


def test_batched_decode_of_yuv_planes():
    planes = yuv_planes(n=4, seed=1)
    _, out = pack_batch(WirePlanePacker, SampleDataGroup, DType, planes,
                        ("image", "image_cbcr"))
    for i, name in enumerate(("image", "image_cbcr")):
        got = decode_batched([fields_of(s, name) for s in out])
        np.testing.assert_array_equal(got, np.stack([p[i] for p in planes]))


# ------------------------- validation ----------------------------------- #


def _one(name, value, dtype=DType.UINT8):
    sdg = SampleDataGroup()
    sdg.add_data_field(name, dtype)
    sdg[name] = value
    return sdg


def test_packer_rejects_bad_planes_like_jax():
    for bad, match in ((np.zeros((8, 9), np.uint8), "divisible by 8"),
                       (np.zeros((8,), np.uint8), ">=2-D")):
        with pytest.raises(ValueError, match=match):
            WirePlanePacker("p")._process_batch([_one("p", bad)])
        jsdg = jpipe.SampleDataGroup()
        jsdg.add_data_field("p", jpipe.DType.UINT8)
        jsdg["p"] = bad
        with pytest.raises(ValueError, match=match):
            jsteps.WirePlanePacker("p")._process_batch([jsdg])


def test_blueprint_errors_like_jax():
    bp = SampleDataGroup()
    bp.add_data_field("p", DType.FLOAT)
    with pytest.raises(TypeError, match="UINT8"):
        WirePlanePacker("p").check_input_data_format_and_set_output_data_format(bp)
    bp = SampleDataGroup()
    bp.add_data_field("p", DType.UINT8)
    with pytest.raises(KeyError, match="WirePlanePacker ahead"):
        WirePlaneUnpacker("p").check_input_data_format_and_set_output_data_format(bp)
    with pytest.raises(KeyError, match="none of"):
        WirePlanePacker("q").check_input_data_format_and_set_output_data_format(bp)
    for cls in (WirePlanePacker, WirePlaneUnpacker):
        with pytest.raises(ValueError, match="at least one field"):
            cls([])
    mid = WirePlanePacker("p").check_input_data_format_and_set_output_data_format(bp)
    jbp = jpipe.SampleDataGroup()
    jbp.add_data_field("p", jpipe.DType.UINT8)
    jmid = jsteps.WirePlanePacker("p").check_input_data_format_and_set_output_data_format(jbp)
    assert mid.field_names_flat == jmid.field_names_flat
    assert [t.name for t in mid.field_types_flat] == [t.name for t in jmid.field_types_flat]
    out = WirePlaneUnpacker("p").check_input_data_format_and_set_output_data_format(mid)
    assert out.field_names_flat == ("p",)
    mid.remove_field("p_wire_excv")
    with pytest.raises(KeyError, match="p_wire_excv"):
        WirePlaneUnpacker("p").check_input_data_format_and_set_output_data_format(mid)
