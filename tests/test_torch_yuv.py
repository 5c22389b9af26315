"""The YUV 4:2:0 wire of bench.py, in both packages: colour conversion, the
image decoder, bench.py's JPEG dataset and the wire slice end to end.

* Colour: the port's ``ycbcr420_to_rgb`` against the JAX package's (numpy and
  jitted XLA) for all three matrices and both ranges, within 1 on uint8
  with the share of differing values bounded (the port runs each multiply
  and add on its own; XLA may fuse them). The converter's checks match.
* Decoder: on the PIL path, both packages run with ``native_jpeg.available``
  patched to False, the path they take on a host without libjpeg; on the
  libjpeg path nothing is patched. Planes must be bitwise equal.
* Dataset: the port's JPEG bytes equal those of bench.py's ``build_dataset``
  for the same size, and the two share bench.py's cache file format.
* Slice: ``build_pipeline(wire="yuv")`` against the same steps in the JAX
  package at 2 cameras of 96x256, batch 2, output 64x176, augmentation off,
  packed and unpacked, at test_torch_slice.py's tolerances.
"""

import io

import numpy as np
import pytest
import torch

import accvlab_tpu.color as jcolor
import accvlab_tpu.pipeline as jpipe
import accvlab_tpu.pipeline.native_jpeg as jnative_jpeg
import accvlab_tpu.pipeline.processing_steps as jsteps
from accvlab_tpu.pipeline.inputs import DataProvider as JDataProvider
from accvlab_tpu.pipeline.inputs import ShuffledShardedInputCallable as JInput
from accvlab_tpu_torch import color as tcolor
from accvlab_tpu_torch.bench_pipeline import build_pipeline
from accvlab_tpu_torch.pipeline import DType, SampleDataGroup
from accvlab_tpu_torch.pipeline.inputs.multicam_jpeg import (
    MultiCameraJpegProvider,
    bench_cache_dir,
    cache_file,
    encode_bench_jpegs,
)
from accvlab_tpu_torch.pipeline.inputs.multicam_synthetic import fill_sample, sample_structure
from accvlab_tpu_torch.pipeline.processing_steps import ImageDecoder, YCbCrToRGBConverter

HW, CAMS, OUT_HW, HM_HW, BATCH, SAMPLES = (96, 256), 2, (64, 176), (16, 44), 2, 8
MATRICES = ["bt601", "bt709", "bt2020"]
RANGES = ["full", "limited"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_pil_decoder(monkeypatch):
    """Both packages' ImageDecoder on its PIL path, as on a host without
    libjpeg: the port's default ``decoder="auto"`` follows JAX's rule, which
    then takes PIL in both."""
    from accvlab_tpu_torch.pipeline import native_jpeg

    monkeypatch.setattr(jnative_jpeg, "available", lambda: False)
    monkeypatch.setattr(native_jpeg, "available", lambda: False)


def assert_within_one(got, want, max_share=0.01, what=""):
    """uint8 values within 1, and at most ``max_share`` of them differing."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max(initial=0) <= 1, what
    assert float(np.mean(d > 0)) <= max_share, (what, float(np.mean(d > 0)))


# ------------------------- colour --------------------------------------- #


@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("color_range", RANGES)
def test_ycbcr420_to_rgb_matches_jax(matrix, color_range):
    import jax

    rng = np.random.default_rng(MATRICES.index(matrix) * 2 + RANGES.index(color_range))
    y = rng.integers(0, 256, (3, 64, 96), np.uint8)
    cbcr = rng.integers(0, 256, (3, 32, 48, 2), np.uint8)
    got = tcolor.ycbcr420_to_rgb(torch.from_numpy(y), torch.from_numpy(cbcr), matrix,
                                 color_range).numpy()
    want_np = jcolor.ycbcr420_to_rgb(y, cbcr, matrix, color_range)
    want_xla = np.asarray(jax.jit(
        lambda a, b: jcolor.ycbcr420_to_rgb(a, b, matrix, color_range))(y, cbcr))
    assert got.shape == (3, 64, 96, 3) and got.dtype == np.uint8
    assert_within_one(got, want_np, what="numpy")
    assert_within_one(got, want_xla, what="xla")


def test_coefficients_and_errors_match_jax():
    for m in MATRICES:
        for r in RANGES:
            assert tcolor.ycbcr_coefficients(m, r) == jcolor.ycbcr_coefficients(m, r)
    for kw, match in (({"matrix": "bt470"}, "matrix must be one of"),
                      ({"color_range": "tv"}, "color_range must be")):
        with pytest.raises(ValueError, match=match):
            tcolor.ycbcr_coefficients(**kw)
        with pytest.raises(ValueError, match=match):
            jcolor.ycbcr_coefficients(**kw)


def test_subsample_and_planes_to_wire_match_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (8, 12, 3), np.uint8)
    for t, j in zip(tcolor.subsample_chroma_420(img), jcolor.subsample_chroma_420(img)):
        np.testing.assert_array_equal(t, j)
        assert t.dtype == j.dtype
    u, v = rng.integers(0, 256, (2, 4, 6), np.uint8)
    np.testing.assert_array_equal(tcolor.yuv420p_planes_to_wire(u, v),
                                  jcolor.yuv420p_planes_to_wire(u, v))
    for bad, match in ((np.zeros((7, 8, 3), np.uint8), "even"),
                       (np.zeros((8, 8, 4), np.uint8), "YCbCr")):
        with pytest.raises(ValueError, match=match):
            tcolor.subsample_chroma_420(bad)


def _converter_blueprint(sdg_cls, dtype_cls, chroma=True, y_type="UINT8"):
    bp = sdg_cls()
    bp.add_data_field("image", getattr(dtype_cls, y_type))
    if chroma:
        bp.add_data_field("image_cbcr", dtype_cls.UINT8)
    return bp


@pytest.mark.parametrize("case,err,match", [
    ("no_chroma", KeyError, "image_cbcr"),
    ("float_y", TypeError, "must be UINT8"),
    ("no_image", KeyError, "No occurrences"),
])
def test_converter_blueprint_errors_match_jax(case, err, match):
    for cls, sdg_cls, dtype_cls in ((YCbCrToRGBConverter, SampleDataGroup, DType),
                                    (jsteps.YCbCrToRGBConverter, jpipe.SampleDataGroup,
                                     jpipe.DType)):
        bp = _converter_blueprint(sdg_cls, dtype_cls, chroma=case != "no_chroma",
                                  y_type="FLOAT" if case == "float_y" else "UINT8")
        step = cls("img" if case == "no_image" else "image")
        with pytest.raises(err, match=match):
            step.check_input_data_format_and_set_output_data_format(bp)


def test_converter_construction_errors_match_jax():
    for cls in (YCbCrToRGBConverter, jsteps.YCbCrToRGBConverter):
        with pytest.raises(ValueError, match="string image_name"):
            cls(0)
        with pytest.raises(ValueError, match="matrix"):
            cls("image", matrix="xyz")
        with pytest.raises(ValueError, match="color_range"):
            cls("image", color_range="xyz")
    assert YCbCrToRGBConverter.placement == jsteps.YCbCrToRGBConverter.placement == "device"


@pytest.mark.parametrize("as_bgr", [False, True])
def test_converter_batched_matches_jax(as_bgr):
    import jax

    rng = np.random.default_rng(4)
    y = rng.integers(0, 256, (2, 16, 24), np.uint8)
    cbcr = rng.integers(0, 256, (2, 8, 12, 2), np.uint8)
    step = YCbCrToRGBConverter("image", matrix="bt709", color_range="limited", as_bgr=as_bgr)
    sdg = _converter_blueprint(SampleDataGroup, DType)
    sdg["image"], sdg["image_cbcr"] = torch.from_numpy(y), torch.from_numpy(cbcr)
    out = step(sdg)
    assert out.field_names_flat == ("image",)
    jstep = jsteps.YCbCrToRGBConverter("image", matrix="bt709", color_range="limited",
                                       as_bgr=as_bgr)

    def one(a, b):
        s = _converter_blueprint(jpipe.SampleDataGroup, jpipe.DType)
        s["image"], s["image_cbcr"] = a, b
        return jstep._process(s)["image"]

    want = np.asarray(jax.jit(jax.vmap(one))(y, cbcr))
    assert_within_one(out["image"].numpy(), want)


# ------------------------- decoder -------------------------------------- #


def encode(img, fmt="JPEG", quality=92):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, quality=quality)
    return np.frombuffer(buf.getvalue(), np.uint8).copy()


def smooth_image(hw, seed, mode="RGB"):
    from PIL import Image

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (max(1, hw[0] // 8), max(1, hw[1] // 8), 3), np.uint8)
    img = Image.fromarray(base).resize((hw[1], hw[0]), Image.BILINEAR)
    return np.asarray(img.convert(mode), np.uint8)


def decode_both(encoded, **kw):
    """The same ImageDecoder arguments in both packages on one encoded image."""
    outs = []
    for cls, sdg_cls, dtype_cls in ((ImageDecoder, SampleDataGroup, DType),
                                    (jsteps.ImageDecoder, jpipe.SampleDataGroup, jpipe.DType)):
        step = cls("image", **kw)
        sdg = sdg_cls()
        sdg.add_data_field("image", dtype_cls.UINT8)
        sdg["image"] = encoded
        out = step(sdg)
        outs.append({n: np.asarray(v) for n, v in zip(out.field_names_flat, out.get_data())})
    return outs


DECODE_CASES = {
    "jpeg": (lambda: encode(smooth_image((32, 48), 0)), {}),
    "jpeg_resize": (lambda: encode(smooth_image((40, 64), 7)), {"decode_resize_hw": (24, 32)}),
    "jpeg_odd": (lambda: encode(smooth_image((33, 47), 9)), {}),
    "jpeg_hint": (lambda: encode(smooth_image((372, 512), 10)),
                  {"decode_scale_hint_hw": (93, 128)}),
    "jpeg_gray": (lambda: encode(smooth_image((32, 48), 3, "L")), {}),
    "png": (lambda: encode(smooth_image((20, 30), 5), "PNG"), {}),
    "bench_shape": (lambda: encode(smooth_image((372, 1024), 1), quality=90),
                    {"decode_resize_hw": (256, 704)}),
}


@pytest.mark.parametrize("wire_format", ["rgb", "yuv420"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decoder_planes_equal_jax_pil_path(jax_pil_decoder, case, wire_format):
    make, kw = DECODE_CASES[case]
    got, want = decode_both(make(), wire_format=wire_format, **kw)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    if wire_format == "yuv420":
        h, w = got["image"].shape
        assert h % 2 == 0 and w % 2 == 0 and got["image_cbcr"].shape == (h // 2, w // 2, 2)


def test_decoder_as_bgr_equals_jax(jax_pil_decoder):
    got, want = decode_both(encode(smooth_image((32, 48), 2)), as_bgr=True)
    np.testing.assert_array_equal(got["image"], want["image"])


def test_decoder_odd_source_replicates_the_border():
    (got, _) = decode_both(encode(smooth_image((33, 47), 9)), wire_format="yuv420")
    assert got["image"].shape == (34, 48) and got["image_cbcr"].shape == (17, 24, 2)
    np.testing.assert_array_equal(got["image"][33], got["image"][32])
    np.testing.assert_array_equal(got["image"][:, 47], got["image"][:, 46])


@pytest.mark.parametrize("kw,match", [
    ({"as_bgr": True, "wire_format": "yuv420"}, "as_bgr"),
    ({"wire_format": "nv12"}, "wire_format"),
    ({"wire_format": "yuv420", "decode_resize_hw": (25, 32)}, "even decode_resize_hw"),
])
def test_decoder_construction_errors_match_jax(kw, match):
    for cls in (ImageDecoder, jsteps.ImageDecoder):
        with pytest.raises(ValueError, match=match):
            cls("image", **kw)
    for cls in (ImageDecoder, jsteps.ImageDecoder):
        with pytest.raises(ValueError, match="string"):
            cls(0, wire_format="yuv420")


def test_decoder_blueprint_errors_match_jax():
    for cls, sdg_cls, dtype_cls in ((ImageDecoder, SampleDataGroup, DType),
                                    (jsteps.ImageDecoder, jpipe.SampleDataGroup, jpipe.DType)):
        bp = sdg_cls()
        bp.add_data_field("image", dtype_cls.FLOAT)
        with pytest.raises(TypeError, match="must be UINT8"):
            cls("image").check_input_data_format_and_set_output_data_format(bp)
        with pytest.raises(KeyError, match="No occurrences"):
            cls("img").check_input_data_format_and_set_output_data_format(bp)
        bp = sdg_cls()
        bp.add_data_field("image", dtype_cls.UINT8)
        bp.add_data_field("image_cbcr", dtype_cls.UINT8)
        with pytest.raises(KeyError, match="already exists"):
            cls("image", wire_format="yuv420").check_input_data_format_and_set_output_data_format(
                bp)


# ------------------------- bench.py's dataset --------------------------- #


def test_jpeg_dataset_equals_bench_recipe_and_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    # importing bench.py sets this default; keep it out of the rest of the run
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax"))
    import bench

    hw, cams = (48, 128), 2
    ref = bench.build_dataset(num_samples=4, num_unique=2, hw=hw, num_cams=cams)
    path = cache_file(bench_cache_dir(), 2 * cams, hw)
    assert path.startswith(str(tmp_path)) and path.endswith("bench_jpegs_4_48x128_q90.npz")
    fresh = encode_bench_jpegs(2 * cams, hw)
    with np.load(path) as z:
        assert sorted(z.files) == [f"j{i}" for i in range(2 * cams)]
        for i, j in enumerate(fresh):
            np.testing.assert_array_equal(z[f"j{i}"], j)
    # the port reads bench.py's file, and writes one bench.py reads the same
    other = tmp_path / "port_cache"
    for cache_dir in (bench_cache_dir(), str(other)):
        prov = MultiCameraJpegProvider(num_samples=4, num_unique=2, hw=hw, num_cams=cams,
                                       cache_dir=cache_dir)
        for i in range(4):
            got, want = prov.get_data(i), ref.get_data(i)
            assert got.field_names_flat == want.field_names_flat
            for g, w in zip(got.get_data(), want.get_data()):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with np.load(cache_file(str(other), 2 * cams, hw)) as a, np.load(path) as b:
        assert all(np.array_equal(a[k], b[k]) for k in b.files)


# ------------------------- the wire slice ------------------------------- #


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


def jax_wire_pipeline(pack):
    s = jsteps
    steps = [s.ImageDecoder("image", decode_resize_hw=OUT_HW, wire_format="yuv420")]
    if pack:
        steps += [s.WirePlanePacker(["image", "image_cbcr"]),
                  s.WirePlaneUnpacker(["image", "image_cbcr"])]
    steps += [
        s.YCbCrToRGBConverter("image"),
        s.AffineTransformer(
            output_hw=OUT_HW, resizing_mode=s.AffineTransformer.ResizingMode.STRETCH,
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


def torch_wire_pipeline(pack):
    return build_pipeline(batch_size=BATCH, device="cpu", num_threads=2, hw=HW, num_cams=CAMS,
                          out_hw=OUT_HW, heatmap_hw=HM_HW, num_samples=SAMPLES, num_unique=2,
                          affine_prob=0.0, photometric_prob=0.0, wire="yuv", wire_pack=pack)


def _outputs(pipe, n):
    outs = []
    try:
        for _ in range(n):
            outs.append({k: np.asarray(v) for k, v in pipe.run().items()})
    finally:
        pipe.stop()
    return outs


def test_wire_slice_matches_jax_packed_and_unpacked(jax_pil_decoder):
    runs = {(pkg, pack): _outputs(build(pack), 2)
            for pkg, build in (("jax", jax_wire_pipeline), ("torch", torch_wire_pipeline))
            for pack in (True, False)}
    # packed and unpacked deliver the same bits, in each package
    for pkg in ("jax", "torch"):
        for a, b in zip(runs[(pkg, True)], runs[(pkg, False)]):
            assert set(a) == set(b)
            for name in a:
                np.testing.assert_array_equal(a[name], b[name], err_msg=f"{pkg} {name}")
    for j, t in zip(runs[("jax", True)], runs[("torch", True)]):
        assert_wire_batch_close(t, j)


def assert_wire_batch_close(t, j):
    """One batch of the port's wire slice against JAX's, at
    test_torch_slice.py's tolerances."""
    assert set(j) == set(t)
    for name in j:
        g, w = t[name], j[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name.endswith(".image"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1 / 57 + 1e-5, err_msg=name)
            assert float(np.mean(g != w)) < 0.01, name
        elif name.endswith("heatmap"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_build_pipeline_wire_choices():
    import inspect

    # the DCT wire is bench.py's default (tests/test_torch_dct_wire.py runs
    # it); the YUV wire is named where it is meant
    assert inspect.signature(build_pipeline).parameters["wire"].default == "dct"
    with pytest.raises(ValueError, match="wire must be"):
        build_pipeline(device="cpu", wire="png")


# ------------------------- the native decoder --------------------------- #

#: the decoder the JAX package's rule picks for each case and wire format
#: (image_decoder.py:121-190): PIL for PNG, for a CMYK JPEG, for an odd
#: yuv420 size without an even resize target and for a yuv420 scale hint
AUTO_PIL = {("png", "rgb"), ("png", "yuv420"), ("jpeg_odd", "yuv420"),
            ("jpeg_hint", "yuv420"), ("jpeg_cmyk", "rgb"), ("jpeg_cmyk", "yuv420")}


def encode_cmyk(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, format="JPEG", quality=90)
    return np.frombuffer(buf.getvalue(), np.uint8).copy()


AUTO_CASES = dict(DECODE_CASES, jpeg_cmyk=(lambda: encode_cmyk(smooth_image((32, 48), 6)), {}))


def _decode_port(step, encoded):
    sdg = SampleDataGroup()
    sdg.add_data_field("image", DType.UINT8)
    sdg["image"] = encoded
    out = step(sdg)
    return {n: np.asarray(v) for n, v in zip(out.field_names_flat, out.get_data())}


def _decode_jax(encoded, **kw):
    sdg = jpipe.SampleDataGroup()
    sdg.add_data_field("image", jpipe.DType.UINT8)
    sdg["image"] = encoded
    out = jsteps.ImageDecoder("image", **kw)(sdg)
    return {n: np.asarray(v) for n, v in zip(out.field_names_flat, out.get_data())}


@pytest.mark.parametrize("wire_format", ["rgb", "yuv420"])
@pytest.mark.parametrize("case", sorted(AUTO_CASES))
def test_decoder_auto_planes_equal_jax_native_path(case, wire_format):
    """Nothing patched: both packages take their libjpeg decoder where the
    JAX rule says so, and PIL elsewhere; the planes are bitwise equal and the
    port counts the decoder it took."""
    assert jnative_jpeg.available()
    make, kw = AUTO_CASES[case]
    encoded = make()
    step = ImageDecoder("image", decoder="auto", wire_format=wire_format, **kw)
    got, want = _decode_port(step, encoded), _decode_jax(encoded, wire_format=wire_format, **kw)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    took = "pil" if (case, wire_format) in AUTO_PIL else "native"
    assert step.decoded_by == {"native": int(took == "native"), "pil": int(took == "pil")}
    native = ImageDecoder("image", decoder="native", wire_format=wire_format,
                          **({} if (case, wire_format) == ("jpeg_hint", "yuv420") else kw))
    if took == "native":
        for name, v in _decode_port(native, encoded).items():
            np.testing.assert_array_equal(v, want[name], err_msg=name)
        assert native.decoded_by == {"native": 1, "pil": 0}
    elif case != "jpeg_hint":
        with pytest.raises(ValueError, match="decoder='native'"):
            _decode_port(native, encoded)


def test_decoder_choice_is_checked_and_native_needs_its_library(monkeypatch):
    from accvlab_tpu_torch.pipeline import native_jpeg

    with pytest.raises(ValueError, match="decoder must be"):
        ImageDecoder("image", decoder="turbo")
    with pytest.raises(ValueError, match="decode_resize_hw"):
        ImageDecoder("image", decoder="native", wire_format="yuv420",
                     decode_scale_hint_hw=(64, 64))
    monkeypatch.setattr(native_jpeg, "available", lambda: False)
    monkeypatch.setattr(native_jpeg, "build_error", lambda: "no libjpeg (test)")
    with pytest.raises(RuntimeError, match="no libjpeg"):
        ImageDecoder("image", decoder="native")
    step = ImageDecoder("image", decoder="auto", wire_format="yuv420")
    got = _decode_port(step, DECODE_CASES["jpeg"][0]())
    assert step.decoded_by == {"native": 0, "pil": 1} and got["image"].shape == (32, 48)


@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_wire_pipeline_reports_its_decoder(decoder):
    pipe = build_pipeline(batch_size=BATCH, device="cpu", num_threads=2, hw=HW, num_cams=CAMS,
                          out_hw=OUT_HW, heatmap_hw=HM_HW, num_samples=SAMPLES, num_unique=2,
                          wire="yuv", decoder=decoder)
    try:
        pipe.run()
        pipe.run()
        counts = pipe.stats()["decoded_by"]
    finally:
        pipe.stop()
    frames = (2 + pipe._depth) * BATCH * CAMS  # the prefetch ring may have built more
    assert counts[decoder] >= 2 * BATCH * CAMS and sum(counts.values()) <= frames
    assert counts["pil" if decoder == "native" else "native"] == 0
