"""The port's native JPEG decoder (``accvlab_tpu_torch.pipeline.native_jpeg``)
against the JAX package's (``accvlab_tpu.pipeline.native_jpeg``).

Both build the same ``jpegdec.cpp`` (the port's is a byte-identical copy,
``test_torch_import.py``), here against this host's libjpeg, so every output
must be bitwise equal: bench.py's q90 1024x372 JPEGs, an odd-sized, a
grayscale and a progressive JPEG. A CMYK JPEG raises ``ValueError`` from
``decode_rgb`` in both. The port also links Pillow's libjpeg-turbo on a host
whose ``ldconfig`` lists no libjpeg: that build is held
bitwise against the JAX package's too.
"""

import io

import numpy as np
import pytest

import accvlab_tpu.pipeline.native_jpeg as jnj
from accvlab_tpu_torch import _native_build
from accvlab_tpu_torch.pipeline import native_jpeg as tnj
from accvlab_tpu_torch.pipeline.inputs.multicam_jpeg import encode_bench_jpegs


def _encode(img, mode="RGB", **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, format="JPEG", **kw)
    return np.frombuffer(buf.getvalue(), np.uint8).copy()


def _smooth(hw, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (max(1, hw[0] // 8), max(1, hw[1] // 8), 3), np.uint8)
    return np.asarray(Image.fromarray(base).resize((hw[1], hw[0]), Image.BILINEAR), np.uint8)


# (jpeg bytes, even yuv420 targets, rgb targets)
CASES = {
    "bench_q90": (lambda: encode_bench_jpegs(3, (372, 1024)), [(256, 704), (372, 1024)],
                  [(256, 704), (186, 512)]),
    "odd_size": (lambda: [_encode(_smooth((33, 47), 1), quality=90)], [(32, 46), (16, 24)],
                 [(33, 47), (17, 24)]),
    "grayscale": (lambda: [_encode(_smooth((48, 64), 2), "L", quality=85)], [(48, 64), (24, 32)],
                  [(48, 64), (30, 40)]),
    "progressive": (lambda: [_encode(_smooth((96, 128), 3), quality=92, progressive=True)],
                    [(96, 128), (48, 64)], [(96, 128), (72, 96)]),
}


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    if not (jnj.available() and tnj.available()):
        pytest.fail(f"native JPEG decoders did not build: {jnj._LIB_ERROR} / {tnj.build_error()}")


def assert_decoders_equal(jpegs, yuv_targets, rgb_targets):
    for e in jpegs:
        assert tnj.probe(e) == jnj.probe(e)
        src = tnj.probe(e)
        for target in yuv_targets:
            for a, b in zip(tnj.decode_yuv420(e, target), jnj.decode_yuv420(e, target)):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
        for target in rgb_targets:
            for bgr in (False, True):
                np.testing.assert_array_equal(tnj.decode_rgb(e, target, bgr),
                                              jnj.decode_rgb(e, target, bgr))
        info = tnj.dct_info(e)
        assert info == jnj.dct_info(e)
        for target in yuv_targets:
            m = tnj.select_scale_m(src, target)
            assert m == jnj.select_scale_m(src, target)
            assert tnj.scaled_size(src, target) == jnj.scaled_size(src, target)
            for a, b in zip(tnj.read_dct(e, m, info), jnj.read_dct(e, m)):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_decoder_bitwise_equal_jax(case):
    make, yuv_targets, rgb_targets = CASES[case]
    assert_decoders_equal(make(), yuv_targets, rgb_targets)


def test_cmyk_raises_in_both():
    e = _encode(_smooth((32, 48), 4), "CMYK", quality=90)
    for mod in (tnj, jnj):
        assert mod.probe(e) == (32, 48)
        with pytest.raises(ValueError):
            mod.decode_rgb(e, (32, 48))
        with pytest.raises(ValueError):
            mod.dct_info(e)


def test_corrupt_bytes_raise_value_error():
    e = encode_bench_jpegs(1, (372, 1024))[0][:200]
    for mod in (tnj, jnj):
        with pytest.raises(ValueError):
            mod.decode_yuv420(e, (256, 704))


def test_records_the_linked_library():
    tnj.library_path()
    assert tnj.LINKED["source"] in ("system", "pillow")
    assert tnj.LINKED["path"] and "link_args" not in tnj.LINKED


@pytest.fixture
def fresh_native(monkeypatch):
    """The port's decoder module with its library unloaded (restored after)."""
    monkeypatch.setattr(tnj, "_LIB", None)
    monkeypatch.setattr(tnj, "_LIB_ERROR", None)
    monkeypatch.setattr(tnj, "LINKED", None)
    return monkeypatch


def test_links_pillows_libjpeg_without_a_system_one(fresh_native):
    fresh_native.setattr(_native_build, "_ldconfig_libjpeg62", lambda: None)
    link = _native_build.libjpeg_link()
    assert link["source"] == "pillow" and "pillow.libs" in link["path"]
    assert link["link_args"][0] == link["path"] and link["link_args"][1].startswith("-Wl,-rpath,")
    assert tnj.available(), tnj.build_error()
    assert tnj.LINKED["source"] == "pillow"
    make, yuv_targets, rgb_targets = CASES["bench_q90"]
    assert_decoders_equal(make(), yuv_targets, rgb_targets)


def test_no_libjpeg_is_reported_not_hidden(fresh_native):
    def none():
        raise RuntimeError("no libjpeg with the ABI-62 interface (test)")

    fresh_native.setattr(tnj, "libjpeg_link", none)
    assert not tnj.available()
    assert "ABI-62" in tnj.build_error()
    with pytest.raises(RuntimeError, match="not available: no libjpeg"):
        tnj.probe(encode_bench_jpegs(1, (372, 1024))[0])
