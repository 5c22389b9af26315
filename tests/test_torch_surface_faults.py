"""The four repaired faults of the port's public surface (ROADMAP.md §3), each
with the input that showed it and the JAX package's output against the
port's:

1. ``get_pipeline`` takes JAX's order (``..., prefetch_queue_depth,
   worker_mode, mesh, echo_factor``);
2. ``ImageDecoder`` takes ``use_device_mixed`` and ``hw_decoder_load``
   second and third (``ImageDecoder("image", True)`` gave BGR);
3. ``start_copy`` takes and honours ``use_pinned_staging``,
   ``pack_cpu_tensors`` and ``min_packed_alignment_bytes`` in JAX's
   positions (the plan itself: ``tests/test_torch_pipeline_steps.py``);
4. ``operators`` has ``apply_transform_to_points`` and
   ``add_post_transform_to_projection_matrix``, on numpy and on batched
   tensors.

And the two repaired defaults of the port's own parameters, each with only
JAX's arguments passed (tests/test_torch_export_surface.py now holds every
default):

5. ``ImageDecoder``'s ``decoder`` defaults to ``"auto"``, JAX's rule: a
   resized bench-shape JPEG was decoded by PIL, where JAX uses libjpeg (the
   Y plane differed by up to 18 in most values), and so was the YUV wire of
   ``bench_pipeline.build_pipeline``;
6. ``DeviceRandomContext``'s ``device`` defaults to the card, as JAX's
   context draws onto its default device: it returned CPU tensors.
"""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import accvlab_tpu.pipeline as jpipe
import accvlab_tpu.pipeline.native_jpeg as jnative_jpeg
import accvlab_tpu.pipeline.operators as jops
import accvlab_tpu.pipeline.processing_steps as jsteps
import accvlab_tpu_torch.pipeline as tpipe
import accvlab_tpu_torch.pipeline.operators as tops
import accvlab_tpu_torch.pipeline.processing_steps as tsteps
from accvlab_tpu.hostcopy import start_copy as jstart_copy
from accvlab_tpu.pipeline.inputs import DataProvider as JProvider
from accvlab_tpu.pipeline.inputs import ShuffledShardedInputCallable as JInput
from accvlab_tpu_torch.hostcopy import start_copy as tstart_copy
from accvlab_tpu_torch.pipeline.inputs import DataProvider as TProvider
from accvlab_tpu_torch.pipeline.inputs import ShuffledShardedInputCallable as TInput
from test_torch_yuv import (
    BATCH,
    CAMS,
    assert_wire_batch_close,
    jax_wire_pipeline,
    torch_wire_pipeline,
)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# 1 ------------------------------------------------------------------------ #


def _images_definition(pkg, steps, base, inp):
    class Provider(base):
        @property
        def sample_data_structure(self):
            s = pkg.SampleDataGroup()
            s.add_data_field("image", pkg.DType.UINT8)
            return s

        def get_data(self, i):
            s = self.sample_data_structure
            s["image"] = np.random.default_rng(i).integers(0, 255, (6, 10, 3), np.uint8)
            return s

        def get_number_of_samples(self):
            return 4

    return pkg.PipelineDefinition(inp(Provider(), 2), [steps.ImageRange01Normalizer("image")])


@pytest.mark.parametrize("tail", [(), ("thread",), ("thread", None, 1)])
def test_get_pipeline_takes_jax_positional_order(tail):
    """``get_pipeline(2, 2, dev, 0, None, "thread"[, None, 1])``: the port
    read "thread" as echo_factor (ValueError), and 8 positional values were
    one too many (TypeError)."""
    jp = _images_definition(jpipe, jsteps, JProvider, JInput).get_pipeline(2, 2, None, 0, None,
                                                                          *tail)
    tp = _images_definition(tpipe, tsteps, TProvider, TInput).get_pipeline(2, 2, "cpu", 0, None,
                                                                          *tail)
    try:
        for _ in range(2):
            want, got = jp.run()["image"], tp.run()["image"]
            assert tuple(got.shape) == (2, 6, 10, 3)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    finally:
        jp.stop()
        tp.stop()


# 2 ------------------------------------------------------------------------ #


def _jpeg():
    from PIL import Image

    rng = np.random.default_rng(5)
    img = Image.fromarray(rng.integers(0, 255, (6, 8, 3), np.uint8)).resize((64, 48))
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=90)
    return np.frombuffer(buf.getvalue(), np.uint8).copy()


def _decode_step(pkg, step, encoded):
    sdg = pkg.SampleDataGroup()
    sdg.add_data_field("image", pkg.DType.UINT8)
    sdg["image"] = encoded
    return step(sdg)


def _decode(pkg, step):
    return np.asarray(_decode_step(pkg, step, _jpeg())["image"])


def test_image_decoder_second_argument_is_use_device_mixed():
    """``ImageDecoder("image", True)``: JAX decodes RGB (``True`` is
    ``use_device_mixed``, ignored); the port decoded BGR."""
    want = _decode(jpipe, jsteps.ImageDecoder("image", True))
    got = _decode(tpipe, tsteps.ImageDecoder("image", True, 0.5, decoder="native"))
    np.testing.assert_array_equal(got, want)
    bgr = _decode(tpipe, tsteps.ImageDecoder("image", as_bgr=True, decoder="native"))
    np.testing.assert_array_equal(bgr, want[..., ::-1])
    kw = _decode(tpipe, tsteps.ImageDecoder("image", use_device_mixed=True, hw_decoder_load=0.9,
                                            decoder="native"))
    np.testing.assert_array_equal(kw, want)


# 3 ------------------------------------------------------------------------ #


def _leaves_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_start_copy_takes_jax_options():
    """``start_copy(tree, dev, pack_cpu_tensors=False)`` (and
    ``min_packed_alignment_bytes=64``) raised TypeError; the positional
    ``start_copy(x, dev, True, False)`` bound ``max_packed_chunk_bytes`` and
    ``use_background_thread``."""
    tree = {"a": np.arange(10, dtype=np.float32), "b": np.arange(7, dtype=np.int32)}
    want = jstart_copy(tree, None, True, False).get()
    _leaves_equal(tstart_copy(tree, "cpu", True, False).get(), want)
    _leaves_equal(tstart_copy(tree, "cpu", pack_cpu_tensors=False).get(), want)
    _leaves_equal(tstart_copy(tree, "cpu", min_packed_alignment_bytes=64,
                              merge_dtype_chunks=True).get(), want)
    _leaves_equal(tstart_copy(tree, "cpu", use_pinned_staging=False).get(), want)


# 4 ------------------------------------------------------------------------ #


def _points(seed, n, k):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 2 * k)) * 50).astype(np.float32)


def _affine(seed, rows=2):
    rng = np.random.default_rng(seed)
    m = np.concatenate([rng.normal(size=(2, 2)), rng.normal(size=(2, 1)) * 10], 1)
    if rows == 3:
        m = np.concatenate([m, [[0.0, 0.0, 1.0]]], 0)
    return m.astype(np.float32)


@pytest.mark.parametrize("rows", [2, 3])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_apply_transform_to_points_equals_jax(rows, k):
    pts, m = _points(k, 5, k), _affine(rows, rows)
    want_np = jops.apply_transform_to_points(pts, m)
    np.testing.assert_array_equal(tops.apply_transform_to_points(pts, m), want_np)
    want = np.asarray(jops.apply_transform_to_points(jnp.asarray(pts), jnp.asarray(m)))
    got = tops.apply_transform_to_points(torch.from_numpy(pts), m)
    assert got.dtype == torch.float32 and tuple(got.shape) == pts.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    # batched: one transform per sample, a leading batch dimension
    batch_pts = np.stack([pts, _points(k + 9, 5, k)])
    batch_m = np.stack([m, _affine(7, rows)])
    got = tops.apply_transform_to_points(torch.from_numpy(batch_pts), torch.from_numpy(batch_m))
    for b in range(2):
        want = jops.apply_transform_to_points(batch_pts[b], batch_m[b])
        np.testing.assert_allclose(got[b].numpy(), want, rtol=1e-6, atol=1e-4)


def test_apply_transform_to_points_empty_and_odd_rows_as_jax():
    m = _affine(0)
    for empty in (np.zeros((0, 4), np.float32), np.zeros((3, 0), np.float32)):
        want = jops.apply_transform_to_points(empty, m)
        np.testing.assert_array_equal(tops.apply_transform_to_points(empty, m), want)
        got = tops.apply_transform_to_points(torch.from_numpy(empty), m)
        assert got.shape == want.shape and not got.any()
    odd = np.zeros((2, 3), np.float32)
    with pytest.raises(ValueError, match="row length of 3") as jerr:
        jops.apply_transform_to_points(odd, m)
    for points in (odd, torch.from_numpy(odd)):
        with pytest.raises(ValueError) as err:
            tops.apply_transform_to_points(points, m)
        assert str(err.value) == str(jerr.value)


def test_add_post_transform_to_projection_matrix_equals_jax():
    rng = np.random.default_rng(3)
    proj = rng.normal(size=(3, 4)).astype(np.float32)
    m = _affine(4)
    want_np = jops.add_post_transform_to_projection_matrix(proj, m)
    np.testing.assert_array_equal(tops.add_post_transform_to_projection_matrix(proj, m), want_np)
    want = np.asarray(jops.add_post_transform_to_projection_matrix(jnp.asarray(proj),
                                                                   jnp.asarray(m)))
    got = tops.add_post_transform_to_projection_matrix(torch.from_numpy(proj), m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    projs = rng.normal(size=(2, 3, 4)).astype(np.float32)
    ms = np.stack([m, _affine(5)])
    got = tops.add_post_transform_to_projection_matrix(torch.from_numpy(projs),
                                                       torch.from_numpy(ms))
    for b in range(2):
        want = jops.add_post_transform_to_projection_matrix(projs[b], ms[b])
        np.testing.assert_allclose(got[b].numpy(), want, rtol=1e-6, atol=1e-5)


# 5 ------------------------------------------------------------------------ #


@pytest.mark.parametrize("wire_format", ["yuv420", "rgb"])
def test_image_decoder_default_is_jax_rule_on_bench_shape(wire_format):
    """bench.py's step (``bench.py:220``) on one of its 372x1024 q90 JPEGs,
    with only JAX's arguments and nothing patched: the port took PIL, whose
    draft scale and bilinear resize differ from JAX's libjpeg decode at 6/8."""
    from accvlab_tpu_torch.pipeline.inputs.multicam_jpeg import encode_bench_jpegs

    assert jnative_jpeg.available()
    encoded = encode_bench_jpegs(1, (372, 1024))[0]
    kw = dict(decode_resize_hw=(256, 704), wire_format=wire_format)
    jstep, tstep = jsteps.ImageDecoder("image", **kw), tsteps.ImageDecoder("image", **kw)
    want, got = ({n: np.asarray(v) for n, v in zip(out.field_names_flat, out.get_data())}
                 for out in (_decode_step(jpipe, jstep, encoded),
                             _decode_step(tpipe, tstep, encoded)))
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["image"].shape[:2] == (256, 704)
    assert tstep.decoded_by == {"native": 1, "pil": 0}


def test_bench_yuv_wire_default_decoder_matches_jax_recipe():
    """``build_pipeline(wire="yuv", device="cpu")`` without ``decoder=``
    against JAX's recipe with JAX's decoder as it is (libjpeg here): the
    first batch within the slice's tolerances (the PIL path of the same
    comparison: tests/test_torch_yuv.py)."""
    jp, tp = jax_wire_pipeline(pack=True), torch_wire_pipeline(pack=True)
    try:
        want = {k: np.asarray(v) for k, v in jp.run().items()}
        got = {k: np.asarray(v) for k, v in tp.run().items()}
        decoded_by = tp.stats()["decoded_by"]
    finally:
        jp.stop()
        tp.stop()
    assert_wire_batch_close(got, want)
    assert decoded_by["native"] >= BATCH * CAMS and decoded_by["pil"] == 0


# 6 ------------------------------------------------------------------------ #


def test_device_random_context_defaults_to_the_card(monkeypatch):
    """``DeviceRandomContext((0, 1))``: JAX draws onto its default device;
    the port drew onto the CPU. Now it raises without a card, and
    ``device="cpu"`` draws from the CPU generator seeded from the key."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.DeviceRandomContext((0, 1))
    ctx = tpipe.DeviceRandomContext((0, 1), device="cpu")
    u, n, k = ctx.uniform(0.0, 1.0, (3,)), ctx.normal(0.0, 2.0, (2,)), ctx.randint(0, 6, (4,))
    state = np.random.SeedSequence([0, 1]).generate_state(2, np.uint32)
    gen = torch.Generator().manual_seed((int(state[0]) << 31) ^ int(state[1]))
    want = (torch.rand(3, generator=gen), torch.randn(2, generator=gen) * 2.0,
            torch.randint(0, 6, (4,), generator=gen, dtype=torch.int32))
    for got, w in zip((u, n, k), want):
        assert got.device.type == "cpu" and got.dtype == w.dtype
        assert torch.equal(got, w)
    assert [e["kind"] for e in ctx.schedule] == ["uniform", "normal", "randint"]
