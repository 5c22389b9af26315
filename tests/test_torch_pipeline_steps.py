"""Step-level parity of the port's pipeline pieces with the JAX package.

Each device step runs on the same input in both packages, one step at a
time, with randomness scripted through ``ScriptedRandomContext`` on both
sides: the JAX step per sample (its leaves as jax arrays, i.e. the device
path), the port's step once on the batch.

Tolerances: uint8 images |diff| <= 1 (XLA may contract a multiply-add into
an FMA where PyTorch rounds twice, which moves a value sitting on a .5
rounding boundary by one step), with the share of differing values bounded
as each test states; heatmaps rtol 1e-6 (exp of XLA vs PyTorch, a few ulp);
active / center / offset exact; normalized images 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accvlab_tpu.pipeline as jpipe
import accvlab_tpu.pipeline.processing_steps as jsteps
import accvlab_tpu_torch.pipeline as tpipe
import accvlab_tpu_torch.pipeline.processing_steps as tsteps
from accvlab_tpu.hostcopy import start_copy as jstart_copy
from accvlab_tpu_torch.hostcopy import start_copy as tstart_copy

B = 2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def scripted(pkg, script):
    ctx = pkg.ScriptedRandomContext()
    for kind, lo, hi, values in script:
        getattr(ctx, f"script_{kind}")(lo, hi, list(values))
    return ctx


def image_group(pkg, dtype_name="UINT8"):
    sdg = pkg.SampleDataGroup()
    sdg.add_data_field("image", getattr(pkg.DType, dtype_name))
    return sdg


def run_jax_per_sample(step, blueprint_fn, leaves_per_sample, script):
    """The JAX step on each sample (jax-array leaves); returns stacked numpy
    outputs per flat field."""
    outs = []
    for leaves in leaves_per_sample:
        sdg = blueprint_fn()
        sdg.set_data([jnp.asarray(x) for x in leaves])
        step.set_random_context(scripted(jpipe, script))
        outs.append([np.asarray(v) for v in step(sdg).get_data()])
    return [np.stack(vals) for vals in zip(*outs)]


def run_torch_batched(step, blueprint_fn, batched_leaves, script):
    sdg = blueprint_fn()
    sdg.set_data([torch.as_tensor(x) for x in batched_leaves])
    step.set_random_context(scripted(tpipe, script))
    return [v.numpy() for v in step(sdg).get_data()]


def assert_close_uint8(got, want, max_share):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"max |diff| {diff.max()}"
    share = float((diff > 0).mean())
    assert share <= max_share, f"{share:.4%} of values differ (bound {max_share:.4%})"


def random_images(seed, h=96, w=256):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (B, h // 8, w // 8, 3)).astype(np.float32)
    img = np.repeat(np.repeat(base, 8, axis=1), 8, axis=2)
    noise = rng.integers(-20, 21, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


# --------------------------- affine transformer ------------------------ #

AFFINE_SCRIPTS = {
    # UniformScaling draws its scale then its gate; Translation x, y, gate
    "identity_gates_off": [("uniform", 0.9, 1.1, [1.05] * B), ("uniform", 0.0, 1.0, [0.9] * 2 * B),
                           ("uniform", -16.0, 16.0, [3.0] * 2 * B)],
    "scale_and_shift": [("uniform", 0.9, 1.1, [1.07] * B), ("uniform", 0.0, 1.0, [0.1] * 2 * B),
                        ("uniform", -16.0, 16.0, [-11.5, 6.25] * B)],
    "shrink_exposes_border": [("uniform", 0.9, 1.1, [0.9] * B), ("uniform", 0.0, 1.0, [0.2] * 2 * B),
                              ("uniform", -16.0, 16.0, [15.75, -15.5] * B)],
}


def _affine(pkg):
    steps = pkg.AffineTransformer
    return steps(
        output_hw=(64, 176), resizing_mode=steps.ResizingMode.STRETCH, image_field_names="image",
        transformation_steps=[steps.UniformScaling(0.5, 0.9, 1.1),
                              steps.Translation(0.5, [-16.0, -16.0], [16.0, 16.0])],
    )


@pytest.mark.parametrize("case", sorted(AFFINE_SCRIPTS))
def test_affine_warp_parity(case):
    imgs = random_images(1)
    script = AFFINE_SCRIPTS[case]
    # per-sample JAX pops one value per draw; the batched port pops one for all
    jscript = [(k, lo, hi, v[: len(v) // B]) for k, lo, hi, v in script]
    want = run_jax_per_sample(_affine(jsteps), lambda: image_group(jpipe), [[i] for i in imgs],
                              jscript)
    got = run_torch_batched(_affine(tsteps), lambda: image_group(tpipe), [imgs], jscript)
    assert got[0].shape == want[0].shape == (B, 64, 176, 3)
    assert_close_uint8(got[0], want[0], max_share=0.01)


def test_affine_stretch_borders_exact():
    """A plain resize (no augmentation): last row and column, where the
    sampling position reaches the source border, agree exactly."""
    imgs = random_images(2)

    def stretch(pkg):
        return pkg.AffineTransformer(output_hw=(40, 100),
                                     resizing_mode=pkg.AffineTransformer.ResizingMode.STRETCH,
                                     image_field_names="image")

    want = run_jax_per_sample(stretch(jsteps), lambda: image_group(jpipe), [[i] for i in imgs], [])
    got = run_torch_batched(stretch(tsteps), lambda: image_group(tpipe), [imgs], [])
    for sl in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        assert_close_uint8(got[0][sl], want[0][sl], max_share=0.0)
    assert_close_uint8(got[0], want[0], max_share=0.005)


# --------------------------- photometric distorter --------------------- #


def _photometric(pkg):
    return pkg.PhotoMetricDistorter(
        "image", min_max_brightness=[-16.0, 16.0], min_max_hue=[-10.0, 10.0],
        min_max_contrast=[0.8, 1.2], min_max_saturation=[0.8, 1.2],
    )


def _photo_script(gates, mode, delta, alpha, hue, sat, perm):
    return [("uniform", 0.0, 1.0, gates), ("randint", 0, 2, [mode]),
            ("uniform", -16.0, 16.0, [delta]), ("uniform", 0.8, 1.2, [alpha]),
            ("uniform", -10.0, 10.0, [hue]), ("uniform", 0.8, 1.2, [sat]),
            ("randint", 0, 6, [perm])]


PHOTO_SCRIPTS = {
    "all_off": _photo_script([0.9] * 5, 0, 3.0, 1.1, 4.0, 0.9, 0),
    "all_on_post_contrast": _photo_script([0.1] * 5, 0, 7.5, 1.15, -6.0, 1.1, 3),
    "all_on_pre_contrast": _photo_script([0.1] * 5, 1, -12.0, 0.85, 9.0, 0.85, 4),
    "brightness_and_swap": _photo_script([0.1, 0.9, 0.9, 0.9, 0.1], 0, 15.0, 1.0, 0.0, 1.0, 5),
}


@pytest.mark.parametrize("case", sorted(PHOTO_SCRIPTS))
def test_photometric_parity(case):
    imgs = random_images(3, 32, 48)
    script = PHOTO_SCRIPTS[case]
    want = run_jax_per_sample(_photometric(jsteps), lambda: image_group(jpipe), [[i] for i in imgs],
                              script)
    got = run_torch_batched(_photometric(tsteps), lambda: image_group(tpipe), [imgs], script)
    assert got[0].dtype == np.uint8
    assert_close_uint8(got[0], want[0], max_share=0.02)


# --------------------------- heatmap converter ------------------------- #


def heatmap_group(pkg, num_cams=2):
    from accvlab_tpu_torch.pipeline.inputs.multicam_synthetic import sample_structure

    sdg = sample_structure(pkg.SampleDataGroup, pkg.DType, num_cams)
    for c in range(num_cams):
        sdg["cameras"][c].remove_field("image")
    return sdg


def _converter(pkg):
    return pkg.BoundingBoxToHeatmapConverter(
        annotation_field_name="annotations", bboxes_in_name="bboxes", heatmap_out_name="heatmap",
        heatmap_hw=(16, 44), image_hw_field_name="image_hw", categories_in_name="categories",
        num_categories=10, is_active_opt_out_name="active", center_opt_out_name="center",
        center_offset_opt_out_name="offset",
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_heatmap_converter_parity(seed):
    from accvlab_tpu_torch.pipeline.inputs.multicam_synthetic import sample_boxes

    hw = (96, 256)
    per_sample = []
    for s in range(B):
        leaves = []
        for boxes, cats in sample_boxes(seed * 10 + s, 2, hw, 32, 10):
            leaves += [np.asarray(hw, np.int32), boxes, cats]
        per_sample.append(leaves)
    batched = [np.stack(v) for v in zip(*per_sample)]
    want = run_jax_per_sample(_converter(jsteps), lambda: heatmap_group(jpipe), per_sample, [])
    got = run_torch_batched(_converter(tsteps), lambda: heatmap_group(tpipe), batched, [])
    names = _converter(tsteps).check_input_data_format_and_set_output_data_format(
        heatmap_group(tpipe)).field_names_flat
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name.endswith("heatmap"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=name)
            assert g.max() == 1.0
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# --------------------------- normalizers ------------------------------- #


@pytest.mark.parametrize("kind", ["mean_std", "range01"])
def test_normalizer_parity(kind):
    imgs = random_images(4, 16, 24)

    def step(pkg):
        if kind == "range01":
            return pkg.ImageRange01Normalizer("image")
        return pkg.ImageMeanStdDevNormalizer("image", mean=[103.5, 116.3, 123.7],
                                             std_dev=[57.4, 57.1, 58.4])

    want = run_jax_per_sample(step(jsteps), lambda: image_group(jpipe), [[i] for i in imgs], [])
    got = run_torch_batched(step(tsteps), lambda: image_group(tpipe), [imgs], [])
    assert got[0].dtype == np.float32
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)


# --------------------------- host copy --------------------------------- #


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "img": rng.integers(0, 255, (2, 5, 7, 3), dtype=np.uint8),
        "f64": rng.normal(size=(3, 4)),
        "i64": rng.integers(-9, 9, (5,)),
        "flags": rng.random(6) < 0.5,
        "empty": np.zeros((0, 4), np.float32),
        "nested": [np.float32(2.5), 7, ("tag", rng.normal(size=(2,)).astype(np.float32))],
        "big": rng.normal(size=(300, 300)).astype(np.float32),
    }


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("max_chunk", [1 << 20, 256])
def test_host_copy_round_trip_matches_jax(merge, max_chunk):
    tree = _tree(0)
    got = tstart_copy(tree, device="cpu", merge_dtype_chunks=merge,
                      max_packed_chunk_bytes=max_chunk).get()
    want = jstart_copy(tree, merge_dtype_chunks=merge, max_packed_chunk_bytes=max_chunk,
                       use_background_thread=False).get()

    def walk(g, w):
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                walk(g[k], w[k])
        elif isinstance(w, (list, tuple)):
            assert type(g) is type(w) and len(g) == len(w)
            for a, b in zip(g, w):
                walk(a, b)
        elif isinstance(w, str):
            assert g == w
        else:
            wn = np.asarray(w)
            gn = g.numpy()
            assert gn.dtype == wn.dtype and gn.shape == wn.shape
            np.testing.assert_array_equal(gn, wn)

    walk(got, want)


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("max_chunk", [1 << 20, 256])
@pytest.mark.parametrize("align", [1, 16, 64])
@pytest.mark.parametrize("pack", [True, False])
def test_host_copy_plan_matches_jax(merge, max_chunk, align, pack, monkeypatch):
    """The chunk plan (the chunks in fill order, each with its dtype group,
    its arrays' dtypes and shapes, their byte offsets and the chunk's
    bytes) is JAX's, and the copy round-trips, for every option that
    changes the plan."""
    import accvlab_tpu.hostcopy.async_copy as jcopy
    from accvlab_tpu_torch.hostcopy.async_copy import _flatten, _plan

    tree = _tree(1)
    tree["c"] = (np.arange(5) * (1 + 2j)).astype(np.complex64)
    tree["u16"] = np.arange(9, dtype=np.uint16).reshape(3, 3)
    kw = dict(pack_cpu_tensors=pack, min_packed_alignment_bytes=align,
              max_packed_chunk_bytes=max_chunk, merge_dtype_chunks=merge)

    recorded = []
    real = jcopy.parallel_pack

    def record(arrays, offsets, total):
        recorded.append(([(str(a.dtype), a.shape) for a in arrays], list(offsets), total))
        return real(arrays, offsets, total)

    monkeypatch.setattr(jcopy, "parallel_pack", record)
    want = jstart_copy(tree, use_background_thread=False, **kw).get()

    leaves = []
    _flatten(tree, leaves)
    _, chunks = _plan(leaves, pack, align, max_chunk, None, merge)
    plan = [([(str(a.dtype), a.shape) for _, a, _ in items], [off for _, _, off in items],
             total) for _, items, total in chunks]
    assert plan == recorded
    # merged chunks first, then one group per dtype, as JAX fills them
    groups = [None if d is None else str(d) for d, _, _ in chunks]
    assert groups == sorted(groups, key=lambda g: g is not None)

    got = tstart_copy(tree, device="cpu", use_background_thread=False, **kw).get()
    for key in want:
        for a, b in zip(torch.utils._pytree.tree_leaves(got[key]),
                        jax.tree_util.tree_leaves(want[key])):
            if isinstance(b, str):
                assert a == b
            else:
                assert a.numpy().dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_host_copy_pageable_staging_round_trips():
    tree = _tree(2)
    got = tstart_copy(tree, device="cpu", use_pinned_staging=False, pack_cpu_tensors=False,
                      use_background_thread=False).get()
    want = tstart_copy(tree, device="cpu", use_background_thread=False).get()
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        assert a == b if isinstance(a, str) else torch.equal(a, b)


# --------------------------- input order ------------------------------- #


class _IndexProvider:
    def __init__(self, pkg, n):
        self._pkg, self._n = pkg, n

    @property
    def sample_data_structure(self):
        sdg = self._pkg.SampleDataGroup()
        sdg.add_data_field("index", self._pkg.DType.INT32)
        return sdg

    def get_data(self, i):
        sdg = self.sample_data_structure
        sdg["index"] = np.int32(i)
        return sdg

    def get_number_of_samples(self):
        return self._n


@pytest.mark.parametrize("seed", [0, 21])
def test_input_callable_order_matches_jax(seed):
    from accvlab_tpu.pipeline.inputs import ShuffledShardedInputCallable as J
    from accvlab_tpu_torch.pipeline.inputs import SampleInfo
    from accvlab_tpu_torch.pipeline.inputs import ShuffledShardedInputCallable as T

    j = J(_IndexProvider(jpipe, 37), batch_size=4, shuffle=True, seed=seed, shard_id=1, num_shards=2)
    t = T(_IndexProvider(tpipe, 37), batch_size=4, shuffle=True, seed=seed, shard_id=1, num_shards=2)
    assert j.length == t.length
    for epoch in (0, 1):
        for i in range(18):
            info = SampleInfo(idx_in_epoch=i, idx_in_batch=i % 4, iteration=i // 4, epoch_idx=epoch)
            assert int(j(info)[0]) == int(t(info)[0])
