"""The 2-D pipeline steps of the port against the JAX package's steps.

Each step runs on the same SampleDataGroups in both packages:

* host side: one sample's numpy leaves through both, outputs equal bit for
  bit (the port's host forms are the JAX package's numpy code) with the
  same field structure;
* device side (the ``"any"`` steps): the port's step on a batch of samples
  stacked into tensors, against the JAX step per sample on ``jnp`` leaves
  (its device branch, as under ``vmap``): masks, clipped coordinates, sizes
  and permuted images equal bit for bit.

Also: ``optimize_size_buckets`` equal to JAX's on random sizes, and the
cases of tests/test_processing_steps.py and tests/test_size_buckets.py that
cover these steps, run on the port.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accvlab_tpu.pipeline as jpipe
import accvlab_tpu.pipeline.processing_steps as js
import accvlab_tpu_torch.pipeline as tpipe
import accvlab_tpu_torch.pipeline.processing_steps as ts

B = 3


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def structure(pkg):
    ann = pkg.SampleDataGroup()
    for name in ("bboxes", "depths", "visibility"):
        ann.add_data_field(name, pkg.DType.FLOAT)
    ann.add_data_field("num_pts", pkg.DType.INT32)
    cam = pkg.SampleDataGroup()
    cam.add_data_field("points", pkg.DType.FLOAT)
    root = pkg.SampleDataGroup()
    root.add_data_field("image", pkg.DType.UINT8)
    root.add_data_field("image_hw", pkg.DType.INT32)
    root.add_data_group_field("annotations", ann)
    root.add_data_group_field_array("cams", cam, 2)
    return root


def sample_leaves(i, n=5):
    """One sample's leaves, in the structure's flat order."""
    rng = np.random.default_rng(100 + i)
    x1, y1 = rng.uniform(-4, 18, n), rng.uniform(-4, 14, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(1, 9, n), y1 + rng.uniform(1, 9, n)], 1)
    flat = [
        rng.integers(0, 256, (16, 20, 3)).astype(np.uint8),
        np.array([16, 20], np.int32),
        boxes.astype(np.float32),
        rng.uniform(1, 10, n).astype(np.float32),
        np.round(rng.uniform(0, 1, n), 1).astype(np.float32),
        rng.integers(-2, 4, n).astype(np.int32),
        rng.uniform(-2, 3, (4, 2)).astype(np.float32),
        rng.uniform(-2, 3, (4, 2)).astype(np.float32),
    ]
    names = structure(tpipe).field_names_flat
    assert len(names) == len(flat), names
    return flat


def host_sample(pkg, i):
    sdg = structure(pkg)
    sdg.set_data([a.copy() for a in sample_leaves(i)])
    return sdg


def jnp_sample(i):
    sdg = structure(jpipe)
    sdg.set_data([jnp.asarray(a) for a in sample_leaves(i)])
    return sdg


def torch_batch(n=B):
    sdg = structure(tpipe)
    per = [sample_leaves(i) for i in range(n)]
    sdg.set_data([torch.from_numpy(np.stack(col)) for col in zip(*per)])
    return sdg


def _flat(sdg):
    return [np.asarray(v) for v in sdg.get_data()]


def check_host(make_step, i=0):
    """Both packages' steps on sample ``i``'s numpy leaves."""
    j = make_step(js)(host_sample(jpipe, i))
    t = make_step(ts)(host_sample(tpipe, i))
    assert t.field_names_flat == j.field_names_flat
    assert [str(x) for x in t.field_types_flat] == [str(x) for x in j.field_types_flat]
    for a, b in zip(_flat(t), _flat(j)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    return t


def check_device(make_step):
    """The port's step on a batch of tensors against the JAX step per
    sample on jnp leaves."""
    t = make_step(ts)(torch_batch())
    assert all(isinstance(v, torch.Tensor) for v in t.get_data())
    per = [make_step(js)(jnp_sample(i)) for i in range(B)]
    assert t.field_names_flat == per[0].field_names_flat
    for k, got in enumerate(_flat(t)):
        want = np.stack([_flat(p)[k] for p in per])
        assert got.dtype == want.dtype and got.shape == want.shape, t.field_names_flat[k]
        np.testing.assert_array_equal(got, want, err_msg=t.field_names_flat[k])
    return t


ANY_STEPS = {
    "axes_chw": lambda s: s.AxesLayoutSetter("image", "CHW"),
    "axes_identity": lambda s: s.AxesLayoutSetter(["image"], "HWC"),
    "remove_fields": lambda s: s.UnneededFieldRemover(["visibility", "num_pts"]),
    "remove_group": lambda s: s.UnneededFieldRemover("annotations"),
    "size_adder": lambda s: s.TensorSizeAdder("image", "_size"),
    "size_adder_float": lambda s: s.TensorSizeAdder("image", "_size", jpipe.DType.FLOAT
                                                    if s is js else tpipe.DType.FLOAT),
    "crop_boxes": lambda s: s.CoordinateCropper("bboxes", [0.0, 0.0, 0.0, 0.0],
                                                [18.0, 12.0, 18.0, 12.0]),
    "crop_points": lambda s: s.CoordinateCropper("points", [-1.0, 0.5], [2.0, 2.5]),
    "in_range": lambda s: s.PointsInRangeCheck("bboxes", "inside", [0, 0, 0, 0],
                                               [10, 10, 12.5, 10]),
    "in_range_points": lambda s: s.PointsInRangeCheck("points", "ok", [-1.0, 0.0], [2.0, 2.0]),
    "cond_and": lambda s: s.AnnotationElementConditionEval(
        "annotations", "is_valid = visibility > 0.4 and depths < 6", False),
    "cond_complex": lambda s: s.AnnotationElementConditionEval(
        "annotations", "keep = (visibility > 0.4 or depths < 3) and not (num_pts == 2)", False),
    "cond_int_minus": lambda s: s.AnnotationElementConditionEval(
        "annotations", "k = -num_pts >= -1 or visibility != 0.5", True),
    "cond_remove": lambda s: s.AnnotationElementConditionEval(
        "annotations", "v = visibility >= 0.5", True),
}


@pytest.mark.parametrize("name", sorted(ANY_STEPS))
def test_any_step_host_side(name):
    for i in range(2):
        check_host(ANY_STEPS[name], i)


@pytest.mark.parametrize("name", sorted(ANY_STEPS))
def test_any_step_device_side(name):
    check_device(ANY_STEPS[name])


def test_device_forms_stay_on_the_batch_and_make_no_host_copy(monkeypatch):
    """The device forms build their constants from Python scalars or on the
    tensor's device: ``torch.as_tensor``/``torch.tensor`` are never called."""
    def forbidden(*a, **kw):
        raise AssertionError("a device form copied a constant from host memory")

    steps = [ANY_STEPS[n](ts) for n in sorted(ANY_STEPS) if not n.startswith("remove")]
    monkeypatch.setattr(torch, "as_tensor", forbidden)
    monkeypatch.setattr(torch, "tensor", forbidden)
    for step in steps:
        step(torch_batch())


HOST_STEPS = {
    "visible_occlusion": lambda s: s.VisibleBboxSelector(
        "bboxes", "visible", image_hw_field_name="image_hw", depths_field_name="depths",
        check_for_minimum_size=False),
    "visible_both": lambda s: s.VisibleBboxSelector(
        "bboxes", ("annotations", "visible"), image_field_name="image",
        depths_field_name="depths", minimum_bbox_size=3.0),
    "visible_min_size": lambda s: s.VisibleBboxSelector(
        "bboxes", "big", image_hw=[16, 20], check_for_bbox_occlusion=False,
        minimum_bbox_size=5.0),
    "tile_pad": lambda s: s.ImageToTileSizePadder("image", 7),
    "tile_pad_hw": lambda s: s.ImageToTileSizePadder("image", [3, 8]),
}


@pytest.mark.parametrize("name", sorted(HOST_STEPS))
def test_host_step(name):
    for i in range(3):
        check_host(HOST_STEPS[name], i)


def test_conditional_element_remover_after_condition():
    def both(s):
        cond = s.AnnotationElementConditionEval("annotations", "keep = visibility > 0.3", False)
        rem = s.ConditionalElementRemover("annotations", "keep",
                                          ["bboxes", "depths", "visibility", "num_pts"],
                                          [0, 0, 0, 0], remove_mask_field=True)

        class Both(s.PipelineStepBase):
            placement = "host"

            def _check_and_adjust_data_format_input_to_output(self, d):
                return rem.check_input_data_format_and_set_output_data_format(
                    cond.check_input_data_format_and_set_output_data_format(d))

            def _process(self, d):
                return rem(cond(d))

        return Both()

    for i in range(3):
        out = check_host(both, i)
        assert not out["annotations"].has_child("keep")


def _ragged_samples(pkg, sizes):
    out = []
    for i, (n, m) in enumerate(sizes):
        s = pkg.SampleDataGroup()
        s.add_data_field("boxes", pkg.DType.FLOAT)
        s.add_data_field("ids", pkg.DType.INT32)
        cam = pkg.SampleDataGroup()
        cam.add_data_field("pts", pkg.DType.FLOAT)
        s.add_data_group_field_array("cams", cam, 2)
        rng = np.random.default_rng(i)
        s["boxes"] = rng.normal(size=(n, 4)).astype(np.float32)
        s["ids"] = np.arange(m, dtype=np.int32)
        for c in range(2):
            s["cams"][c]["pts"] = rng.normal(size=(n + c, 2)).astype(np.float32)
        out.append(s)
    return out


PADDINGS = {
    "all_fields": dict(),
    "boxes_fill": dict(field_names="boxes", fill_value=-1.0),
    "buckets_all_dims": dict(field_names=["boxes", "ids"], size_buckets=[4, 8, 16]),
    "buckets_dim0": dict(field_names=["boxes"], size_buckets=[4, 8], bucket_dims=(0,)),
    "group_array": dict(field_names="cams", fill_value=3.0),
    "pts_by_name": dict(field_names="pts", size_buckets=[6], bucket_dims=[0]),
}


@pytest.mark.parametrize("name", sorted(PADDINGS))
def test_padding_to_uniform_matches_jax(name):
    sizes = [(3, 2), (5, 7), (1, 4)]
    j = js.PaddingToUniform(**PADDINGS[name]).process_batch_checked(
        _ragged_samples(jpipe, sizes), check=True)
    t = ts.PaddingToUniform(**PADDINGS[name]).process_batch_checked(
        _ragged_samples(tpipe, sizes), check=True)
    for a, b in zip(t, j):
        for x, y in zip(_flat(a), _flat(b)):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", range(10))
def test_optimize_size_buckets_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 200, int(rng.integers(1, 60))).tolist()
    weights = rng.uniform(0.1, 5, len(sizes)).tolist() if seed % 2 else None
    for k in (1, 2, 3, 7, 100):
        assert ts.optimize_size_buckets(sizes, k, weights) == js.optimize_size_buckets(
            sizes, k, weights)


def test_optimize_size_buckets_errors_as_in_jax():
    for args in (([], 2), ([3], 0), ([3, 4], 2, [1.0]), ([7.9, 15.6], 2), ([3, -1], 2)):
        with pytest.raises(ValueError) as want:
            js.optimize_size_buckets(*args)
        with pytest.raises(ValueError) as got:
            ts.optimize_size_buckets(*args)
        assert str(got.value) == str(want.value)


def test_optimize_size_buckets_bruteforce_and_padder_shapes():
    """tests/test_size_buckets.py's oracle and padder cases on the port."""
    def waste(sizes, buckets):
        return sum(next(b for b in sorted(buckets) if b >= s) - s for s in sizes)

    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 40, 9).tolist()
    vals = sorted(set(sizes))
    best = min(waste(sizes, c) for r in range(1, 4) for c in itertools.combinations(vals, r)
               if c[-1] == vals[-1])
    assert waste(sizes, ts.optimize_size_buckets(sizes, 3)) == best
    assert ts.optimize_size_buckets([3, 7, 7, 11, 20], 10) == [3, 7, 11, 20]
    assert ts.optimize_size_buckets([4, 4, 4, 5, 100], 2, weights=[10, 10, 10, 10, 1]) == [5, 100]

    batch_maxes = rng.integers(5, 30, 20).tolist()
    buckets = ts.optimize_size_buckets(batch_maxes, 3)
    step = ts.PaddingToUniform("pts", size_buckets=buckets, bucket_dims=(0,))
    seen = set()
    for m in batch_maxes:
        samples = []
        for ln in (m, max(1, m - 2)):
            s = tpipe.SampleDataGroup()
            s.add_data_field("pts", tpipe.DType.FLOAT)
            s["pts"] = np.ones((ln, 2), np.float32)
            samples.append(s)
        shapes = {tuple(x["pts"].shape) for x in step._process_batch(samples)}
        assert len(shapes) == 1
        seen.add(shapes.pop())
    assert {sh[0] for sh in seen} <= set(buckets) and {sh[1] for sh in seen} == {2}


# ------------------------------ applied steps ------------------------------ #


def _offset_step(pkg_steps, torch_form):
    class AddRandomOffset(pkg_steps.PipelineStepBase):
        """Adds one draw to ``points`` in its sub-tree (per sample on the
        device)."""

        placement = "any"

        def _check_and_adjust_data_format_input_to_output(self, fmt):
            return fmt

        def _process(self, sdg):
            pts = sdg["points"]
            if torch_form and isinstance(pts, torch.Tensor):
                off = torch.as_tensor(self.random.uniform(0.0, 1.0, shape=(pts.shape[0],)))
                sdg["points"] = pts + off.to(pts.dtype)[:, None, None]
            else:
                sdg["points"] = np.asarray(pts) + float(self.random.uniform(0.0, 1.0))
            return sdg

    return AddRandomOffset()


WRAPPERS = {
    "in_path": (lambda s, inner: s.DataGroupInPathAppliedStep(inner, ("cams", 1)), 1),
    "with_name": (lambda s, inner: s.DataGroupsWithNameAppliedStep(inner, "annotations"), 0),
    "array_in_path": (lambda s, inner: s.DataGroupArrayInPathElementsAppliedStep(inner, "cams"),
                      2),
    "array_with_name": (lambda s, inner: s.DataGroupArrayWithNameElementsAppliedStep(
        inner, "cams"), 2),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_applied_step_draws_per_subtree_as_in_jax(name):
    make, draws = WRAPPERS[name]
    if name == "with_name":  # a deterministic inner step on the annotations
        check_host(lambda s: make(s, s.CoordinateCropper("bboxes", [0] * 4, [9.0] * 4)))
        check_device(lambda s: make(s, s.CoordinateCropper("bboxes", [0] * 4, [9.0] * 4)))
        return
    values = [0.1, 0.2, 0.3][:draws]
    outs = []
    for pkg, steps, form in ((jpipe, js, False), (tpipe, ts, False), (tpipe, ts, True)):
        inner = _offset_step(steps, form)
        wrapper = make(steps, inner)
        assert wrapper.placement == inner.placement
        ctx = pkg.ScriptedRandomContext()
        ctx.script_uniform(0.0, 1.0, values)
        wrapper.set_random_context(ctx)
        sample = torch_batch(1) if form else host_sample(pkg, 0)
        outs.append([np.asarray(v).reshape(np.asarray(v).shape[-2:]) if k.startswith("cams")
                     else None for k, v in zip(sample.field_names_flat, wrapper(sample).get_data())])
    j, t_host, t_dev = outs
    for a, b, c in zip(j, t_host, t_dev):
        if a is not None:
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(c, a)


def test_applied_step_forwards_the_thread_context():
    """set_random_context on the wrapper reaches the wrapped step through
    the per-thread map, and each thread sees its own context."""
    import threading

    inner = _offset_step(ts, True)
    wrapper = ts.DataGroupArrayWithNameElementsAppliedStep(inner, "cams")
    seen = {}

    def run(tid):
        ctx = tpipe.ScriptedRandomContext()
        wrapper.set_random_context(ctx)
        seen[tid] = inner.random is ctx and wrapper.random is ctx

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert seen == {i: True for i in range(4)}


def test_wrapper_blueprint_inference_matches_jax():
    for s, pkg in ((js, jpipe), (ts, tpipe)):
        bp = s.DataGroupArrayWithNameElementsAppliedStep(
            s.PointsInRangeCheck("points", "inside", [0, 0], [1, 1]), "cams"
        ).check_input_data_format_and_set_output_data_format(structure(pkg))
        assert bp["cams"][1].has_child("inside")


def test_processing_steps_cases_on_the_port():
    """tests/test_processing_steps.py's selection and condition cases."""
    sdg = host_sample(tpipe, 0)
    sdg["annotations"]["bboxes"] = np.array(
        [[2.0, 2.0, 8.0, 9.0], [3.0, 3.0, 7.0, 8.0], [15.0, 10.0, 19.0, 15.0]], np.float32)
    sdg["annotations"]["depths"] = np.array([5.0, 2.0, 7.0], np.float32)
    sdg["annotations"]["visibility"] = np.array([0.9, 0.1, 0.5], np.float32)
    sdg["annotations"]["num_pts"] = np.array([1, 0, 3], np.int32)
    base = sdg.get_empty_like_self()
    base.set_data([np.copy(v) for v in sdg.get_data()])

    def fresh():
        s = base.get_empty_like_self()
        s.set_data([np.copy(v) for v in base.get_data()])
        return s

    out = ts.AnnotationElementConditionEval(
        "annotations", "is_valid = visibility > 0.4 and depths < 6", False)(fresh())
    np.testing.assert_array_equal(out["annotations"]["is_valid"], [True, False, False])
    out = ts.AnnotationElementConditionEval(
        "annotations", "keep = (visibility > 0.4 or depths < 3) and not (depths == 7)",
        False)(fresh())
    np.testing.assert_array_equal(out["annotations"]["keep"], [True, True, False])
    with pytest.raises(KeyError):
        ts.AnnotationElementConditionEval("annotations", "v = nonexistent > 1", False) \
            .check_input_data_format_and_set_output_data_format(base.get_empty_like_self())
    out = ts.CoordinateCropper("bboxes", [0.0] * 4, [18.0, 12.0, 18.0, 12.0])(fresh())
    assert out["annotations"]["bboxes"].max() <= 18.0 and out["annotations"]["bboxes"][2, 3] == 12
    out = ts.PointsInRangeCheck("bboxes", "inside", [0, 0, 0, 0], [10, 10, 10, 10])(fresh())
    np.testing.assert_array_equal(out["annotations"]["inside"], [True, True, False])
    out = ts.VisibleBboxSelector("bboxes", "visible", image_hw_field_name="image_hw",
                                 depths_field_name="depths", check_for_minimum_size=False)(fresh())
    assert out["visible"].all()
    out = ts.VisibleBboxSelector("bboxes", "big", image_hw=[16, 20],
                                 check_for_bbox_occlusion=False, minimum_bbox_size=5.0)(fresh())
    np.testing.assert_array_equal(out["big"], [True, False, False])
    s = fresh()
    s["annotations"].add_data_field("keep", tpipe.DType.BOOL)
    s["annotations"]["keep"] = np.array([True, False, True])
    out = ts.ConditionalElementRemover("annotations", "keep", ["bboxes", "depths"], [0, 0],
                                       remove_mask_field=True)(s)
    assert out["annotations"]["bboxes"].shape == (2, 4)
    np.testing.assert_array_equal(out["annotations"]["depths"], [5.0, 7.0])
    with pytest.raises(ValueError):
        ts.PointsInRangeCheck("bboxes", "depths", [0] * 4, [1] * 4) \
            .check_input_data_format_and_set_output_data_format(base.get_empty_like_self())
