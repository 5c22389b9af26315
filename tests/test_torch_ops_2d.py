"""The 2-D pipeline operators of the port against
``accvlab_tpu.pipeline.operators``, in both forms.

* numpy form (host steps): the same numpy inputs through both packages'
  numpy branches, equal bit for bit (the same arithmetic in the same
  order);
* torch form (device steps): a batch of per-sample inputs stacked into
  tensors through the port, against the JAX function on ``jnp`` arrays per
  sample: integer and boolean outputs bit for bit, float32 matrices and
  points within 1e-6 relative to the largest magnitude of the output (XLA's
  sin/cos and dot products against torch's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accvlab_tpu.pipeline.operators as jops
import accvlab_tpu_torch.pipeline.operators as tops

REL = 1e-6
B = 3


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _boxes(rng, n=7, hw=(30, 40)):
    x1 = rng.uniform(-10, hw[1], n)
    y1 = rng.uniform(-10, hw[0], n)
    return np.stack([x1, y1, x1 + rng.uniform(-5, 25, n), y1 + rng.uniform(-5, 20, n)],
                    1).astype(np.float32)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got.astype(np.float64) - want).max()) <= rel * scale


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_box_and_point_masks(seed):
    rng = np.random.default_rng(seed)
    boxes = [_boxes(rng) for _ in range(B)]
    hw = np.array([30, 40], np.int32)
    lo, hi = [0.0, 2.5, 0.0, 0.0], [35.0, 25.0, 40.0, 28.5]
    for b in boxes:
        _equal(tops.check_minimum_bbox_size(b, 4.0, hw), jops.check_minimum_bbox_size(b, 4.0, hw))
        _equal(tops.check_points_in_box(b, lo, hi), jops.check_points_in_box(b, lo, hi))
        _equal(tops.crop_coordinates(b, lo, hi), jops.crop_coordinates(b, lo, hi))
    tb = torch.from_numpy(np.stack(boxes))
    want_min = np.stack([np.asarray(jops.check_minimum_bbox_size(jnp.asarray(b), 4.0, hw))
                         for b in boxes])
    _equal(tops.check_minimum_bbox_size(tb, 4.0, hw).numpy(), want_min)
    hw_t = torch.from_numpy(np.stack([hw] * B))
    _equal(tops.check_minimum_bbox_size(tb, 4.0, hw_t).numpy(), want_min)
    _equal(tops.check_points_in_box(tb, lo, hi).numpy(),
           np.stack([np.asarray(jops.check_points_in_box(jnp.asarray(b), lo, hi)) for b in boxes]))
    _equal(tops.crop_coordinates(tb, lo, hi).numpy(),
           np.stack([np.asarray(jops.crop_coordinates(jnp.asarray(b), lo, hi)) for b in boxes]))


def test_crop_integer_points():
    pts = np.array([[-3, 5], [7, 12], [2, 2]], np.int32)
    want = jops.crop_coordinates(pts, [0, 0], [5, 10])
    _equal(tops.crop_coordinates(pts, [0, 0], [5, 10]), want)
    _equal(tops.crop_coordinates(torch.from_numpy(pts), [0, 0], [5, 10]).numpy(), want)


@pytest.mark.parametrize("seed", range(3))
def test_bbox_visibility_painter(seed):
    rng = np.random.default_rng(seed)
    boxes, depths = _boxes(rng, 12), rng.uniform(1, 50, 12).astype(np.float32)
    for shrink in (False, True):
        _equal(tops.check_bbox_visibility(boxes, depths, (30, 40), shrink),
               jops.check_bbox_visibility(boxes, depths, (30, 40), shrink))
    assert tops.check_bbox_visibiity is tops.check_bbox_visibility


def test_pad_remove_range_nans():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(5, 3)).astype(np.float32)
    for size in (3, 5, 8):
        _equal(tops.pad_to_size(a, size, -1.0), jops.pad_to_size(a, size, -1.0))
        _equal(tops.pad_to_size(torch.from_numpy(a), size, -1.0).numpy(),
               np.asarray(jops.pad_to_size(jnp.asarray(a), size, -1.0)))
    mask = np.array([True, False, True, True, False])
    _equal(tops.remove_inactive(a, mask), jops.remove_inactive(a, mask))
    _equal(tops.remove_inactive(a.T, mask, 1), jops.remove_inactive(a.T, mask, 1))
    ang = (rng.uniform(-20, 20, (4, 6))).astype(np.float32)
    _equal(tops.ensure_range(ang, -np.pi, np.pi, 2 * np.pi),
           jops.ensure_range(ang, -np.pi, np.pi, 2 * np.pi))
    _close(tops.ensure_range(torch.from_numpy(ang), -np.pi, np.pi, 2 * np.pi).numpy(),
           np.asarray(jops.ensure_range(jnp.asarray(ang), -np.pi, np.pi, 2 * np.pi)))
    nan = ang.copy()
    nan[1, 2] = nan[3, 0] = np.nan
    _equal(tops.replace_nans(nan, 7.5), jops.replace_nans(nan, 7.5))
    _equal(tops.replace_nans(torch.from_numpy(nan), 7.5).numpy(),
           np.asarray(jops.replace_nans(jnp.asarray(nan), 7.5)))
    x, y, z = (rng.normal(size=s).astype(np.float32) for s in ((2, 3), (4, 1), (1, 2)))
    for got, want in zip(tops.pad_to_common_size(x, y, z, fill_value=-2),
                         jops.pad_to_common_size(x, y, z, fill_value=-2)):
        _equal(got, want)


@pytest.mark.parametrize("homog", [False, True])
def test_matrices_from_vectors(homog):
    rng = np.random.default_rng(5)
    vecs = np.concatenate([rng.normal(size=(B, 3)), np.full((1, 3), 1e-9)]).astype(np.float32)
    for v in vecs:
        _equal(tops.get_rot_mat_from_rot_vector(v, homog), jops.get_rot_mat_from_rot_vector(v, homog))
        _equal(tops.get_scaling_mat_from_vector(v, homog), jops.get_scaling_mat_from_vector(v, homog))
        _equal(tops.get_translation_mat_from_vector(v), jops.get_translation_mat_from_vector(v))
    tv = torch.from_numpy(vecs)
    per = lambda f, *a: np.stack([np.asarray(f(jnp.asarray(v), *a)) for v in vecs])  # noqa: E731
    _close(tops.get_rot_mat_from_rot_vector(tv, homog).numpy(),
           per(jops.get_rot_mat_from_rot_vector, homog))
    _equal(tops.get_scaling_mat_from_vector(tv, homog).numpy(),
           per(jops.get_scaling_mat_from_vector, homog))
    _equal(tops.get_translation_mat_from_vector(tv).numpy(),
           per(jops.get_translation_mat_from_vector))


FLAGS = [dict(), dict(in_homog=True), dict(to_apply_to_is_transposed=True),
         dict(matrix_is_transposed=True), dict(matrix_is_inverted=True),
         dict(multiply_matrix_from_right=True),
         dict(make_apply_to_homog=True, to_apply_to_is_transposed=True)]


@pytest.mark.parametrize("flags", FLAGS, ids=[",".join(f) or "plain" for f in FLAGS])
def test_apply_matrix(flags):
    rng = np.random.default_rng(6)
    homog = flags.get("in_homog") or flags.get("make_apply_to_homog")
    d = 3
    m = d + 1 if homog else d
    mats = (rng.normal(size=(B, m, m)) + 3 * np.eye(m)).astype(np.float32)
    transposed = flags.get("to_apply_to_is_transposed")
    pts = rng.normal(size=(B, 5, d) if transposed else (B, d, 5)).astype(np.float32)
    if flags.get("multiply_matrix_from_right"):  # (d, 5) @ (5, 5)
        mats = (rng.normal(size=(B, 5, 5)) + 3 * np.eye(5)).astype(np.float32)
    for p, mt in zip(pts, mats):
        _equal(tops.apply_matrix(p, mt, **flags), jops.apply_matrix(p, mt, **flags))
    want = np.stack([np.asarray(jops.apply_matrix(jnp.asarray(p), jnp.asarray(mt), **flags))
                     for p, mt in zip(pts, mats)])
    rel = 1e-5 if flags.get("matrix_is_inverted") else REL  # LU solves in other orders
    _close(tops.apply_matrix(torch.from_numpy(pts), torch.from_numpy(mats), **flags).numpy(),
           want, rel)
    vec = pts[0].reshape(-1)[:d]
    mat = mats[0][:d, :d] if not homog else mats[0]
    if not homog:
        _equal(tops.apply_matrix(vec, mat), jops.apply_matrix(vec, mat))


def test_centres_and_radii_numpy_form():
    rng = np.random.default_rng(7)
    b = _boxes(rng)
    _equal(tops.get_center_from_bboxes(b), jops.get_center_from_bboxes(b))
    _equal(tops.get_radii_from_bboxes(b, 0.7), jops.get_radii_from_bboxes(b, 0.7))
