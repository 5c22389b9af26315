"""The port's polyline ops (``accvlab_tpu_torch.polyline``) against the JAX
package's on the CPU, with the same numpy inputs.

Tolerance: ``torch.cumsum`` adds the segment lengths in sequence, XLA's CPU
``cumsum`` does not, so the arc lengths (and the samples that lerp on them)
agree within ``8 * eps_f32 * max total length`` absolute (rtol 0), not
bitwise. The edge cases of ``tests/test_polyline.py`` agree exactly where
no sum of more than one segment is involved. Gradients: NaN at the same
places (``sqrt`` of a zero segment, before the mask, in both), the finite
values within the same tolerance scaled by the largest gradient.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accvlab_tpu.polyline as J
import accvlab_tpu_torch.polyline as T
from accvlab_tpu.ragged import RaggedBatch as JRB
from accvlab_tpu_torch.ragged import RaggedBatch as TRB

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
from bench_polyline import make_case  # noqa: E402

EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tol(points, sizes=None) -> float:
    """``8 * eps_f32 * max total length`` of the polylines (valid parts)."""
    p = np.asarray(points, np.float64)
    seg = np.linalg.norm(np.diff(p, axis=1), axis=2) if p.shape[1] > 1 else np.zeros((1, 1))
    if sizes is not None:
        seg = np.where(np.arange(seg.shape[1])[None] < np.asarray(sizes)[:, None] - 1, seg, 0)
    return 8 * EPS * max(float(seg.sum(axis=1).max()), 1.0)


def close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def both_interp(pts, d, relative=False):
    j = J.interpolate(jnp.asarray(pts), jnp.asarray(d), relative=relative)
    t = T.interpolate(torch.from_numpy(np.asarray(pts)), torch.from_numpy(np.asarray(d)),
                      relative=relative)
    return np.asarray(j), t.numpy()


def ragged_pair(tensor, sizes):
    tensor, sizes = np.asarray(tensor, np.float32), np.asarray(sizes, np.int32)
    return (JRB(jnp.asarray(tensor), sample_sizes=jnp.asarray(sizes)),
            TRB(torch.from_numpy(tensor), sample_sizes=torch.from_numpy(sizes)))


EDGE = {
    "straight": ([[[0.0, 0.0], [10.0, 0.0]]], [[0.0, 2.5, 5.0, 10.0]], False),
    "clamps": ([[[0.0, 0.0], [4.0, 0.0]]], [[-3.0, 99.0]], False),
    "relative": ([[[0.0, 0.0], [0.0, 8.0]]], [[0.25, 0.5, 1.5]], True),
    "one_point": ([[[2.0, 3.0]]], [[0.0, 1.0, -1.0]], False),
    "zero_length_segments": ([[[1.0, 1.0], [1.0, 1.0], [3.0, 1.0], [3.0, 1.0], [3.0, 4.0]]],
                             [[-1.0, 0.0, 1.0, 2.0, 3.5, 5.0, 9.0]], False),
    "all_repeated": ([[[5.0, 5.0], [5.0, 5.0], [5.0, 5.0]]], [[0.0, 0.5, 1.0]], True),
}


@pytest.mark.parametrize("name", sorted(EDGE))
def test_edge_cases_equal_jax(name):
    pts, d, relative = EDGE[name]
    pts, d = np.asarray(pts, np.float32), np.asarray(d, np.float32)
    j, t = both_interp(pts, d, relative)
    close(t, j, 0.0)


def test_empty_polylines_are_nan():
    pts = np.zeros((2, 0, 2), np.float32)
    d = np.ones((2, 3), np.float32)
    j, t = both_interp(pts, d)
    assert t.shape == (2, 3, 2) and np.isnan(t).all()
    close(t, j, 0.0)
    close(T.lengths(torch.from_numpy(pts)).numpy(), np.asarray(J.lengths(jnp.asarray(pts))), 0)


def test_multi_segment_and_lengths_equal_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(3, 7, 3)).astype(np.float32)
    d = rng.uniform(-1, 10, size=(3, 9)).astype(np.float32)
    j, t = both_interp(pts, d)
    close(t, j, tol(pts))
    close(T.lengths(torch.from_numpy(pts)).numpy(), np.asarray(J.lengths(jnp.asarray(pts))),
          tol(pts))


# bench_polyline's grid up to (64, 100, 100), its seeds
GRID = [(b, n, m) for b in (1, 64) for n in (10, 100) for m in (10, 100)]


@pytest.mark.parametrize("b,n,m", GRID)
def test_bench_polyline_cases_within_cumsum_tolerance(b, n, m):
    pts, rel = make_case(b, n, m, seed=b * 7 + n)
    j, t = both_interp(pts, rel, relative=True)
    close(t, j, tol(pts))
    close(T.lengths(torch.from_numpy(pts)).numpy(), np.asarray(J.lengths(jnp.asarray(pts))),
          tol(pts))


def test_var_size_batch_equals_jax():
    pts = [[[0.0, 0.0], [10.0, 0.0], [99.0, 99.0]], [[0.0, 0.0], [0.0, 2.0], [0.0, 4.0]]]
    jp, tp = ragged_pair(pts, [2, 3])
    jd, td = ragged_pair([[5.0, 0.0], [3.0, 0.0]], [1, 2])
    j = J.interpolate_var_size_batch(jp, jd)
    t = T.interpolate_var_size_batch(tp, td)
    assert isinstance(t, TRB)
    close(t.tensor.numpy(), np.asarray(j.tensor), 0.0)
    np.testing.assert_array_equal(t.sample_sizes.numpy(), [1, 2])
    close(T.lengths_var_size_batch(tp).numpy(), np.asarray(J.lengths_var_size_batch(jp)), 0.0)


@pytest.mark.parametrize("relative", [False, True])
def test_var_size_clamps_and_empty(relative):
    """The last valid point, not a padded one; an empty polyline is NaN;
    distances past num_distances are 0."""
    pts = [[[0.0, 0.0], [1.0, 0.0], [500.0, 500.0]], [[0.0, 0.0], [0.0, 0.0], [0.0, 0.0]],
           [[0.0, 0.0], [0.0, 10.0], [7.0, 7.0]]]
    jp, tp = ragged_pair(pts, [2, 0, 2])
    jd, td = ragged_pair([[50.0, 0.5], [1.0, 1.0], [0.5, 3.0]], [1, 2, 2])
    j = J.interpolate_var_size_batch(jp, jd, relative=relative)
    t = T.interpolate_var_size_batch(tp, td, relative=relative)
    close(t.tensor.numpy(), np.asarray(j.tensor), 0.0)
    assert np.isnan(t.tensor.numpy()[1]).all()
    assert (t.tensor.numpy()[0, 1] == 0).all()
    close(T.lengths_var_size_batch(tp).numpy(), np.asarray(J.lengths_var_size_batch(jp)), 0.0)


def test_ragged_batch_of_64_polylines():
    """chip_smoke's ragged case (64 polylines of 2-1000 points) at 64 x 2-100."""
    rng = np.random.default_rng(5)
    sizes = rng.integers(2, 101, 64).astype(np.int32)
    pts = np.cumsum(rng.uniform(-1, 1, (64, 100, 2)), axis=1).astype(np.float32)
    dsz = rng.integers(1, 33, 64).astype(np.int32)
    d = rng.uniform(-0.1, 1.1, (64, 32)).astype(np.float32)
    jp, tp = ragged_pair(pts, sizes)
    jd, td = ragged_pair(d, dsz)
    j = J.interpolate_var_size_batch(jp, jd, relative=True)
    t = T.interpolate_var_size_batch(tp, td, relative=True)
    close(t.tensor.numpy(), np.asarray(j.tensor), tol(pts, sizes))
    close(T.lengths_var_size_batch(tp).numpy(), np.asarray(J.lengths_var_size_batch(jp)),
          tol(pts, sizes))


def grad_pair(pts, d, relative):
    g_j = jax.grad(lambda p: jnp.sum(J.interpolate(p, jnp.asarray(d), relative=relative) ** 2))(
        jnp.asarray(pts))
    p = torch.from_numpy(pts).requires_grad_(True)
    (T.interpolate(p, torch.from_numpy(d), relative=relative) ** 2).sum().backward()
    return np.asarray(g_j), p.grad.numpy()


@pytest.mark.parametrize("relative", [False, True])
@pytest.mark.parametrize("repeated", [False, True])
def test_gradients_equal_jax_grad(relative, repeated):
    rng = np.random.default_rng(3)
    pts = np.cumsum(rng.uniform(-1, 1, (4, 12, 2)), axis=1).astype(np.float32)
    if repeated:
        pts[1, 5] = pts[1, 4]  # a zero segment: NaN in both
    d = rng.uniform(-0.5, 12.0, (4, 20)).astype(np.float32)
    if relative:
        d = d / 12.0
    j, t = grad_pair(pts, d, relative)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    assert np.isnan(j).any() == repeated
    fin = ~np.isnan(j)
    scale = max(float(np.abs(j[fin]).max()), 1.0)
    np.testing.assert_allclose(t[fin], j[fin], rtol=0, atol=tol(pts) * scale)


def test_var_size_gradients_nan_at_padding_as_jax():
    rng = np.random.default_rng(4)
    pts = np.cumsum(rng.uniform(-1, 1, (3, 6, 2)), axis=1).astype(np.float32)
    sizes = np.array([6, 3, 4], np.int32)
    pts[np.arange(6)[None] >= sizes[:, None]] = 0.0  # zero padding: zero segments
    d = rng.uniform(0, 1, (3, 5)).astype(np.float32)

    def jloss(p):
        out = J.interpolate_var_size_batch(JRB(p, sample_sizes=jnp.asarray(sizes)),
                                           JRB.FromFullTensor(jnp.asarray(d)), relative=True)
        return jnp.sum(out.tensor)

    j = np.asarray(jax.grad(jloss)(jnp.asarray(pts)))
    p = torch.from_numpy(pts).requires_grad_(True)
    T.interpolate_var_size_batch(TRB(p, sample_sizes=torch.from_numpy(sizes)),
                                 TRB.FromFullTensor(torch.from_numpy(d)),
                                 relative=True).tensor.sum().backward()
    t = p.grad.numpy()
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    assert np.isnan(j).any()
    fin = ~np.isnan(j)
    np.testing.assert_allclose(t[fin], j[fin], rtol=0, atol=tol(pts) * 10)


def test_a_tensor_and_another_device_raise():
    """numpy inputs go to ``device`` (tests/test_torch_import.py holds the
    card default); a tensor on another device than the one asked raises."""
    assert T.interpolate(np.zeros((1, 2, 2), np.float32), np.zeros((1, 1), np.float32),
                         device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="lies on"):
        T.lengths(torch.zeros((1, 2, 2)), device="cuda")

