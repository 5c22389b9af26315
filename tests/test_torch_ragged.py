"""Parity of ``accvlab_tpu_torch.ragged`` with ``accvlab_tpu.ragged``.

Every public function of ``indexing_ops``, ``bool_indexing`` and
``processing`` and the ``RaggedBatch`` API run in both packages on the same
numpy inputs, made from a seed (the cases of ``tests/test_indexing_ops.py``,
``test_ragged_batch.py`` and ``test_ragged_processing.py``, plus random
ones).

Tolerances: the gathers, scatters, compactions and layouts only move data,
so they are compared bitwise, and so are their adjoints, including the
gather's adjoint with duplicate indices: XLA's CPU scatter-add sums the
duplicates in ascending slot order, which is the order the port fixes. The
reductions (``average_over_targets``, ``sum_over_targets``) sum in another
order than XLA, so they are held within rtol 1e-6.
"""

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accvlab_tpu.ragged as J
import accvlab_tpu_torch.ragged as T

GOLDENS = os.path.join(os.path.dirname(__file__), "data", "goldens", "heatmap_goldens.npz")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def pair(tensor, sizes=None, mask=None, nud=None):
    """The same RaggedBatch in both packages (port on the CPU)."""
    opt = lambda x, f: None if x is None else f(np.asarray(x))  # noqa: E731
    j = J.RaggedBatch(jnp.asarray(tensor), opt(mask, jnp.asarray), opt(sizes, jnp.asarray), nud)
    t = T.RaggedBatch(torch.from_numpy(np.asarray(tensor)), opt(mask, torch.from_numpy),
                      opt(sizes, torch.from_numpy), nud)
    return t, j


def as_np(x):
    if isinstance(x, (T.RaggedBatch, J.RaggedBatch)):
        x = x.tensor
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_bitwise(got, want):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if got.dtype.kind == "f":
        bits = np.dtype(f"u{got.dtype.itemsize}")
        np.testing.assert_array_equal(got.view(bits), want.view(bits))
    else:
        np.testing.assert_array_equal(got, want)


def assert_same_ragged(t: T.RaggedBatch, j: J.RaggedBatch):
    assert t.non_uniform_dim == j.non_uniform_dim
    assert t.batch_shape == j.batch_shape
    assert_bitwise(t.tensor, j.tensor)
    assert_bitwise(t.mask, j.mask)
    assert_bitwise(t.sample_sizes, j.sample_sizes)


def rng_for(name: str):
    return np.random.default_rng(sum(map(ord, name)))


# --------------------------------------------------------------------- #
# RaggedBatch                                                           #
# --------------------------------------------------------------------- #


def make_pair():
    # batch of 3 samples, sizes [2, 3, 1], data dim 2
    return pair(np.arange(18, dtype=np.float32).reshape(3, 3, 2), sizes=np.array([2, 3, 1], np.int32))


def test_mask_and_sizes_derive_like_jax():
    t, j = make_pair()
    assert_same_ragged(t, j)
    mask = np.array([[True, False], [True, True]])
    t2, j2 = pair(np.ones((2, 2, 4), np.float32), mask=mask)
    assert_same_ragged(t2, j2)
    assert (t2.num_batch_dims, t2.non_uniform_dim) == (1, 1)


def test_basic_properties():
    t, j = make_pair()
    assert (t.max_sample_size, t.batch_shape, t.total_num_samples_in_batch,
            t.total_num_entries, t.shape) == (j.max_sample_size, j.batch_shape,
                                              j.total_num_samples_in_batch,
                                              j.total_num_entries, j.shape)
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert t.size() == j.size() and t.size(1) == j.size(1) and t.dim() == j.dim()


def test_constructors_like_jax():
    full = np.ones((2, 4, 3), np.float32)
    assert_same_ragged(T.RaggedBatch.FromFullTensor(torch.from_numpy(full)),
                       J.RaggedBatch.FromFullTensor(jnp.asarray(full)))
    over = np.arange(10, dtype=np.float32).reshape(2, 5, 1)
    sizes = np.array([2, 3], np.int32)
    for bound in (None, 4):
        assert_same_ragged(
            T.RaggedBatch.FromOversizeTensor(torch.from_numpy(over),
                                             sample_sizes=torch.from_numpy(sizes),
                                             max_sample_size=bound),
            J.RaggedBatch.FromOversizeTensor(jnp.asarray(over), sample_sizes=jnp.asarray(sizes),
                                             max_sample_size=bound))
    mask = np.array([[True, False, False, False, False], [True, True, False, False, False]])
    assert_same_ragged(
        T.RaggedBatch.FromOversizeTensor(torch.from_numpy(over), mask=torch.from_numpy(mask)),
        J.RaggedBatch.FromOversizeTensor(jnp.asarray(over), mask=jnp.asarray(mask)))
    for kw in (dict(), dict(batch_shape=(4, 5)), dict(num_batch_dims=2)):
        nud = 2 if kw else 1
        assert_same_ragged(T.RaggedBatch.Empty(3, nud, device="cpu", **kw),
                           J.RaggedBatch.Empty(3, nud, **kw))


def test_empty_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.RaggedBatch.Empty(3, 1)


@pytest.mark.parametrize("nud", [1, 2])
def test_with_padded_set_to_and_existence_weights(nud):
    tensor = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    sizes = np.array([1, 3 if nud == 1 else 4], np.int32)
    t, j = pair(tensor, sizes=sizes, nud=nud)
    assert_same_ragged(t.with_padded_set_to(-1.0), j.with_padded_set_to(-1.0))
    assert_bitwise(t.get_existence_weights(), j.get_existence_weights())
    t.set_padded_to(-2.0)
    j.set_padded_to(-2.0)
    assert_same_ragged(t, j)


def test_padded_gradient_is_zero_like_jax():
    t, j = make_pair()
    g = jax.grad(lambda x: jnp.sum(J.RaggedBatch(x, j.mask, j.sample_sizes)
                                   .with_padded_set_to(0.0).tensor ** 2))(j.tensor)
    x = t.tensor.clone().requires_grad_(True)
    (T.RaggedBatch(x, t.mask, t.sample_sizes).with_padded_set_to(0.0).tensor ** 2).sum().backward()
    assert_bitwise(x.grad, g)


def test_transposes_and_batch_dim_transforms_like_jax():
    t, j = make_pair()
    assert_same_ragged(t.get_non_uniform_dimension_transposed_to(2),
                       j.get_non_uniform_dimension_transposed_to(2))
    assert_same_ragged(t.repeat_samples(2, batch_dim=0), j.repeat_samples(2, batch_dim=0))
    assert_same_ragged(t.unsqueeze_batch_dim(0), j.unsqueeze_batch_dim(0))
    assert_same_ragged(t.unsqueeze_batch_dim(1).squeeze_batch_dim(1), j)
    for dim in (1, -1, 2):
        assert_same_ragged(t.unsqueeze_data_dim(dim), j.unsqueeze_data_dim(dim))
    tensor = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    sizes = np.array([[1, 2, 3], [4, 0, 2]], np.int32)
    t2, j2 = pair(tensor, sizes=sizes)
    assert_same_ragged(t2.flatten_batch_dims(), j2.flatten_batch_dims())
    assert_same_ragged(t2.flatten_batch_dims().reshape_batch_dims((3, 2)),
                       j2.flatten_batch_dims().reshape_batch_dims((3, 2)))
    assert_same_ragged(t2.repeat_samples([2, 1]), j2.repeat_samples([2, 1]))
    assert_same_ragged(t2.broadcast_batch_dims_to_shape((4, 3)),
                       j2.broadcast_batch_dims_to_shape((4, 3)))
    one_t, one_j = pair(np.ones((1, 3, 2), np.float32), sizes=np.array([3], np.int32))
    for a, b in zip(T.RaggedBatch.broadcast_batch_dims([t, one_t]),
                    J.RaggedBatch.broadcast_batch_dims([j, one_j])):
        assert_same_ragged(a, b)
    with pytest.raises(ValueError):
        t2.squeeze_batch_dim(0)


def test_split_like_jax():
    t, j = make_pair()
    for a, b in zip(t.split(), j.split()):
        assert_bitwise(a, b)
    tensor = np.arange(60, dtype=np.float32).reshape(2, 2, 5, 3)
    t2, j2 = pair(tensor, sizes=np.array([[1, 2], [3, 0]], np.int32), nud=2)
    for row_t, row_j in zip(t2.split(), j2.split()):
        for a, b in zip(row_t, row_j):
            assert_bitwise(a, b)


def test_apply_arity_and_conversions():
    t, j = make_pair()
    assert_same_ragged(t.apply(lambda x: x * 2), j.apply(lambda x: x * 2))
    masked_t = t.apply(lambda x, m: torch.where(m[..., None], x, -x))
    masked_j = j.apply(lambda x, m: jnp.where(m[..., None], x, -x))
    assert_same_ragged(masked_t, masked_j)
    sized_t = t.apply(lambda x, m, s: x + s[:, None, None])
    sized_j = j.apply(lambda x, m, s: x + s[:, None, None])
    assert_same_ragged(sized_t, sized_j)
    assert isinstance(t.apply(lambda x: (x, x)), tuple)
    for name, dtype in [("int", torch.int32), ("long", torch.int64), ("bool", torch.bool),
                        ("half", torch.float16), ("bfloat16", torch.bfloat16),
                        ("float", torch.float32), ("double", torch.float64),
                        ("cfloat", torch.complex64), ("cdouble", torch.complex128)]:
        conv = getattr(t, name)()
        assert conv.dtype == dtype and conv.sample_sizes is t.sample_sizes
    assert_same_ragged(t.to(dtype=torch.int32), j.to(dtype=jnp.int32))
    assert t.detach().tensor.requires_grad is False


def test_setitem_rebinds_without_aliasing():
    t, j = make_pair()
    shared = t.create_with_sample_sizes_like_self(t.tensor)
    t[0, 0, 0] = 99.0
    j[0, 0, 0] = 99.0
    assert_same_ragged(t, j)
    assert float(shared.tensor[0, 0, 0]) == 0.0


def test_create_with_sample_sizes_like_self_validates():
    t, _ = make_pair()
    with pytest.raises(AssertionError):
        t.create_with_sample_sizes_like_self(torch.zeros((4, 3, 2)))  # wrong batch
    with pytest.raises(AssertionError):
        t.create_with_sample_sizes_like_self(torch.zeros((3, 5, 2)))  # wrong max size


# --------------------------------------------------------------------- #
# indexing_ops                                                          #
# --------------------------------------------------------------------- #

# data (B..., N, *D), I indices per sample in [lo, hi), sizes in [0, I]
GATHER_CASES = {
    "basic": dict(batch=(3,), n=7, inner=(), i=5, lo=0, hi=7),
    "inner_dims": dict(batch=(2,), n=6, inner=(3,), i=4, lo=0, hi=6),
    "negative_and_out_of_range": dict(batch=(4,), n=5, inner=(2,), i=6, lo=-12, hi=12),
    "duplicates": dict(batch=(3,), n=4, inner=(2,), i=9, lo=0, hi=2),
    "multi_batch": dict(batch=(2, 3), n=5, inner=(2,), i=4, lo=-5, hi=5),
    "no_indices": dict(batch=(2,), n=5, inner=(), i=0, lo=0, hi=5),
}


def gather_inputs(name):
    spec = GATHER_CASES[name]
    rng = rng_for(name)
    batch, n, inner, i = spec["batch"], spec["n"], spec["inner"], spec["i"]
    data = rng.normal(size=(*batch, n, *inner)).astype(np.float32)
    idx = rng.integers(spec["lo"], spec["hi"], (*batch, i)).astype(np.int32)
    sizes = rng.integers(0, i + 1, batch).astype(np.int32)
    return data, idx, sizes, rng


@pytest.mark.parametrize("name", sorted(GATHER_CASES))
def test_batched_indexing_access_and_adjoint_bitwise(name):
    data, idx, sizes, rng = gather_inputs(name)
    ti, ji = pair(idx, sizes=sizes)
    out_j, vjp = jax.vjp(lambda d: J.batched_indexing_access(d, ji, filler_value=-5.0).tensor,
                         jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_(True)
    out_t = T.batched_indexing_access(x, ti, filler_value=-5.0)
    assert_bitwise(out_t, out_j)
    assert_bitwise(out_t.sample_sizes, ji.sample_sizes)
    ct = rng.normal(size=out_j.shape).astype(np.float32)
    (grad_j,) = vjp(jnp.asarray(ct))
    out_t.tensor.backward(torch.from_numpy(ct))
    assert_bitwise(x.grad, grad_j)


def test_gather_adjoint_sums_duplicates_in_slot_order():
    # one row, three slots on index 1: the sum must be ((0 + a) + b) + c
    vals = np.array([[1e8, 1.0, -1e8]], np.float32)
    idx = T.RaggedBatch(torch.tensor([[1, 1, 1]], dtype=torch.int32),
                        sample_sizes=torch.tensor([3], dtype=torch.int32))
    x = torch.zeros((1, 3), requires_grad=True)
    T.batched_indexing_access(x, idx).tensor.backward(torch.from_numpy(vals))
    assert x.grad.tolist() == [[0.0, np.float32(np.float32(1e8) + 1.0) - np.float32(1e8), 0.0]]


def test_gather_index_dim_and_ragged_input_like_jax():
    rng = rng_for("dim_to_index_in")
    data = rng.normal(size=(2, 4, 3)).astype(np.float32)
    idx = np.array([[2, 0], [1, 1]], np.int32)
    ti, ji = pair(idx, sizes=np.array([2, 1], np.int32))
    assert_same_ragged(T.batched_indexing_access(torch.from_numpy(data), ti, dim_to_index_in=2),
                       J.batched_indexing_access(jnp.asarray(data), ji, dim_to_index_in=2))
    td, jd = pair(data, sizes=np.array([3, 2], np.int32))
    assert_same_ragged(T.batched_indexing_access(td, ti), J.batched_indexing_access(jd, ji))


@pytest.mark.parametrize("name", ["basic", "inner_dims", "negative_and_out_of_range",
                                  "multi_batch"])
def test_inverse_indexing_and_write_and_adjoints_bitwise(name):
    data, idx, sizes, rng = gather_inputs(name)
    nbd = len(GATHER_CASES[name]["batch"])
    n = data.shape[nbd]
    # unique targets per sample (duplicate writes are undefined); slots past
    # n point out of range and are dropped; odd rows use negative indices
    for b in np.ndindex(*idx.shape[:nbd]):
        row = np.concatenate([rng.permutation(n), np.arange(n, n + idx.shape[nbd])])
        row = row[: idx.shape[nbd]]
        idx[b] = np.where(row < n, row - (b[0] % 2) * n, row)
    ti, ji = pair(idx, sizes=sizes)
    vals = rng.normal(size=idx.shape + data.shape[nbd + 1:]).astype(np.float32)

    out_j, vjp = jax.vjp(lambda v: J.batched_inverse_indexing_access(v, ji, n, -1.0),
                         jnp.asarray(vals))
    v = torch.from_numpy(vals).requires_grad_(True)
    out_t = T.batched_inverse_indexing_access(v, ti, n, -1.0)
    assert_bitwise(out_t, out_j)
    ct = rng.normal(size=out_j.shape).astype(np.float32)
    out_t.backward(torch.from_numpy(ct))
    assert_bitwise(v.grad, vjp(jnp.asarray(ct))[0])

    out_j, vjp = jax.vjp(lambda v, d: J.batched_indexing_write(v, ji, d), jnp.asarray(vals),
                         jnp.asarray(data))
    v = torch.from_numpy(vals).requires_grad_(True)
    d = torch.from_numpy(data).requires_grad_(True)
    out_t = T.batched_indexing_write(v, ti, d)
    assert_bitwise(out_t, out_j)
    out_t.backward(torch.from_numpy(ct))
    gv, gd = vjp(jnp.asarray(ct))
    assert_bitwise(v.grad, gv)
    assert_bitwise(d.grad, gd)  # written positions zeroed

    mask_j = J.get_mask_from_indices(n, ji)
    assert_bitwise(T.get_mask_from_indices(n, ti), mask_j)


def test_indexing_write_ragged_output_like_jax():
    ti, ji = pair(np.array([[0, 2]], np.int32), sizes=np.array([2], np.int32))
    to, jo = pair(np.zeros((1, 4), np.float32), sizes=np.array([4], np.int32))
    vals = np.array([[5.0, 6.0]], np.float32)
    out_t = T.batched_indexing_write(torch.from_numpy(vals), ti, to)
    assert isinstance(out_t, T.RaggedBatch)
    assert_same_ragged(out_t, J.batched_indexing_write(jnp.asarray(vals), ji, jo))


@pytest.mark.parametrize("ragged", [False, True])
def test_batched_index_mapping_and_adjoint_bitwise(ragged):
    rng = rng_for(f"mapping{ragged}")
    source = rng.normal(size=(3, 5, 2)).astype(np.float32)
    target = rng.normal(size=(3, 6, 2)).astype(np.float32)
    src = rng.integers(-5, 5, (3, 4)).astype(np.int32)
    tgt = np.stack([rng.permutation(6)[:4] for _ in range(3)]).astype(np.int32)
    sizes = np.array([4, 2, 0], np.int32)
    tsi, jsi = pair(src, sizes=sizes)
    tti, jti = pair(tgt, sizes=sizes)

    def wrap_j(s, t):
        if ragged:
            s = J.RaggedBatch(s, sample_sizes=jnp.array([5, 3, 4], jnp.int32))
            t = J.RaggedBatch(t, sample_sizes=jnp.array([6, 6, 1], jnp.int32))
        out = J.batched_index_mapping(s, jsi, jti, t)
        return out.tensor if ragged else out

    out_j, vjp = jax.vjp(wrap_j, jnp.asarray(source), jnp.asarray(target))
    s = torch.from_numpy(source).requires_grad_(True)
    t = torch.from_numpy(target).requires_grad_(True)
    s_in, t_in = s, t
    if ragged:
        s_in = T.RaggedBatch(s, sample_sizes=torch.tensor([5, 3, 4], dtype=torch.int32))
        t_in = T.RaggedBatch(t, sample_sizes=torch.tensor([6, 6, 1], dtype=torch.int32))
    out_t = T.batched_index_mapping(s_in, tsi, tti, t_in)
    assert isinstance(out_t, T.RaggedBatch) == ragged
    out_t = out_t.tensor if ragged else out_t
    assert_bitwise(out_t, out_j)
    ct = rng.normal(size=out_j.shape).astype(np.float32)
    out_t.backward(torch.from_numpy(ct))
    gs, gt = vjp(jnp.asarray(ct))
    assert_bitwise(s.grad, gs)
    assert_bitwise(t.grad, gt)


@pytest.mark.parametrize("accumulate", [False, True])
def test_ragged_scatter_new_flat_primitive(accumulate):
    rng = rng_for(f"scatter_new{accumulate}")
    vals = rng.normal(size=(3, 6, 2)).astype(np.float32)
    idx = rng.integers(-9, 9, (3, 6)).astype(np.int32)
    if not accumulate:  # duplicate writes are undefined
        idx = np.stack([rng.permutation(np.arange(-4, 4))[:6] for _ in range(3)]).astype(np.int32)
    nums = np.array([6, 3, 0], np.int32)
    got = T.ragged_scatter_new(torch.from_numpy(vals), torch.from_numpy(idx),
                               torch.from_numpy(nums), 4, 0.5, accumulate)
    want = J.ragged_scatter_new(jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(nums), 4, 0.5,
                                accumulate)
    assert_bitwise(got, want)
    into = rng.normal(size=(3, 4, 2)).astype(np.float32)
    if not accumulate:
        assert_bitwise(T.ragged_scatter_insert(torch.from_numpy(vals), torch.from_numpy(idx),
                                               torch.from_numpy(nums), torch.from_numpy(into)),
                       J.ragged_scatter_insert(jnp.asarray(vals), jnp.asarray(idx),
                                               jnp.asarray(nums), jnp.asarray(into)))
    assert_bitwise(T.ragged_gather(torch.from_numpy(into), torch.from_numpy(idx),
                                   torch.from_numpy(nums), 2.0),
                   J.ragged_gather(jnp.asarray(into), jnp.asarray(idx), jnp.asarray(nums), 2.0))


# --------------------------------------------------------------------- #
# bool_indexing                                                         #
# --------------------------------------------------------------------- #

BOOL_CASES = ["tensor_tensor", "ragged_data", "ragged_mask", "inner_dims", "static_bound",
              "multi_batch_transposed"]


def bool_inputs(name):
    rng = rng_for(name)
    inner = (2,) if name in ("inner_dims", "multi_batch_transposed") else ()
    batch = (2, 2) if name == "multi_batch_transposed" else (3,)
    n = 6
    data = rng.normal(size=(*batch, n, *inner)).astype(np.float32)
    mask = rng.random((*batch, n)) < 0.5
    sizes = rng.integers(0, n + 1, batch).astype(np.int32)
    if name == "multi_batch_transposed":
        data = np.swapaxes(data, -1, -2).copy()  # non-uniform dim last
        td, jd = pair(data, sizes=sizes, nud=3)
        tm, jm = pair(mask, sizes=sizes)
        return (td, tm), (jd, jm), rng
    if name == "ragged_data":
        td, jd = pair(data, sizes=sizes)
        return (td, torch.from_numpy(mask)), (jd, jnp.asarray(mask)), rng
    if name == "ragged_mask":
        tm, jm = pair(mask, sizes=sizes)
        return (torch.from_numpy(data), tm), (jnp.asarray(data), jm), rng
    return (torch.from_numpy(data), torch.from_numpy(mask)), (jnp.asarray(data),
                                                              jnp.asarray(mask)), rng


@pytest.mark.parametrize("name", BOOL_CASES)
def test_batched_bool_indexing_and_write_bitwise(name):
    (td, tm), (jd, jm), rng = bool_inputs(name)
    bound = 6 if name == "static_bound" else None
    out_t = T.batched_bool_indexing(td, tm, bound)
    out_j = J.batched_bool_indexing(jd, jm, bound)
    assert_same_ragged(out_t, out_j)
    into_t = td if isinstance(td, T.RaggedBatch) else torch.zeros_like(td)
    into_j = jd if isinstance(jd, J.RaggedBatch) else jnp.zeros_like(jd)
    back_t = T.batched_bool_indexing_write(out_t, tm, into_t)
    back_j = J.batched_bool_indexing_write(out_j, jm, into_j)
    assert_bitwise(back_t, back_j)


@pytest.mark.parametrize("name", ["tensor_tensor", "inner_dims"])
def test_bool_indexing_adjoints_bitwise(name):
    (td, tm), (jd, jm), rng = bool_inputs(name)
    out_j, vjp = jax.vjp(lambda d: J.batched_bool_indexing(d, jm, 6).tensor, jd)
    x = td.clone().requires_grad_(True)
    out_t = T.batched_bool_indexing(x, tm, 6).tensor
    assert_bitwise(out_t, out_j)
    ct = rng.normal(size=out_j.shape).astype(np.float32)
    out_t.backward(torch.from_numpy(ct))
    assert_bitwise(x.grad, vjp(jnp.asarray(ct))[0])

    compact_j = J.batched_bool_indexing(jd, jm, 6)
    compact_t = T.batched_bool_indexing(td, tm, 6)
    into = rng.normal(size=td.shape).astype(np.float32)
    out_j, vjp = jax.vjp(lambda c, i: J.batched_bool_indexing_write(
        J.RaggedBatch(c, sample_sizes=compact_j.sample_sizes), jm, i), compact_j.tensor,
        jnp.asarray(into))
    c = compact_t.tensor.clone().requires_grad_(True)
    i = torch.from_numpy(into).requires_grad_(True)
    out_t = T.batched_bool_indexing_write(T.RaggedBatch(c, sample_sizes=compact_t.sample_sizes),
                                          tm, i)
    assert_bitwise(out_t, out_j)
    ct = rng.normal(size=out_j.shape).astype(np.float32)
    out_t.backward(torch.from_numpy(ct))
    gc, gi = vjp(jnp.asarray(ct))
    assert_bitwise(c.grad, gc)
    assert_bitwise(i.grad, gi)


def test_compact_by_mask_and_indices_from_mask_like_jax():
    rng = rng_for("compact")
    data = rng.normal(size=(4, 7, 3)).astype(np.float32)
    mask = rng.random((4, 7)) < 0.4
    out_t, counts_t = T.compact_by_mask(torch.from_numpy(data), torch.from_numpy(mask), 5, -1.0)
    out_j, counts_j = J.compact_by_mask(jnp.asarray(data), jnp.asarray(mask), 5, -1.0)
    assert_bitwise(out_t, out_j)
    assert_bitwise(counts_t, counts_j)
    assert_same_ragged(T.get_indices_from_mask(torch.from_numpy(mask)),
                       J.get_indices_from_mask(jnp.asarray(mask)))
    tm, jm = pair(mask, sizes=np.array([7, 3, 0, 5], np.int32))
    assert_same_ragged(T.get_indices_from_mask(tm, 7), J.get_indices_from_mask(jm, 7))


# --------------------------------------------------------------------- #
# processing                                                            #
# --------------------------------------------------------------------- #

REDUCE_CASES = {
    "plain": dict(shape=(3, 5), sizes=[2, 5, 1], nud=None),
    "empty_sample": dict(shape=(2, 4), sizes=[3, 0], nud=None),
    "inner_dims": dict(shape=(3, 4, 2), sizes=[1, 4, 2], nud=None),
    "transposed": dict(shape=(2, 3, 5), sizes=[5, 2], nud=2),
}


@pytest.mark.parametrize("name", sorted(REDUCE_CASES))
def test_reductions_and_their_gradients_like_jax(name):
    spec = REDUCE_CASES[name]
    rng = rng_for(name)
    data = rng.normal(size=spec["shape"]).astype(np.float32) * 10
    sizes = np.array(spec["sizes"], np.int32)
    t, j = pair(data, sizes=sizes, nud=spec["nud"])
    for fn_t, fn_j in [(T.average_over_targets, J.average_over_targets),
                       (T.sum_over_targets, J.sum_over_targets)]:
        out_j, vjp = jax.vjp(lambda x: fn_j(J.RaggedBatch(x, j.mask, j.sample_sizes,
                                                          spec["nud"])), j.tensor)
        x = t.tensor.clone().requires_grad_(True)
        out_t = fn_t(T.RaggedBatch(x, t.mask, t.sample_sizes, spec["nud"]))
        np.testing.assert_allclose(as_np(out_t), as_np(out_j), rtol=1e-6, atol=0)
        ct = rng.normal(size=out_j.shape).astype(np.float32)
        out_t.backward(torch.from_numpy(ct))
        np.testing.assert_allclose(as_np(x.grad), as_np(vjp(jnp.asarray(ct))[0]), rtol=1e-6,
                                   atol=0)


def test_apply_mask_and_squeeze_like_jax():
    rng = rng_for("mask_squeeze")
    data = rng.normal(size=(2, 3, 4)).astype(np.float32)
    mask = rng.random((2, 3)) < 0.5
    assert_bitwise(T.apply_mask_to_tensor(torch.from_numpy(data), torch.from_numpy(mask), -1.0),
                   J.apply_mask_to_tensor(jnp.asarray(data), jnp.asarray(mask), -1.0))
    t, j = pair(np.ones((4, 1, 1, 3, 4, 1), np.float32), sizes=np.full((4, 1), 3, np.int32),
                nud=3)
    assert_same_ragged(T.squeeze_except_batch_and_sample(t), J.squeeze_except_batch_and_sample(j))
    plain = np.ones((2, 3, 1, 4, 1), np.float32)
    assert_bitwise(T.squeeze_except_batch_and_sample(torch.from_numpy(plain)),
                   J.squeeze_except_batch_and_sample(jnp.asarray(plain)))


def test_compact_lists_like_jax():
    rng = rng_for("compact_lists")
    mask = rng.random((3, 5)) < 0.6
    a = rng.normal(size=(3, 5)).astype(np.float32)
    b = rng.normal(size=(3, 5, 2)).astype(np.float32)
    out_t = T.get_compact_lists(torch.from_numpy(mask), [torch.from_numpy(a), "keep", b])
    out_j = J.get_compact_lists(jnp.asarray(mask), [jnp.asarray(a), "keep", b])
    assert out_t[1] == "keep"
    assert_same_ragged(out_t[0], out_j[0])
    assert_same_ragged(out_t[2], out_j[2])

    class Pair(NamedTuple):
        x: object
        tag: str

    nt_t = T.get_compact_from_named_tuple(torch.from_numpy(mask), Pair(torch.from_numpy(a), "t"), 5)
    nt_j = J.get_compact_from_named_tuple(jnp.asarray(mask), Pair(jnp.asarray(a), "t"), 5)
    assert isinstance(nt_t, Pair) and nt_t.tag == "t"
    assert_same_ragged(nt_t.x, nt_j.x)


COMBINE_CASES = {
    "flat": dict(data=lambda r: [r.normal(size=(k,)).astype(np.float32) for k in (2, 1, 3)]),
    "nested_flattened": dict(data=lambda r: [[r.normal(size=(1,)).astype(np.float32),
                                              r.normal(size=(2,)).astype(np.float32)],
                                             [r.normal(size=(1,)).astype(np.float32)]]),
    "nested_preserved": dict(data=lambda r: [[r.normal(size=(k, 2)).astype(np.float32)
                                              for k in (1, 2)],
                                             [r.normal(size=(k, 2)).astype(np.float32)
                                              for k in (0, 1)]], flatten=False),
    "inner_dims": dict(data=lambda r: [r.normal(size=(2, 3)).astype(np.float32),
                                       np.zeros((1, 3), np.float32)]),
}


@pytest.mark.parametrize("name", sorted(COMBINE_CASES))
def test_combine_data_like_jax(name):
    spec = COMBINE_CASES[name]
    parts = spec["data"](rng_for(name))
    flatten = spec.get("flatten", True)
    first_t = T.combine_data(parts, device="cpu", flatten_batch_dims=flatten)
    first_j = J.combine_data(parts, flatten_batch_dims=flatten)
    assert_same_ragged(first_t, first_j)
    double = lambda d: d * 2 if isinstance(d, np.ndarray) else [double(e) for e in d]  # noqa: E731
    again = double(parts)
    assert_same_ragged(
        T.combine_data(again, other_with_same_sample_sizes=first_t, device="cpu",
                       flatten_batch_dims=flatten),
        J.combine_data(again, other_with_same_sample_sizes=first_j, flatten_batch_dims=flatten))


def test_combine_data_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.combine_data([np.zeros(2, np.float32)])


def _golden(name):
    g = np.load(GOLDENS)
    prefix = name + "/"
    return {k[len(prefix):]: g[k] for k in g.files if k.startswith(prefix)}


def test_combine_data_layout_bitwise_vs_golden():
    g = _golden("layout_combine")
    splits = np.cumsum(g["lengths"])[:-1]
    rb = T.combine_data([torch.from_numpy(a) for a in np.split(g["concat"], splits, axis=0)],
                        device="cpu")
    assert_bitwise(rb.tensor, g["tensor"])
    assert_bitwise(rb.mask, g["mask"])
    assert_bitwise(rb.sample_sizes, g["sizes"].astype(np.int32))


def test_get_compact_lists_layout_bitwise_vs_golden():
    g = _golden("layout_compact")
    (rb,) = T.get_compact_lists(torch.from_numpy(g["mask"]), [torch.from_numpy(g["values"])])
    assert_bitwise(rb.tensor, g["compact"])
    assert_bitwise(rb.mask, g["out_mask"])
    assert_bitwise(rb.sample_sizes, g["sizes"].astype(np.int32))
