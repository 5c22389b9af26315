"""Parity of ``accvlab_tpu_torch.ragged`` auction matching with
``accvlab_tpu.ragged``.

The plain torch version (the CPU path and the CUDA kernel's oracle) runs the
JAX round with the same float32 operations in the same order, and the same
stable compaction, so every case is held **bitwise**: the per-row columns of
``auction_matching`` and both ``RaggedBatch``es of
``batched_auction_matching`` (tensor and sample sizes), on the same numpy
costs. The kernel itself runs only on a card
(``tests/test_torch_matching_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accvlab_tpu.ragged import auction_matching as jax_auction
from accvlab_tpu.ragged import batched_auction_matching as jax_batched
from accvlab_tpu_torch.ragged import auction_matching, batched_auction_matching
from accvlab_tpu_torch.ragged.matching import auction_assignment


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_case(name: str):
    """(cost (B, R, C) float32, num_valid (B,) int32, max_iters, eps) of one
    named case, from a seed."""
    rng = np.random.default_rng(sorted(CASES).index(name))
    b, r, c, kind, iters, eps = CASES[name]
    if kind == "uniform":
        cost = rng.uniform(0, 10, (b, r, c))
    elif kind == "normal":
        cost = rng.normal(size=(b, r, c))
    elif kind == "ties":  # few distinct integer costs: many equal values and bids
        cost = rng.integers(0, 3, (b, r, c))
    elif kind == "nan":  # a diverging loss: NaN entries, and one row all NaN
        cost = rng.uniform(0, 10, (b, r, c))
        cost[rng.uniform(size=(b, r, c)) < 0.05] = np.nan
        cost[-1, 1] = np.nan
    else:  # the batched loss example's scale: class + IoU costs in [-2, 0]
        cost = -rng.uniform(0, 2, (b, r, c))
    nv = rng.integers(0, r + 1, b)
    nv[0] = r
    return cost.astype(np.float32), nv.astype(np.int32), iters, eps


# name: (B, R, C, kind, max_iters, eps)
CASES = {
    "random": (4, 12, 30, "uniform", 20000, None),
    "random_normal": (3, 9, 14, "normal", 20000, None),
    "tie_heavy": (4, 10, 13, "ties", 20000, None),
    "tie_heavy_square": (3, 8, 8, "ties", 20000, None),
    "ragged": (6, 16, 40, "example", 20000, None),
    "unconverged": (2, 6, 8, "normal", 1, None),
    "unconverged_3": (3, 10, 12, "uniform", 3, None),
    "c_is_1": (3, 1, 1, "normal", 25, None),
    "r_eq_c": (4, 16, 16, "uniform", 20000, None),
    "explicit_eps": (3, 7, 11, "uniform", 20000, 0.05),
    # a NaN bid never wins and holds its column for the round (as the NaN
    # column max of jnp and torch does); with the default eps a NaN in the
    # cost makes eps NaN and no row is ever assigned
    "nan_explicit_eps": (3, 8, 12, "nan", 40, 0.05),
    "nan_default_eps": (2, 6, 9, "nan", 30, None),
    "example_shape": (2, 48, 300, "example", 20000, None),
}


def jax_cols(cost, nv, iters, eps):
    return np.asarray(jax.vmap(lambda m, n: jax_auction(m, n, eps, iters))(
        jnp.asarray(cost), jnp.asarray(nv)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_auction_equals_jax_bitwise(name):
    cost, nv, iters, eps = make_case(name)
    cols, rounds, bids = auction_assignment(torch.from_numpy(cost), torch.from_numpy(nv), eps,
                                            iters)
    np.testing.assert_array_equal(cols.numpy(), jax_cols(cost, nv, iters, eps))
    assert cols.dtype == torch.int32 and rounds.dtype == torch.int32 and bids.dtype == torch.int32
    assert (rounds.numpy() <= iters).all()
    # every round of a sample has at least one bidder and at most its valid rows
    bidders = np.minimum(nv, cost.shape[1])
    assert (rounds.numpy() <= bids.numpy()).all()
    assert (bids.numpy() <= rounds.numpy() * bidders).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_batched_matching_equals_jax_bitwise(name):
    cost, nv, iters, eps = make_case(name)
    mg_j, mp_j = jax_batched(jnp.asarray(cost), jnp.asarray(nv), eps, iters)
    mg_t, mp_t = batched_auction_matching(torch.from_numpy(cost), torch.from_numpy(nv), eps,
                                          iters)
    for got, want in ((mg_t, mg_j), (mp_t, mp_j)):
        assert got.tensor.dtype == torch.int32 and got.sample_sizes.dtype == torch.int32
        np.testing.assert_array_equal(got.tensor.numpy(), np.asarray(want.tensor))
        np.testing.assert_array_equal(got.sample_sizes.numpy(), np.asarray(want.sample_sizes))


@pytest.mark.parametrize("num_valid", [None, 0, 3, 5])
def test_single_matrix_equals_jax_bitwise(num_valid):
    rng = np.random.default_rng(11)
    cost = rng.uniform(0, 10, (5, 9)).astype(np.float32)
    nv_j = None if num_valid is None else jnp.int32(num_valid)
    want = np.asarray(jax_auction(jnp.asarray(cost), nv_j))
    got = auction_matching(torch.from_numpy(cost), num_valid)
    np.testing.assert_array_equal(got.numpy(), want)
    got_t = auction_matching(torch.from_numpy(cost),
                             None if num_valid is None else torch.tensor(num_valid))
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_unconverged_rows_drop_out_one_to_one():
    """``test_matching.py:54``'s shape: after one round most rows are still
    unassigned; the compacted prefix counts only assigned pairs, each
    prediction at most once."""
    cost, nv, _, _ = make_case("unconverged")
    cols, rounds, bids = auction_assignment(torch.from_numpy(cost), torch.from_numpy(nv), None, 1)
    assert rounds.tolist() == [1, 1] and bids.tolist() == nv.tolist() and (cols.numpy() < 0).any()
    mg, mp = batched_auction_matching(torch.from_numpy(cost), torch.from_numpy(nv), max_iters=1)
    for s, n in enumerate(mg.sample_sizes.tolist()):
        assert n <= nv[s]
        assert len(set(mp.tensor[s, :n].tolist())) == n
        assert len(set(mg.tensor[s, :n].tolist())) == n


def test_c_is_1_never_assigns_and_runs_max_iters():
    """C == 1: the second best is -inf, the bid inf, which never wins."""
    cost = np.ones((2, 1, 1), np.float32)
    cols, rounds, bids = auction_assignment(torch.from_numpy(cost), torch.tensor([1, 0]), None, 7)
    assert cols.tolist() == [[-1], [-1]] and rounds.tolist() == [7, 0] and bids.tolist() == [7, 0]


def test_kernel_on_a_cpu_tensor_raises():
    cost = torch.zeros((1, 2, 3))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        batched_auction_matching(cost, torch.ones(1, dtype=torch.int32), implementation="kernel")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        auction_matching(cost[0], implementation="kernel")
    with pytest.raises(ValueError, match="implementation must be one of"):
        auction_matching(cost[0], implementation="cuda")


def test_more_rows_than_columns_raises():
    with pytest.raises(ValueError, match="at least as many columns as rows"):
        auction_matching(torch.zeros((3, 2)))
