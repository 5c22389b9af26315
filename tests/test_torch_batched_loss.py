"""The port's batched set loss (``accvlab_tpu_torch.batched_loss_computation``)
against ``examples/batched_loss_computation.py`` on the JAX package.

Inputs: ``make_data(seed=0)`` in both (the same numpy draws), at the
example's width (8 samples, 48 ground-truth rows sized {16, 32, 48}, 300
predictions, 10 classes) and a head of dim 256 with the same numpy weights
on both sides. Within 1e-5 relative (float32 softmax, log and sums, taken in
another order by XLA): the cost matrices, the batched loss, the per-sample
loop, and one full iteration's loss, head gradients and updated head. The
auction's matches (the plain version here) equal the JAX package's
``batched_auction_matching`` on the same cost, and the step with matches
from the device auction gives the host Hungarian loop's loss.
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accvlab_tpu.ragged import batched_auction_matching as jbatched_auction_matching
from accvlab_tpu_torch import batched_loss_computation as bl
from accvlab_tpu_torch.ragged import batched_auction_matching

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
RTOL = 1e-5


@pytest.fixture(scope="module")
def ex():
    sys.path.insert(0, EXAMPLES)
    try:
        return importlib.import_module("batched_loss_computation")
    finally:
        sys.path.remove(EXAMPLES)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data(ex):
    return ex.make_data(seed=0), bl.make_data(seed=0, device="cpu")


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_make_data_same_draws(data):
    j, t = data
    for k in ("bboxes_gt", "classes_gt", "weights_gt"):
        np.testing.assert_array_equal(t[k].tensor.numpy(), np.asarray(j[k].tensor))
        np.testing.assert_array_equal(t[k].sample_sizes.numpy(), np.asarray(j[k].sample_sizes))
    for k in ("bboxes_pred", "logits_pred", "existence_pred"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


def test_costs_match_jax(ex, data):
    j, t = data
    want = ex.compute_cost_matrices(j["bboxes_gt"], j["classes_gt"], j["bboxes_pred"],
                                    j["logits_pred"])
    got = bl.compute_cost_matrices(t["bboxes_gt"], t["classes_gt"], t["bboxes_pred"],
                                   t["logits_pred"])
    assert got.tensor.shape == (8, 300, 48) and got.non_uniform_dim == 2
    assert rel(got.tensor.numpy(), want.tensor) <= RTOL
    np.testing.assert_array_equal(got.sample_sizes.numpy(), np.asarray(want.sample_sizes))
    np.testing.assert_allclose(bl.iou_cost(t["bboxes_gt"].tensor, t["bboxes_pred"]).numpy(),
                               ex.iou_cost(j["bboxes_gt"].tensor, j["bboxes_pred"]),
                               rtol=RTOL, atol=1e-7)


@pytest.fixture(scope="module")
def host_matches(ex, data):
    j, t = data
    jm = ex.match(j["bboxes_gt"], j["classes_gt"], j["bboxes_pred"], j["logits_pred"])
    tm = bl.match(t["bboxes_gt"], t["classes_gt"], t["bboxes_pred"], t["logits_pred"])
    return jm, tm


def test_host_match_equals_jax(host_matches):
    jm, tm = host_matches
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.tensor.numpy(), np.asarray(b.tensor))
        np.testing.assert_array_equal(a.sample_sizes.numpy(), np.asarray(b.sample_sizes))


def _args(d, matches):
    return (d["bboxes_gt"], d["classes_gt"], d["bboxes_pred"], d["logits_pred"],
            d["existence_pred"], d["weights_gt"], *matches)


def test_batched_loss_and_per_sample_loop_match_jax(ex, data, host_matches):
    (j, t), (jm, tm) = data, host_matches
    want = float(ex.batched_loss(*_args(j, jm)))
    got = float(bl.batched_loss(*_args(t, tm)))
    assert abs(got - want) <= RTOL * abs(want)
    want_loop = float(ex.per_sample_loss_loop(j, *jm))
    got_loop = float(bl.per_sample_loss_loop(t, *tm))
    assert abs(got_loop - want_loop) <= RTOL * abs(want_loop)


def test_device_auction_matches_equal_jax(ex, data):
    j, t = data
    cost = ex.compute_cost_matrices(j["bboxes_gt"], j["classes_gt"], j["bboxes_pred"],
                                    j["logits_pred"]).tensor
    cost = jnp.swapaxes(cost, 1, 2)  # (B, num_gt, num_pred), as device_matching_comparison
    nv = j["classes_gt"].sample_sizes
    want = jbatched_auction_matching(cost, nv)
    on_jax_cost = batched_auction_matching(torch.from_numpy(np.array(cost)),
                                           torch.from_numpy(np.array(nv)))
    on_own_cost = bl.match_on_device(t["bboxes_gt"], t["classes_gt"], t["bboxes_pred"],
                                     t["logits_pred"])
    for got in (on_jax_cost, on_own_cost):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.tensor.numpy(), np.asarray(b.tensor))
            np.testing.assert_array_equal(a.sample_sizes.numpy(), np.asarray(b.sample_sizes))


def _jax_step(ex, lr):
    @jax.jit
    def step(params, feat, bboxes_gt, classes_gt, weights_gt, m_gt, m_pred):
        def loss_fn(p):
            boxes, logits, e = ex._head_forward(p, feat)
            return ex.batched_loss(bboxes_gt, classes_gt, boxes, logits, e, weights_gt, m_gt,
                                   m_pred)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        return jax.tree_util.tree_map(lambda a, g: a - lr * g, params, grads), loss, grads

    return step


def test_full_iteration_matches_jax(ex, data, host_matches):
    (j, t), (jm, tm) = data, host_matches
    lr = 1e-3
    feat = np.random.default_rng(1).normal(size=(8, 300, 256)).astype(np.float32)
    head = bl.make_head(256, 10, seed=0, device="cpu")
    jhead = {k: jnp.asarray(v.numpy()) for k, v in head.items()}
    new_j, loss_j, grads_j = _jax_step(ex, lr)(jhead, jnp.asarray(feat), j["bboxes_gt"],
                                               j["classes_gt"], j["weights_gt"], *jm)
    feat_t = torch.from_numpy(feat)
    loss_t, grads_t = bl.loss_and_grads(head, feat_t, t, tm)
    assert abs(float(loss_t) - float(loss_j)) <= RTOL * abs(float(loss_j))
    for k in head:
        assert rel(grads_t[k].numpy(), grads_j[k]) <= RTOL, k
    new_t, loss_host = bl.train_step(head, feat_t, t, tm, lr=lr)
    assert float(loss_host) == float(loss_t)
    for k in head:
        assert rel(new_t[k].numpy(), new_j[k]) <= RTOL, k
    # the device form matches inside the step (the plain auction here). The
    # cost has exact ties (ground truths of one class that no prediction
    # overlaps), so the auction may pick another optimal assignment than the
    # Hungarian: the same total cost and, boxes being far from the head's
    # outputs, the same loss; the gradients then follow its own pairs, held
    # against the JAX step on the JAX package's auction matches
    new_d, loss_dev = bl.train_step(head, feat_t, t, None, lr=lr)
    assert abs(float(loss_dev) - float(loss_host)) <= RTOL * abs(float(loss_host))
    cost = jnp.swapaxes(ex.compute_cost_matrices(j["bboxes_gt"], j["classes_gt"],
                                                 j["bboxes_pred"], j["logits_pred"]).tensor, 1, 2)
    jam = jbatched_auction_matching(cost, j["classes_gt"].sample_sizes)
    new_ja, loss_ja, _ = _jax_step(ex, lr)(jhead, jnp.asarray(feat), j["bboxes_gt"],
                                          j["classes_gt"], j["weights_gt"], *jam)
    assert abs(float(loss_dev) - float(loss_ja)) <= RTOL * abs(float(loss_ja))
    for k in head:
        assert rel(new_d[k].numpy(), new_ja[k]) <= RTOL, k

