"""The port's lane-regression trainer (``accvlab_tpu_torch.lane_regression_training``)
against ``examples/lane_regression_training.py`` on the JAX package, on the
CPU, from the example's own ``init_params`` (numpy arrays through
``load_jax_params``) and the same numpy batches.

Tolerances: the loss and every parameter's gradient within 1e-5 relative
(the gradients relative to each one's largest magnitude): float32 matrix
products and arc-length sums taken in another order by XLA, and
``torch.linspace`` one float32 ulp off ``jnp.linspace`` in a few of the 16
sample positions. Ten steps of ``run`` within 1e-4 relative per loss: on
top of that, ``optax.adam`` and ``torch.optim.Adam`` round their (equal in
exact arithmetic) updates differently, and training carries the
differences forward.
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accvlab_tpu.ragged import RaggedBatch as JRB
from accvlab_tpu_torch import lane_regression_training as L
from accvlab_tpu_torch.models.params import jax_params_of, load_jax_params

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
RTOL = 1e-5
STEPS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ex():
    sys.path.insert(0, EXAMPLES)
    try:
        return importlib.import_module("lane_regression_training")
    finally:
        sys.path.remove(EXAMPLES)


@pytest.fixture(scope="module")
def params(ex):
    return {k: np.asarray(v) for k, v in ex.init_params(jax.random.PRNGKey(0)).items()}


def jax_batch(r, p, s):
    return jnp.asarray(r), JRB(jnp.asarray(p), sample_sizes=jnp.asarray(s))


@pytest.mark.parametrize("seed", [0, 1])
def test_make_lane_batch_equals_the_example(ex, seed):
    a = ex.make_lane_batch(16, np.random.default_rng(seed))
    b = L.make_lane_batch(16, np.random.default_rng(seed))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_params_round_trip(params):
    model = load_jax_params(L.LaneRegressor(), params)
    back = jax_params_of(model)
    assert sorted(back) == sorted(params)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(L.LaneRegressor(), {k: v for k, v in params.items() if k != "b3"})


def test_predict_equals_the_example(ex, params):
    r, _, _ = L.make_lane_batch(8, np.random.default_rng(2))
    want = np.asarray(ex.predict({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(r)))
    with torch.no_grad():
        got = L.make_model(params=params, device="cpu")(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("seed", [0, 3])
def test_loss_and_every_gradient_equal_jax_value_and_grad(ex, params, seed):
    r, p, s = L.make_lane_batch(32, np.random.default_rng(seed))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jl, jg = jax.value_and_grad(ex.arc_length_loss)(jp, *jax_batch(r, p, s))
    model = L.make_model(params=params, device="cpu")
    loss = L.arc_length_loss(model, *L.batch_to_device(r, p, s, torch.device("cpu")))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL)
    grads = {}
    for i, layer in enumerate((model.fc1, model.fc2, model.fc3), start=1):
        grads[f"w{i}"] = layer.weight.grad.T.numpy()
        grads[f"b{i}"] = layer.bias.grad.numpy()
    for k, g in grads.items():
        want = np.asarray(jg[k])
        assert np.abs(g - want).max() <= RTOL * np.abs(want).max(), k


def test_ten_steps_of_run_equal_the_example(ex, params):
    import optax

    opt = optax.adam(L.LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)

    @jax.jit
    def step(jp, state, r, gt):
        loss, grads = jax.value_and_grad(ex.arc_length_loss)(jp, r, gt)
        updates, state = opt.update(grads, state, jp)
        return optax.apply_updates(jp, updates), state, loss

    rng = np.random.default_rng(0)
    want = []
    for _ in range(10):
        jp, state, loss = step(jp, state, *jax_batch(*ex.make_lane_batch(32, rng)))
        want.append(float(loss))
    _, got = L.train(10, 32, 0, device="cpu", params=params)
    np.testing.assert_allclose(got, want, rtol=STEPS_RTOL)
    first, last = ex.run(num_steps=10, batch_size=32, seed=0, verbose=False)
    np.testing.assert_allclose(L.run(10, 32, 0, device="cpu", params=params), (first, last),
                               rtol=STEPS_RTOL)


def test_run_converges_from_a_seeded_model():
    """The example's assertion on a shortened run (40 steps of 16)."""
    first, last = L.run(num_steps=40, batch_size=16, seed=0, device="cpu")
    assert last < first * 0.5
