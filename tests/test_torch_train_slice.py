"""The training slice end to end on the CPU, in both packages.

The port's training pipeline (bench.py's, with the (h, w) output) runs at a
small size (2 cameras of 96x256, batch 2, out 64x176, heatmap 10x16x44);
each batch is adapted by the port's ``batch_to_train_inputs`` and, as the
same numpy arrays, by the JAX example's
(``examples/train_centernet_e2e.py``); then a width-8 CenterNet with the
same flax parameters takes two steps in each package.

Tolerances: the adapted batch only moves data, so it is bitwise. The steps
run bf16 convs: losses within 2e-2 relative; parameters within 2·lr per
step of JAX's (Adam moves a parameter by about ±lr whatever the size of its
gradient, so a gradient near zero may move the other way), and the median
within 1e-2·lr, the gradients' bf16 agreement times the second step's size.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accvlab_tpu.models import centernet as J
from accvlab_tpu_torch.models import centernet as T
from accvlab_tpu_torch.models.params import jax_params_of, load_jax_params
from accvlab_tpu_torch.ragged import RaggedBatch
from accvlab_tpu_torch.train_centernet_e2e import batch_to_train_inputs, build_train_pipeline

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
LR, STEPS = 1e-3, 2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_example():
    sys.path.insert(0, EXAMPLES)  # for its own `object_detection_2d_pipeline` import
    try:
        import train_centernet_e2e
    finally:
        sys.path.remove(EXAMPLES)
    return train_centernet_e2e


@pytest.fixture(scope="module")
def batches():
    torch.set_num_threads(1)
    pipe = build_train_pipeline(batch_size=2, device="cpu", num_threads=2, hw=(96, 256),
                                num_cams=2, out_hw=(64, 176), heatmap_hw=(16, 44), num_samples=8)
    try:
        return [{k: v.numpy().copy() for k, v in pipe.run().items()} for _ in range(STEPS)]
    finally:
        pipe.stop()


def as_np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_inputs(got, want):
    np.testing.assert_array_equal(as_np(got["images"]), as_np(want["images"]))
    assert set(got["targets"]) == set(want["targets"])
    for k, w in want["targets"].items():
        g = got["targets"][k]
        if k == "heatmap":
            assert g.shape == w.shape
            np.testing.assert_array_equal(as_np(g), as_np(w))
            continue
        assert isinstance(g, RaggedBatch)
        assert as_np(g.tensor).dtype == as_np(w.tensor).dtype, k
        np.testing.assert_array_equal(as_np(g.tensor), as_np(w.tensor), err_msg=k)
        np.testing.assert_array_equal(as_np(g.sample_sizes), as_np(w.sample_sizes), err_msg=k)


def test_pipeline_outputs_the_training_fields(batches):
    for cam in range(2):
        p = f"cameras.[{cam}].annotations."
        b = batches[0]
        assert b[p + "hw"].shape == b[p + "offset"].shape == (2, 32, 2)
        assert b[p + "active"].any() and not b[p + "active"].all()


def test_batch_to_train_inputs_matches_the_example(jax_example, batches):
    for batch in batches:
        want = [jax_example.batch_to_train_inputs({k: jnp.asarray(v) for k, v in batch.items()})]
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        assert_same_inputs(batch_to_train_inputs(tbatch), want[0])
        # several cameras: the per-camera inputs, concatenated camera-major
        other = {k.replace("cameras.[1]", "cameras.[0]"): jnp.asarray(v)
                 for k, v in batch.items() if k.startswith("cameras.[1]")}
        want.append(jax_example.batch_to_train_inputs(other))
        both = batch_to_train_inputs(tbatch, cam=[0, 1])
        cat = {"images": np.concatenate([as_np(w["images"]) for w in want]),
               "targets": {}}
        for k in want[0]["targets"]:
            parts = [w["targets"][k] for w in want]
            if k == "heatmap":
                cat["targets"][k] = np.concatenate([as_np(p) for p in parts])
            else:
                cat["targets"][k] = RaggedBatch(
                    np.concatenate([as_np(p.tensor) for p in parts]),
                    sample_sizes=np.concatenate([as_np(p.sample_sizes) for p in parts]))
        assert_same_inputs(both, cat)


def test_two_train_steps_match_jax(jax_example, batches):
    inputs_j = [jax_example.batch_to_train_inputs({k: jnp.asarray(v) for k, v in b.items()})
                for b in batches]
    inputs_t = [batch_to_train_inputs({k: torch.from_numpy(v) for k, v in b.items()})
                for b in batches]
    jmodel = J.CenterNetDetector(num_classes=10, width=8)
    init_j, step_j = J.make_train_step(jmodel)
    params, opt_state = init_j(jax.random.PRNGKey(0), inputs_j[0]["images"][:1])
    init_t, step_t = T.make_train_step(T.CenterNetDetector(10, width=8))
    model, opt = init_t(0, inputs_t[0]["images"])
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))

    step_j = jax.jit(step_j)
    for bj, bt in zip(inputs_j, inputs_t):
        params, opt_state, mj = step_j(params, opt_state, bj)
        _, _, mt = step_t(model, opt, bt)
        for k in mj:
            assert np.isfinite(float(mt[k]))
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=2e-2, err_msg=k)
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, params))
    got = jax.tree_util.tree_leaves(jax_params_of(model))
    diffs = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    assert diffs.max() <= STEPS * 2 * LR * (1 + 1e-3) and np.median(diffs) < 1e-2 * LR
