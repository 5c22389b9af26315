"""Sharded serving and expert parallelism on 4 gloo ranks
(``tests/torch_mesh_worker.py::case_serving``), held against the JAX package.

* ``tests/test_serving_export.py::test_sharded_export_rebinds_to_fresh_mesh``:
  the detector exported with its batch ``Shard(0)`` over ``data`` on a
  (data 2, model 2) mesh, rebound onto the transposed rank layout (ranks 1
  and 2 change data shards), bitwise its outputs on the exporting mesh, and
  within JAX's 5e-2 of JAX's unsharded apply on the same parameters; a function that needs a collective across
  the mesh (a batch mean) is refused at export.
* ``tests/test_inference_server.py::test_sharded_artifact_served_through_server``:
  the model-parallel artifact (``x @ w``, ``w`` ``Shard(1)`` over ``model``)
  through ``InferenceServer.from_artifact(mesh=)`` on ranks in another
  order, a pair of requests and a lone padded one; then four requests that
  reach one rank of the pair 0.3 s apart and the other at once, in both
  roles, each answered with its own row; ``pipeline_depth=2`` is refused.
* ``tests/test_moe_topk.py::test_top2_expert_parallel_matches_single_device``
  on (data 2, expert 2): the loss within 2e-5 of the one-rank step's, and the
  loss and the expert, router and input-layer gradients against the
  one-rank step's and ``jax.value_and_grad``'s (``tests/test_torch_moe.py``'s
  bounds), each rank holding 4 of the 8 experts.
"""

import numpy as np
import optax
import torch

import jax

from accvlab_tpu.models.centernet import CenterNetDetector as JaxDetector
from accvlab_tpu.models.moe import MoEClassifier as JaxMoE
from accvlab_tpu.models.moe import make_moe_example_batch, make_moe_train_step
from accvlab_tpu_torch.dryrun_multichip import flatten_inputs
from accvlab_tpu_torch.models.moe import MoEClassifier, moe_loss
from accvlab_tpu_torch.models.params import load_jax_params
from torch_mesh_worker import run_ranks

JAX_TOL = 5e-2  # the sharded artifact against JAX's unsharded apply (the JAX test's)
ONE_RANK_RTOL = 2e-5  # tests/test_moe_topk.py's sharded-against-single-device bound
LOSS_RTOL = 1e-4  # tests/test_torch_moe.py: the port's loss against JAX's
GRAD_RTOL = 2e-2  # tests/test_torch_moe.py: each gradient, relative to its largest magnitude
#: each gradient against the one-rank step's, relative to its largest
#: magnitude: the bf16 expert products are summed over 2 samples per data
#: rank before the sum over data (measured 3.8e-3)
ONE_RANK_GRAD_RTOL = 1e-2


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def test_four_ranks_sharded_serving_and_expert_parallel(tmp_path):
    rng = np.random.default_rng(0)
    jdet = JaxDetector(num_classes=4, width=8)
    det_params = _np_tree(jdet.init(jax.random.PRNGKey(0), np.zeros((2, 32, 32, 3), np.float32)))
    images = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    w = np.arange(24, dtype=np.float32).reshape(4, 6)
    x = np.float32([[1, 0, 0, 0], [0, 1, 0, 1]])
    reqs = np.arange(16, dtype=np.float32).reshape(4, 4)

    jmoe = JaxMoE(num_experts=8, dim=16, num_classes=5, num_selected=2)
    batch = make_moe_example_batch(batch_size=4, tokens=8, in_dim=12, num_classes=5)
    init_fn, _ = make_moe_train_step(jmoe)
    moe_params = _np_tree(init_fn(jax.random.PRNGKey(0), batch["tokens"]))
    inputs = {"images": images, "w": w, "x": x, "moe_tokens": np.array(batch["tokens"]),
              "moe_labels": np.array(batch["labels"]),
              **flatten_inputs("centernet", det_params), **flatten_inputs("moe", moe_params)}
    outs = run_ranks("serving", 4, str(tmp_path), inputs=inputs)

    want_heads = jdet.apply(det_params, images)
    for o in outs:
        for k, ref in want_heads.items():
            got = o[f"heads/{k}"]
            np.testing.assert_array_equal(got, o[f"heads_same_mesh/{k}"])
            ref = np.asarray(ref)
            assert np.abs(got - ref).max() <= JAX_TOL * max(1.0, np.abs(ref).max()), k
        assert bool(o["refused"])
        np.testing.assert_allclose(o["served"], np.concatenate([x @ w, x[:1] @ w]))
        np.testing.assert_allclose(o["skewed"], np.concatenate([reqs @ w] * 2))
        assert bool(o["depth_refused"])
        assert int(o["moe_local_experts"]) == 4
    # the transposed layout moved ranks 1 and 2 to the other data shard
    assert [o["data_index"].tolist() for o in outs] == [[0, 0], [0, 1], [1, 0], [1, 1]]

    # MoE: the one-rank step, and JAX's loss and gradients
    one = load_jax_params(MoEClassifier(8, 16, 5, 2), moe_params)
    tb = {"tokens": torch.from_numpy(np.array(batch["tokens"])),
          "labels": torch.from_numpy(np.array(batch["labels"]))}
    one_loss = moe_loss(one, tb)
    one_loss.backward()

    def loss_fn(p):
        logits, aux = jmoe.apply(p, batch["tokens"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch["labels"]).mean() + 0.01 * aux

    jloss, jgrads = jax.value_and_grad(loss_fn)(moe_params)
    g = jgrads["params"]
    want = {"w_in": np.asarray(g["SwitchFFN_0"]["w_in"]),
            "w_out": np.asarray(g["SwitchFFN_0"]["w_out"]),
            "router": np.asarray(g["SwitchFFN_0"]["router"]["kernel"]).T,
            "dense_0": np.asarray(g["Dense_0"]["kernel"]).T}
    ones = {"w_in": one.switch.w_in.grad, "w_out": one.switch.w_out.grad,
            "router": one.switch.router.weight.grad, "dense_0": one.dense_0.weight.grad}
    for o in outs:
        np.testing.assert_allclose(float(o["moe_loss"]), float(one_loss), rtol=ONE_RANK_RTOL)
        np.testing.assert_allclose(float(o["moe_loss"]), float(jloss), rtol=LOSS_RTOL)
        for name, ref in want.items():
            got = o[f"moe_grad/{name}"]
            assert np.abs(got - ref).max() <= GRAD_RTOL * np.abs(ref).max(), name
            err = np.abs(got - ones[name].numpy()).max()
            assert err <= ONE_RANK_GRAD_RTOL * np.abs(ref).max(), (name, err)
