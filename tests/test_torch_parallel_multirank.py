"""The port's ``parallel`` on meshes of several gloo ranks on the CPU, held
against the JAX package on the same inputs (numpy, from a seed).

Each case spawns its ranks (``tests/torch_mesh_worker.py``: fresh
processes, a ``FileStore`` under ``tmp_path``, the port only) and bounds
them with a time limit; JAX's side runs here on the virtual CPU devices of
``tests/conftest.py``.

* 2 ranks: ``tests/test_multihost.py``'s twin (disjoint input shards from
  ``host_shard_info``, ``shard_batch``'s global tensor) with
  ``tests/test_ragged_sharding.py``'s ragged loss summed over the data axis;
* 4 ranks on (data 2, pipe 2): ``pipeline_loss``'s loss and every stage's
  gradients against ``jax.value_and_grad`` of JAX's ``pipeline_loss`` on the
  same (2, 2) mesh, the dry-run stanza's widths (``__graft_entry__.py:326-380``:
  dim 32, 6 microbatches); ``pipeline_apply``'s outputs against JAX's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from accvlab_tpu.parallel import pipeline_apply, pipeline_loss
from accvlab_tpu.ragged import RaggedBatch, average_over_targets, batched_indexing_access
from torch_mesh_worker import run_ranks

RTOL = 1e-5
DIM, N_MICRO, MB = 32, 6, 4


def test_two_ranks_shard_batch_input_shards_and_ragged_loss(tmp_path):
    rng = np.random.default_rng(0)
    b, t = 16, 6
    inputs = {"classes": rng.normal(size=(b, t)).astype(np.float32),
              "sizes": rng.integers(1, t + 1, (b,)).astype(np.int32),
              "matches": rng.integers(0, t, (b, t)).astype(np.int32)}
    outs = run_ranks("shard", 2, str(tmp_path), inputs=inputs)

    ids = [set(o["ids"].tolist()) for o in outs]
    assert not ids[0] & ids[1], "the ranks' input shards overlap"
    # every rank assembled the same global batch: each row is 4 copies of
    # its sample id
    want_total = 4.0 * (sum(ids[0]) + sum(ids[1]))
    assert [float(o["total"]) for o in outs] == [want_total, want_total]

    rb_c = RaggedBatch(jnp.asarray(inputs["classes"]), sample_sizes=jnp.asarray(inputs["sizes"]))
    rb_m = RaggedBatch(jnp.asarray(inputs["matches"]), sample_sizes=jnp.asarray(inputs["sizes"]))
    want = float(jnp.sum(average_over_targets(
        batched_indexing_access(rb_c, rb_m).apply(lambda x: x * x))))
    for o in outs:
        np.testing.assert_allclose(float(o["ragged_loss"]), want, rtol=1e-6)

    # on a (data 1, model 2) mesh the ranks share a data coordinate: one
    # input shard, the same batch on both, which shard_batch declares
    # replicated over model
    assert [tuple(o["model_mesh_shard"]) for o in outs] == [(0, 1), (0, 1)]
    assert outs[0]["model_mesh_label"].shape == (8,)
    np.testing.assert_array_equal(outs[0]["model_mesh_label"], outs[1]["model_mesh_label"])
    np.testing.assert_array_equal(outs[0]["model_mesh_image"], outs[1]["model_mesh_image"])


def _pp_inputs():
    rng = np.random.default_rng(2)
    return {"w": (rng.normal(size=(2, DIM, DIM)) * 0.2).astype(np.float32),
            "b": (rng.normal(size=(2, DIM)) * 0.05).astype(np.float32),
            "xs": rng.normal(size=(N_MICRO, MB, DIM)).astype(np.float32),
            "tgts": rng.normal(size=(N_MICRO, MB, DIM)).astype(np.float32)}


def _jax_mesh():
    return Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "pipe"))


def _stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_placed(mesh, inputs):
    params = {k: jax.device_put(inputs[k], NamedSharding(mesh, P("pipe"))) for k in ("w", "b")}
    xs = jax.device_put(inputs["xs"], NamedSharding(mesh, P(None, "data")))
    tgts = jax.device_put(inputs["tgts"], NamedSharding(mesh, P(None, "data")))
    return params, xs, tgts


def test_four_ranks_pipeline_loss_and_grads_match_jax(tmp_path):
    inputs = _pp_inputs()
    mesh = _jax_mesh()
    params, xs, tgts = _jax_placed(mesh, inputs)

    def loss_fn(p):
        return pipeline_loss(p, xs, tgts, _stage_fn, lambda y, t: jnp.mean((y - t) ** 2),
                             mesh=mesh, data_spec=P("data"))

    with mesh:
        loss, grads = jax.value_and_grad(loss_fn)(params)
    loss, grads = float(loss), {k: np.asarray(v) for k, v in grads.items()}

    outs = run_ranks("pipeline_loss", 4, str(tmp_path), inputs=inputs)
    assert sorted((int(o["data"]), int(o["stage"])) for o in outs) == [(0, 0), (0, 1), (1, 0),
                                                                       (1, 1)]
    for o in outs:
        s = int(o["stage"])
        np.testing.assert_allclose(float(o["loss"]), loss, rtol=RTOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(o[f"grad_{k}"], grads[k][s:s + 1], rtol=RTOL,
                                       atol=RTOL * np.abs(grads[k]).max())


def test_four_ranks_pipeline_apply_matches_jax(tmp_path):
    inputs = _pp_inputs()
    mesh = _jax_mesh()
    params, xs, _ = _jax_placed(mesh, inputs)
    with mesh:
        want = np.asarray(pipeline_apply(params, xs, _stage_fn, mesh=mesh, data_spec=P("data")))

    outs = run_ranks("pipeline_apply", 4, str(tmp_path), inputs=inputs)
    half = MB // 2
    for o in outs:
        d = int(o["data"])
        if int(o["stage"]) == 1:  # the last stage holds the outputs
            np.testing.assert_allclose(o["out"], want[:, d * half:(d + 1) * half], rtol=RTOL,
                                       atol=RTOL)
        else:
            assert not o["out"].any()
