"""The multichip dry run over ranks (``accvlab_tpu_torch/dryrun_multichip.py``)
against the JAX package's unsharded steps on the same parameters.

One spawned run of 8 gloo ranks (``tests/torch_mesh_worker.py::case_dryrun``)
runs ``__graft_entry__.py``'s six stanzas at their widths and mesh shapes and
the FSDP step of ``tests/test_models_and_parallel.py:629``, each from JAX's
initial parameters (and JAX's batches where they come from ``jax.random``).
Each stanza's loss and the gradients (or, for FSDP, the updated parameters)
of its sharded leaves are held against ``jax.value_and_grad`` of the same
step unsharded:

* ``pp`` and ``pp_tp``: ``tests/test_models_and_parallel.py``'s 2e-5 on the
  loss and 2e-4 / 1e-6 on every gradient (``:551-555``, ``:622-626``);
* ``fsdp``: its 1e-4 on the loss against JAX's step; its 2e-3 / 1e-4 on
  every updated parameter (``:671-680``) against the port's own unsharded
  step, which is what that test holds the sharded step to (the same
  framework), the absolute bound raised to ``lr`` times one bf16 step
  (2^-7) of the leaf's largest gradient where that is larger: each rank's
  bf16 conv weight gradient is rounded before the sum over ``data`` (one
  element of 9,216 in ``ConvBlock_4`` moved 1.95e-4); against JAX's step,
  each leaf's update ``-lr * grad`` within the bf16 gradient bound below;
* ``moe``: ``tests/test_moe_topk.py``'s 2e-5 on the loss against the
  single-device step, and ``tests/test_torch_moe.py``'s bound on the expert,
  router and input-layer gradients;
* ``dp_tp``, ``petr`` and ``input_pipeline`` (bf16 backbones, the port's
  convolutions against XLA's): the loss within 2e-2 (``chip_smoke.TRAIN_TOL``),
  and each compared gradient within ``tests/test_torch_petr.py``'s bound on
  a train step's parameter gradients against ``jax.grad``: 0.3 of its norm
  (the port's own unsharded steps reach 0.12 on PETR's
  ``DecoderLayer_0/Dense_0`` and 0.10 of the largest magnitude on
  CenterNet's first conv). Both are also held to the same stanza on one
  rank, within 1e-2 of each gradient's largest magnitude (the bf16 products
  are summed per rank first).

The input pipeline stanza's delivered batches come back whole: JAX's two
Adam steps run on them, so its loss compares the steps alone.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

from accvlab_tpu.models.centernet import CenterNetDetector, centernet_loss
from accvlab_tpu.models.centernet import make_example_batch, make_train_step
from accvlab_tpu.models.moe import MoEClassifier, make_moe_example_batch
from accvlab_tpu.models.petr import PETRDetector, make_petr_example_batch, petr_loss
from accvlab_tpu_torch import dryrun_multichip as D
from torch_mesh_worker import run_ranks

PP_LOSS, PP_GRAD, PP_ATOL = 2e-5, 2e-4, 1e-6
FSDP_LOSS, FSDP_PARAMS, FSDP_ATOL, FSDP_LR = 1e-4, 2e-3, 1e-4, 1e-2
MOE_LOSS, MOE_GRAD = 2e-5, 2e-2
BF16_LOSS = 2e-2
BF16_GRAD_NORM = 0.3  # tests/test_torch_petr.py: |g - g_jax| / |g_jax|, Frobenius
ONE_RANK_GRAD = 1e-2


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _mse(y, t):
    return jnp.mean((y - t) ** 2)


def _sequential(stage, params, xs, tgts):
    def loss(p):
        total = 0.0
        for i in range(xs.shape[0]):
            x = xs[i]
            for s in range(jax.tree_util.tree_leaves(p)[0].shape[0]):
                x = stage(jax.tree_util.tree_map(lambda a: a[s], p), x)
            total = total + _mse(x, tgts[i])
        return total / xs.shape[0]

    return jax.value_and_grad(loss)(params)


def _pipe_loss(cnet, params, image, heat):
    heat_t = jnp.transpose(heat, (0, 2, 3, 1))
    o = cnet.apply(params, image)
    pred = jax.nn.sigmoid(o["heatmap"].astype(jnp.float32))
    pos = heat_t >= 0.999
    pos_l = jnp.where(pos, (1 - pred) ** 2 * -jnp.log(pred + 1e-6), 0.0)
    neg_l = jnp.where(~pos, (1 - heat_t) ** 4 * pred ** 2 * -jnp.log(1 - pred + 1e-6), 0.0)
    focal = (jnp.sum(pos_l) + jnp.sum(neg_l)) / jnp.maximum(jnp.sum(pos), 1.0)
    return focal + 0.01 * (jnp.mean(jnp.abs(o["offset"])) + jnp.mean(jnp.abs(o["size"])))


@pytest.fixture(scope="module")
def case():
    """JAX's parameters, batches and unsharded steps (``want``) for every
    stanza, in the order of ``__graft_entry__.py``."""
    inputs, want = {}, {}

    # 1. dp x tp CenterNet
    cnet = CenterNetDetector(num_classes=8, width=16)
    batch = make_example_batch(batch_size=4, hw=(32, 32), num_classes=8)
    params = _np(cnet.init(jax.random.PRNGKey(0), batch["images"]))
    inputs.update(D.flatten_inputs("dp_tp/params", params))
    loss, grads = jax.value_and_grad(
        lambda p: centernet_loss(cnet.apply(p, batch["images"]), batch["targets"])["loss"]
    )(params)
    want["dp_tp"] = (float(loss), _flat(_np(grads)["params"]))

    # 2. PETR on (data, seq, model)
    petr = PETRDetector(num_classes=6, dim=32, num_queries=16, num_layers=2)
    pb = make_petr_example_batch(batch_size=2, num_cams=4, hw=(16, 16), num_classes=6)
    params = _np(petr.init(jax.random.PRNGKey(0), pb["images"]))
    inputs.update(D.flatten_inputs("petr/params", params))
    loss, grads = jax.value_and_grad(lambda p: petr_loss(
        petr.apply(p, pb["images"]), pb["gt_boxes"], pb["gt_classes"], pb["matches_gt"],
        pb["matches_pred"])["loss"])(params)
    want["petr"] = (float(loss), _flat(_np(grads)["params"]))

    # 3. MoE on (data, expert)
    moe = MoEClassifier(num_experts=8, dim=32, num_classes=6)
    mb = make_moe_example_batch(batch_size=4, tokens=16, in_dim=24, num_classes=6)
    params = _np(moe.init(jax.random.PRNGKey(1), mb["tokens"]))
    inputs.update(D.flatten_inputs("moe/params", params))
    inputs.update(D.flatten_inputs("moe/batch", _np(mb)))

    def moe_loss(p):
        logits, aux = moe.apply(p, mb["tokens"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, mb["labels"]).mean() + 0.01 * aux

    loss, grads = jax.value_and_grad(moe_loss)(params)
    want["moe"] = (float(loss), _flat(_np(grads)["params"]))

    # 4. pipeline parallel, 5. dp x pp x tp
    kw, kb, kx = jax.random.split(jax.random.PRNGKey(2), 3)
    pp = {"w": jax.random.normal(kw, (4, 32, 32)) * 0.2,
          "b": jax.random.normal(kb, (4, 32)) * 0.05}
    xs = jax.random.normal(kx, (6, 4, 32))
    tgts = jax.random.normal(jax.random.PRNGKey(3), xs.shape)
    inputs.update(D.flatten_inputs("pp", _np({**pp, "xs": xs, "tgts": tgts})))
    loss, grads = _sequential(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), pp, xs, tgts)
    want["pp"] = (float(loss), _np(grads))
    k1, k2, kx = jax.random.split(jax.random.PRNGKey(4), 3)
    pt = {"w1": jax.random.normal(k1, (2, 16, 32)) * 0.2, "b1": jnp.zeros((2, 32)),
          "w2": jax.random.normal(k2, (2, 32, 16)) * 0.2, "b2": jnp.zeros((2, 16))}
    xs = jax.random.normal(kx, (6, 4, 16))
    tgts = jax.random.normal(jax.random.PRNGKey(5), xs.shape)
    inputs.update(D.flatten_inputs("pp_tp", _np({**pt, "xs": xs, "tgts": tgts})))
    loss, grads = _sequential(
        lambda p, x: jnp.tanh(jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]),
        pt, xs, tgts)
    want["pp_tp"] = (float(loss), _np(grads))

    # 6. the input pipeline's CenterNet (its steps run on the delivered batches)
    pipe_net = CenterNetDetector(num_classes=4, width=16)
    params = _np(pipe_net.init(jax.random.PRNGKey(0), np.zeros((1, 64, 96, 3), np.float32)))
    inputs.update(D.flatten_inputs("input_pipeline/params", params))
    want["input_pipeline"] = (pipe_net, params)

    # 7. FSDP: one SGD step
    fnet = CenterNetDetector(num_classes=4, width=16)
    fb = make_example_batch(batch_size=8, hw=(32, 48), num_classes=4)
    init_fn, step = make_train_step(fnet, optimizer=optax.sgd(1e-2))
    params, opt_state = init_fn(jax.random.PRNGKey(0), fb["images"])
    inputs.update(D.flatten_inputs("fsdp/params", _np(params)))
    p0, _, m0 = jax.jit(step)(params, opt_state, fb)
    want["fsdp"] = (float(m0["loss"]), _flat(_np(p0)["params"]), _flat(_np(params)["params"]),
                    _port_sgd_step(_np(params), fb))

    # the bf16 models' stanzas on one rank (a mesh of ones), the same inputs
    import torch.distributed as dist

    try:
        one = D.run_stanzas("cpu", inputs, stanzas=("dp_tp", "petr"))
    finally:
        dist.destroy_process_group()
    return inputs, want, one


def _bf16_close(got, ref, name):
    err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert err < BF16_GRAD_NORM, (name, err)


def _port_sgd_step(params, batch):
    """The port's unsharded SGD step (lr 1e-2) from JAX's parameters on the
    same batch: the updated parameters in flax's layout."""
    import torch

    from accvlab_tpu_torch.models import centernet as tcn
    from accvlab_tpu_torch.models.params import jax_params_of, load_jax_params

    model = load_jax_params(tcn.CenterNetDetector(num_classes=4, width=16), params)
    _, step = tcn.make_train_step(model)
    tb = tcn.make_example_batch(batch_size=8, hw=(32, 48), num_classes=4, device="cpu")
    np.testing.assert_array_equal(tb["images"].numpy(), np.asarray(batch["images"]))
    step(model, torch.optim.SGD(model.parameters(), lr=1e-2), tb)
    return _flat(jax_params_of(model)["params"])


def _one_rank_close(got, ref, name):
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= ONE_RANK_GRAD, (name, err)


def test_eight_ranks_dryrun_stanzas_match_jax_unsharded(case, tmp_path):
    inputs, want, one = case
    outs = run_ranks("dryrun", 8, str(tmp_path), timeout=300.0, inputs=inputs)

    def got(o, prefix):
        return {k[len(prefix) + 1:]: v for k, v in o.items() if k.startswith(prefix + "/")}

    for o in outs:
        # dp x tp: the head kernels and biases hold 1/2 of their channels
        loss, grads = want["dp_tp"]
        np.testing.assert_allclose(float(o["dp_tp/loss"]), loss, rtol=BF16_LOSS)
        g = got(o, "dp_tp/grads")
        assert sorted(g) == sorted(k for k in grads if k.startswith("head_"))
        for k, v in g.items():
            _bf16_close(v, grads[k], k)
            _one_rank_close(v, one["dp_tp"]["grads"][k], k)
        assert o["dp_tp/local_shapes/head_heatmap"].tolist() == [4, 32, 1, 1]

        loss, grads = want["petr"]
        np.testing.assert_allclose(float(o["petr/loss"]), loss, rtol=BF16_LOSS)
        g = got(o, "petr/grads")
        assert sorted(g) == ["DecoderLayer_0/Dense_0/kernel", "DecoderLayer_0/Dense_1/kernel",
                             "DecoderLayer_1/Dense_0/kernel", "DecoderLayer_1/Dense_1/kernel",
                             "Dense_0/kernel", "head_classes/kernel"]
        for k, v in g.items():
            _bf16_close(v, grads[k], k)
            _one_rank_close(v, one["petr"]["grads"][k], k)
        assert o["petr/local_shapes/images"].tolist() == [1, 2, 16, 16, 3]
        assert o["petr/local_shapes/head_classes/kernel"].tolist() == [32, 3]

        loss, grads = want["moe"]
        np.testing.assert_allclose(float(o["moe/loss"]), loss, rtol=MOE_LOSS)
        for k, v in got(o, "moe/grads").items():
            assert np.abs(v - grads[k]).max() <= MOE_GRAD * np.abs(grads[k]).max(), k
        assert o["moe/local_shapes/w_in"].tolist() == [2, 32, 64]

        for name in ("pp", "pp_tp"):
            loss, grads = want[name]
            np.testing.assert_allclose(float(o[f"{name}/loss"]), loss, rtol=PP_LOSS)
            g = got(o, f"{name}/grads")
            assert sorted(g) == sorted(grads)
            for k, v in g.items():
                np.testing.assert_allclose(v, grads[k], rtol=PP_GRAD, atol=PP_ATOL,
                                           err_msg=f"{name} {k}")
        assert o["pp/local_shapes/w"].tolist() == [1, 32, 32]
        assert o["pp_tp/local_shapes/w1"].tolist() == [1, 16, 16]

        loss, params, before, port = want["fsdp"]
        np.testing.assert_allclose(float(o["fsdp/loss"]), loss, rtol=FSDP_LOSS)
        p = got(o, "fsdp/params")
        assert sorted(p) == sorted(params)
        for k, v in p.items():
            grad_max = np.abs(before[k] - port[k]).max() / FSDP_LR
            atol = max(FSDP_ATOL, FSDP_LR * 2.0 ** -7 * grad_max)
            np.testing.assert_allclose(v, port[k], rtol=FSDP_PARAMS, atol=atol, err_msg=k)
            _bf16_close(v - before[k], params[k] - before[k], k)
        assert any(k.startswith("fsdp/local_shapes/") for k in o)

    # the input pipeline: JAX's two Adam steps on the delivered batches
    net, params = want["input_pipeline"]
    opt = optax.adam(1e-3)
    state = opt.init(params)
    b = got(outs[0], "input_pipeline/batches")
    losses = []
    for i in range(2):
        loss, grads = jax.value_and_grad(lambda p: _pipe_loss(net, p, b[f"{i}/image"],
                                                              b[f"{i}/heatmap"]))(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    for o in outs:
        np.testing.assert_allclose(o["input_pipeline/losses"], losses, rtol=BF16_LOSS)
        np.testing.assert_array_equal(got(o, "input_pipeline/batches")["1/image"], b["1/image"])
        assert o["input_pipeline/local_shapes/image"].tolist() == [2, 64, 96, 3]


def test_mesh_shapes_follow_jax_rules():
    shapes = D.mesh_shapes(8)
    assert shapes["dp_tp"] == ((4, 2), ("data", "model"))
    assert shapes["petr"] == ((2, 2, 2), ("data", "seq", "model"))
    assert shapes["moe"] == ((2, 4), ("data", "expert"))
    assert shapes["pp"] == ((2, 4), ("data", "pipe"))
    assert shapes["pp_tp"] == ((2, 2, 2), ("data", "pipe", "model"))
    assert shapes["fsdp"] == ((8, 1), ("data", "model"))
    assert D.mesh_shapes(16)["pp_tp"] == ((4, 2, 2), ("data", "pipe", "model"))
    assert all(all(s == 1 for s in shape) for shape, _ in D.mesh_shapes(1).values())
    assert D.sizes(1) == D.sizes(8)
    with pytest.raises(ValueError, match="multiple of 8"):
        D.mesh_shapes(4)


def test_dryrun_raises_without_enough_cards():
    import torch

    if torch.cuda.device_count() >= 8:
        pytest.skip("8 cards are present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.dryrun_multichip(8)
