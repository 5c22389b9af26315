"""The port's MoE (``accvlab_tpu_torch/models/moe.py``) against the JAX
package's on one process on the CPU.

The port takes JAX's parameters (``load_jax_params``) and JAX's batch
(``jax.random`` values cannot be drawn in torch). Its forward and aux are held
to ``tests/test_moe_topk.py``'s tolerance (2e-2), its loss and every gradient
leaf to ``jax.value_and_grad``'s within the bounds below, for top-1, top-2 and
top-E routing. The five cases of ``tests/test_moe_topk.py`` have counterparts
here (the expert-parallel one on a one-rank mesh; several ranks run in
``tests/test_torch_multirank_serving.py``), and ``make_moe_shardings`` gives
JAX's specs as placements.
"""

import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from accvlab_tpu.models import moe as J
from accvlab_tpu_torch.models import moe as T
from accvlab_tpu_torch.models.params import _leaves, jax_params_of, load_jax_params
from accvlab_tpu_torch.parallel import make_mesh_nd, shard_batch

#: tests/test_moe_topk.py's tolerance for the forward and the aux
FORWARD_TOL = 2e-2
#: the loss against jax.value_and_grad's, relative (measured 2e-6 on the CPU)
LOSS_RTOL = 1e-4
#: each gradient leaf against jax.grad's, relative to the leaf's largest
#: magnitude: the expert einsums run in bfloat16 (measured at most 6.3e-3)
GRAD_RTOL = 2e-2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _jax_case(k, experts=8, dim=16):
    model = J.MoEClassifier(num_experts=experts, dim=dim, num_classes=5, num_selected=k)
    batch = J.make_moe_example_batch(batch_size=4, tokens=8, in_dim=12, num_classes=5)
    init_fn, _ = J.make_moe_train_step(model)
    params = init_fn(jax.random.PRNGKey(0), batch["tokens"])
    return model, params, batch


def _torch_batch(batch):
    return {"tokens": torch.from_numpy(np.array(batch["tokens"])),
            "labels": torch.from_numpy(np.array(batch["labels"]))}


def _port(params, k, experts=8, dim=16):
    model = T.MoEClassifier(experts, dim, 5, k)
    return load_jax_params(model, _numpy_tree(params))


@pytest.mark.parametrize("k", [1, 2, 8])
def test_forward_and_aux_match_jax(k):
    jmodel, params, batch = _jax_case(k)
    want_logits, want_aux = jmodel.apply(params, batch["tokens"])
    logits, aux = _port(params, k)(_torch_batch(batch)["tokens"])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               rtol=FORWARD_TOL, atol=FORWARD_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=FORWARD_TOL)


@pytest.mark.parametrize("k", [1, 2, 8])
def test_loss_and_every_gradient_match_value_and_grad(k):
    jmodel, params, batch = _jax_case(k)

    def loss_fn(p):
        logits, aux = jmodel.apply(p, batch["tokens"])
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, batch["labels"]).mean()
        return ce + 0.01 * aux

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    model = _port(params, k)
    tb = _torch_batch(batch)
    logits, aux = model(tb["tokens"])
    loss = F.cross_entropy(logits, tb["labels"].long()) + 0.01 * aux
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    flat = {tuple(str(getattr(q, "key", q)) for q in path)[1:]: np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(want_grads)[0]}
    leaves = _leaves(model)
    assert set(leaves) == set(flat)
    for path, (param, (_, to_flax)) in leaves.items():
        got, want = to_flax(param.grad.numpy()), flat[path]
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= GRAD_RTOL, ("/".join(path), err)


def test_train_step_matches_jax_sgd_step():
    """make_moe_train_step's SGD step at lr 5e-2: the loss and the updated
    parameters against JAX's step."""
    jmodel, params, batch = _jax_case(2)
    _, jstep = J.make_moe_train_step(jmodel)
    jparams, jmetrics = jstep(params, batch, 5e-2)
    model = _port(params, 2)
    _, step = T.make_moe_train_step(model)
    model, metrics = step(model, _torch_batch(batch), 5e-2)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=LOSS_RTOL)
    got, want = jax_params_of(model)["params"], _numpy_tree(jparams)["params"]
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for q in path:
            g = g[str(getattr(q, "key", q))]
        # the update is lr * grad: the gradient's bound, scaled by lr
        assert np.abs(g - w).max() <= 5e-2 * GRAD_RTOL * max(np.abs(w).max(), 1.0)


def _switch_oracle(switch, x, k):
    """tests/test_moe_topk.py's per-token loop on the port's parameters."""
    rw = switch.router.weight.detach().numpy().T
    rb = switch.router.bias.detach().numpy()
    w_in, w_out = switch.w_in.detach().numpy(), switch.w_out.detach().numpy()
    b, t, d = x.shape
    out = np.zeros((b, t, d), np.float32)
    for i in range(b):
        for j in range(t):
            tok = x[i, j]
            logits = tok @ rw + rb
            probs = np.exp(logits - logits.max())
            probs = probs / probs.sum()
            top = np.argsort(-probs, kind="stable")[:k]
            gates = probs[top]
            g = gates if k == 1 else gates / (gates.sum() + 1e-9)
            acc = np.zeros(d, np.float32)
            for gi, e in zip(g, top):
                h = torch.from_numpy((tok @ w_in[e]).astype(np.float32)).to(torch.bfloat16)
                h = F.gelu(h, approximate="tanh").float().numpy()
                acc += gi * (h @ w_out[e])
            out[i, j] = acc
    return out


def _switch(k, e=4, d=6, h=8, seed=0):
    switch = T.SwitchFFN(num_experts=e, dim=d, hidden=h, num_selected=k)
    T.init_params(switch, torch.Generator().manual_seed(seed))
    return switch.requires_grad_(False)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_topk_matches_per_token_oracle(k):
    switch = _switch(k)
    x = np.random.default_rng(3).standard_normal((2, 5, 6)).astype(np.float32)
    out, aux = switch(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), _switch_oracle(switch, x, k), rtol=2e-2, atol=2e-2)
    assert np.isfinite(float(aux)) and float(aux) > 0.0


def test_top1_unchanged_vs_topk_path():
    """num_selected=1 is the original Switch formulation bit for bit."""
    switch = _switch(1)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 7, 6)).astype(np.float32))
    got, _ = switch(x)
    probs = torch.softmax(x @ switch.router.weight.t() + switch.router.bias, dim=-1)
    mask = F.one_hot(torch.argmax(probs, dim=-1), 4).to(x.dtype)
    gate = (probs * mask).sum(dim=-1, keepdim=True)
    hdn = F.gelu(torch.einsum("btd,edh->beth", x.to(torch.bfloat16),
                              switch.w_in.to(torch.bfloat16)), approximate="tanh")
    y = torch.einsum("beth,ehd->betd", hdn, switch.w_out.to(torch.bfloat16))
    want = torch.einsum("bte,betd->btd", mask * gate, y.float())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


def test_full_selection_equals_probability_mixture():
    switch = _switch(4)
    x = np.random.default_rng(9).standard_normal((1, 4, 6)).astype(np.float32)
    out, _ = switch(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), _switch_oracle(switch, x, 4), rtol=2e-2, atol=2e-2)


def test_ties_go_to_the_lower_expert():
    """Equal router probabilities (a zero router) pick experts 0..k-1, as
    lax.top_k does."""
    switch = _switch(2)
    with torch.no_grad():
        switch.router.weight.zero_()
    jswitch = J.SwitchFFN(num_experts=4, dim=6, hidden=8, num_selected=2)
    x = np.random.default_rng(1).standard_normal((1, 3, 6)).astype(np.float32)
    params = jax_params_of(switch)
    want, _ = jswitch.apply(params, jnp.asarray(x))
    got, _ = switch(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FORWARD_TOL, atol=FORWARD_TOL)


def test_num_selected_out_of_range_raises():
    with pytest.raises(ValueError, match="num_selected"):
        T.SwitchFFN(4, 6, 8, num_selected=5)


@pytest.fixture
def one_rank_mesh():
    yield make_mesh_nd((1, 1), ("data", "expert"), device_type="cpu")
    dist.destroy_process_group()


def test_top2_expert_parallel_matches_single_device(one_rank_mesh):
    """The expert-parallel step on a (data 1, expert 1) mesh: every weight a
    DTensor, the batch Shard(0) over data; its loss and update are the plain
    step's bit for bit."""
    mesh = one_rank_mesh
    _, params, batch = _jax_case(2)
    plain = _port(params, 2)
    sharded = _port(params, 2)
    tb = _torch_batch(batch)
    params_sh, batch_sh = T.make_moe_shardings(mesh, sharded, tb)
    T.shard_moe_params(sharded, mesh, params_sh)
    assert isinstance(sharded.switch.w_in, DTensor)
    assert batch_sh == {"tokens": (Shard(0), Replicate()), "labels": (Shard(0), Replicate())}
    _, step = T.make_moe_train_step(plain)
    _, want = step(plain, tb, 5e-2)
    _, got = step(sharded, shard_batch(tb, mesh), 5e-2)
    assert torch.equal(got["loss"], want["loss"])
    for (name, p), q in zip(sharded.named_parameters(), plain.parameters()):
        assert torch.equal(p.to_local(), q.detach()), name


def test_make_moe_shardings_matches_jax_specs():
    """The expert weights P("expert", None, None), every other parameter P(),
    batch leaves P("data", ...): as placements over (data, expert)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    jmodel, params, batch = _jax_case(1)
    jmesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "expert"))
    jparams_sh, jbatch_sh = J.make_moe_shardings(jmesh, params, batch)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        from torch.distributed.device_mesh import DeviceMesh

        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "expert"))
        model = _port(params, 1)
        params_sh, batch_sh = T.make_moe_shardings(mesh, model, _torch_batch(batch))
    finally:
        dist.destroy_process_group()

    def placements(spec, ndim):
        entries = tuple(spec) + (None,) * (ndim - len(spec))
        return tuple(Shard(entries.index(a)) if a in entries else Replicate()
                     for a in ("data", "expert"))

    jflat = {tuple(str(getattr(q, "key", q)) for q in path)[1:]: s
             for path, s in jax.tree_util.tree_flatten_with_path(jparams_sh)[0]}
    names = {id(p): n for n, p in model.named_parameters()}
    for path, (param, _) in _leaves(model).items():
        assert params_sh[names[id(param)]] == placements(jflat[path].spec, param.ndim), path
    for key in ("tokens", "labels"):
        assert batch_sh[key] == placements(jbatch_sh[key].spec, np.ndim(batch[key])), key


def test_top2_overfits():
    """tests/test_moe_topk.py::test_top2_overfits: 250 SGD steps at lr 5e-2
    bring the loss below 0.3 of the first."""
    model = T.MoEClassifier(num_experts=4, dim=32, num_classes=4, num_selected=2)
    batch = T.make_moe_example_batch(8, 8, 12, 4, device="cpu")
    init_fn, step = T.make_moe_train_step(model)
    model = init_fn(2, batch["tokens"])
    first = None
    for _ in range(250):
        model, metrics = step(model, batch, 5e-2)
        if first is None:
            first = float(metrics["loss"])
    assert float(metrics["loss"]) < 0.3 * first, (first, float(metrics["loss"]))


def test_example_batch_is_seeded_and_on_the_asked_device():
    a = T.make_moe_example_batch(8, 16, 12, 5, device="cpu")
    b = T.make_moe_example_batch(8, 16, 12, 5, device="cpu")
    assert a["tokens"].shape == (8, 16, 12) and a["labels"].shape == (8,)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert int(a["labels"].min()) >= 0 and int(a["labels"].max()) < 5
