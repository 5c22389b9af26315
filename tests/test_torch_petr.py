"""Parity of ``accvlab_tpu_torch.models.petr`` with ``accvlab_tpu.models.petr``.

A narrow PETR (8 queries, 4 memory slots, dim 16, 2 layers; the backbone's
width is fixed at 64 in both packages) gets the JAX package's flax
parameters through ``load_jax_params``, so both packages run the same
weights on the same numpy inputs, made from a seed.

Tolerances, and why:

* float32 functions on the same inputs (``compensate_ref_points``, the
  propagation and its top-k, ``decode_detections_3d``, ``petr_loss`` and its
  input gradients): within 1e-6 relative, or of the largest magnitude; the
  top-k indices, classes and counts equal (ties go to the lower index in
  both);
* the model (bf16 convs, attention and MLPs, float32 elsewhere): one bf16
  rounding is 2^-8 of a value and the two frameworks round some
  intermediates at other places, so outputs agree within 3e-2 of each
  output's largest magnitude;
* one train step's parameter gradients against ``jax.grad`` of the same
  loss, leaf by leaf: ``|g - g_jax| / |g_jax|`` (Frobenius norms) within
  0.3. Measured: at most 0.16 under this suite's XLA flags, which round
  bf16 intermediates at other places than XLA's default level (4.4e-2
  there); a zeroed leaf gives 1, a flipped one 2. The attention's key
  biases are the exception: the
  softmax ignores a shift shared by all keys, so their exact gradient is
  zero and both packages give rounding noise, held below 1e-3 of the
  largest leaf's norm;
* the AdamW update after it: its first step is about ±lr per parameter, so
  a gradient that the bf16 noise moves across zero moves a parameter by up
  to 2·lr; every parameter is within 2·lr of JAX's, and within each leaf
  but the key biases the median within 1e-6; the metrics within 2e-2
  relative;
* the propagated memory after a step: compared on the queries both
  packages choose, within 3e-2 of the largest magnitude; a query chosen by
  one package only must score within 1e-2 of the other's cut;
* AdamW against ``optax.adamw`` on identical gradients: 1e-7 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accvlab_tpu.models import petr as J
from accvlab_tpu_torch.models import petr as T
from accvlab_tpu_torch.models.params import _flatten, _leaves, jax_params_of, load_jax_params

KW = dict(num_queries=8, num_classes=5, dim=16, num_layers=2)
MODES = {  # name: extra constructor arguments
    "plain": {},
    "streaming": dict(num_memory=4),
    "motion": dict(num_memory=4, motion_aware=True),
    "remat": dict(num_memory=4, motion_aware=True, remat=True),
}
B, CAMS, HW, MEM = 2, 2, (32, 48), 4
LR = 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (B, CAMS, *HW, 3)).astype(np.float32)
    memory = (rng.normal(size=(B, MEM, 16)) * 0.5).astype(np.float32)
    memory_ref = rng.normal(size=(B, MEM, 3)).astype(np.float32)
    ego = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    ego[:, 0, 3] = 0.5
    ego[:, :3, :3] = np.array([[0.8, -0.6, 0], [0.6, 0.8, 0], [0, 0, 1]], np.float32)
    return images, memory, memory_ref, ego


def call_args(mode, arrays, wrap):
    images, memory, memory_ref, ego = (wrap(a) for a in arrays)
    if mode == "plain":
        return (images,)
    if mode == "streaming":
        return (images, memory)
    return (images, memory, memory_ref, ego)


@pytest.fixture(scope="module")
def jax_models():
    out = {}
    for mode, extra in MODES.items():
        model = J.PETRDetector(**KW, **extra)
        args = call_args(mode, inputs(), jnp.asarray)
        params = jax.jit(model.init)(jax.random.PRNGKey(3), *args)
        out[mode] = (model, params)
    return out


def port_model(mode, params):
    return load_jax_params(T.PETRDetector(**KW, **MODES[mode]), np_tree(params))


def rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_close_f32(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


# --------------------------------------------------------------------- #
# Parameters                                                            #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mode", sorted(MODES))
def test_load_jax_params_round_trips_every_leaf(jax_models, mode):
    want = np_tree(jax_models[mode][1])
    back = jax_params_of(port_model(mode, jax_models[mode][1]))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_w) == len(flat_b)
    for path, leaf in flat_w:
        assert flat_b[path].shape == leaf.shape and flat_b[path].dtype == leaf.dtype
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_remat_keeps_the_parameter_tree(jax_models):
    a = jax.tree_util.tree_structure(jax_models["motion"][1])
    assert a == jax.tree_util.tree_structure(jax_models["remat"][1])
    t = jax_params_of(T.PETRDetector(**KW, **MODES["remat"]))
    assert jax.tree_util.tree_structure(t) == a


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "flat_qkv", "no_params_key"])
def test_load_jax_params_raises_on_a_mismatch(jax_models, fault):
    tree = np_tree(jax_models["motion"][1])
    inner = tree["params"]
    attn = inner["DecoderLayer_1"]["MultiHeadDotProductAttention_0"]
    if fault == "missing":
        del inner["memory_proj"]["bias"]
    elif fault == "extra":
        inner["DecoderLayer_2"] = {"Dense_0": {"bias": np.zeros(16, np.float32)}}
    elif fault == "shape":
        inner["head_boxes"]["kernel"] = np.zeros((16, 6), np.float32)
    elif fault == "flat_qkv":  # the right number of values in the wrong layout
        attn["query"]["kernel"] = attn["query"]["kernel"].reshape(16, 16)
    else:
        tree = inner
    model = T.PETRDetector(**KW, **MODES["motion"])
    before = [p.clone() for p in model.parameters()]
    with pytest.raises(ValueError):
        load_jax_params(model, tree)
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))


def test_init_follows_flax_initialisers():
    model = T.init_params(T.PETRDetector(num_memory=64, motion_aware=True),
                          torch.Generator().manual_seed(0))
    w = model.layers[0].mlp0.weight.detach()  # Dense(128 -> 512): fan-in 128
    assert abs(float(w.std()) / (1 / 128) ** 0.5 - 1.0) < 0.03
    assert abs(float(model.queries.detach().std()) / 0.02 - 1.0) < 0.05
    assert abs(float(model.ref_anchors.detach().std()) - 1.0) < 0.15
    assert float(model.head_boxes.bias.detach().abs().max()) == 0.0
    assert float(model.layers[1].norm0.weight.detach().min()) == 1.0
    again = T.init_params(T.PETRDetector(num_memory=64, motion_aware=True),
                          torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


# --------------------------------------------------------------------- #
# Forward                                                               #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mode", sorted(MODES))
def test_forward_matches_jax(jax_models, mode):
    model, params = jax_models[mode]
    want = jax.jit(model.apply)(params, *call_args(mode, inputs(1), jnp.asarray))
    got = port_model(mode, params)(*call_args(mode, inputs(1), torch.from_numpy))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == torch.float32, k
        assert rel_to_max(got[k].detach(), want[k]) < 3e-2, k


def test_remat_gives_the_same_forward_and_gradients(jax_models):
    params = jax_models["motion"][1]
    res = []
    for mode in ("motion", "remat"):
        model = port_model(mode, params)
        out = model(*call_args(mode, inputs(2), torch.from_numpy))
        out["boxes3d"].square().sum().backward()
        res.append((out["boxes3d"].detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(res[0][0], res[1][0])
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(res[0][1], res[1][1]))


def test_memory_defaults_to_zeros(jax_models):
    model = port_model("motion", jax_models["motion"][1])
    images = torch.from_numpy(inputs()[0])
    a = model(images)
    b = model(images, torch.zeros(B, MEM, 16), torch.zeros(B, MEM, 3))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["ref_points"][:, KW["num_queries"]:], torch.zeros(B, MEM, 3))
    with pytest.raises(ValueError, match="motion_aware needs num_memory"):
        T.PETRDetector(motion_aware=True)


# --------------------------------------------------------------------- #
# Float32 functions on the same inputs                                  #
# --------------------------------------------------------------------- #


def head_outputs(seed, q=12, c=5, dim=16, ties=False):
    rng = np.random.default_rng(seed)
    out = {"boxes3d": rng.normal(size=(B, q, 7)).astype(np.float32) * 3,
           "logits": rng.normal(size=(B, q, c)).astype(np.float32) * 2,
           "existence": rng.normal(size=(B, q)).astype(np.float32) * 2,
           "queries": rng.normal(size=(B, q, dim)).astype(np.float32)}
    if ties:  # equal scores: lax.top_k takes the lower index first
        out["existence"][:, ::2] = 0.0
        out["logits"][:, 3:6] = out["logits"][:, 2:3]
    return out


def both_outputs(out):
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v.copy()) for k, v in out.items()})


def test_compensate_ref_points_matches_jax():
    _, _, ref, ego = inputs(4)
    want = J.compensate_ref_points(jnp.asarray(ref), jnp.asarray(ego))
    assert_close_f32(T.compensate_ref_points(torch.from_numpy(ref), torch.from_numpy(ego)), want)
    assert T.compensate_ref_points(torch.from_numpy(ref), None) is not None


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 4, 12])
def test_propagation_matches_jax(ties, k):
    oj, ot = both_outputs(head_outputs(5, ties=ties))
    fj, ij, sj = J._select_topk_queries(oj, k)
    ft, it, st = T._select_topk_queries(ot, k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert_close_f32(st, sj)
    assert_close_f32(ft, fj)
    assert_close_f32(T.propagate_queries(ot, k), J.propagate_queries(oj, k))
    for got, want in zip(T.propagate_queries_with_motion(ot, k),
                         J.propagate_queries_with_motion(oj, k)):
        assert_close_f32(got, want)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("max_det,thr", [(64, 0.3), (5, 0.05), (12, 0.0)])
def test_decode_detections_3d_matches_jax(ties, max_det, thr):
    oj, ot = both_outputs(head_outputs(6, ties=ties))
    want = J.decode_detections_3d(oj, max_det, thr)
    got = T.decode_detections_3d(ot, max_det, thr)
    np.testing.assert_array_equal(got["scores"].sample_sizes.numpy(),
                                  np.asarray(want["scores"].sample_sizes))
    for k in ("boxes3d", "scores", "classes"):
        assert tuple(got[k].tensor.shape) == want[k].tensor.shape
        if k == "classes":
            assert got[k].tensor.dtype == torch.int32
            np.testing.assert_array_equal(got[k].tensor.numpy(), np.asarray(want[k].tensor))
        else:
            assert_close_f32(got[k].tensor, want[k].tensor)


def example_batches(seed=0, num_queries=12):
    kw = dict(batch_size=B, num_cams=CAMS, hw=HW, max_gt=6, num_classes=5, seed=seed,
              num_queries=num_queries)
    return J.make_petr_example_batch(**kw), T.make_petr_example_batch(device="cpu", **kw)


def test_example_batch_is_the_same_data():
    jb, tb = example_batches(4)
    np.testing.assert_array_equal(tb["images"].numpy(), np.asarray(jb["images"]))
    for k in ("gt_boxes", "gt_classes", "matches_gt", "matches_pred"):
        np.testing.assert_array_equal(tb[k].tensor.numpy(), np.asarray(jb[k].tensor))
        np.testing.assert_array_equal(tb[k].sample_sizes.numpy(), np.asarray(jb[k].sample_sizes))


def test_petr_loss_and_input_gradients_match_jax():
    jb, tb = example_batches(7)
    out = head_outputs(8)
    del out["queries"]

    def loss_j(o):
        return J.petr_loss(o, jb["gt_boxes"], jb["gt_classes"], jb["matches_gt"],
                           jb["matches_pred"])

    want, grads = jax.value_and_grad(lambda o: loss_j(o)["loss"])(
        {k: jnp.asarray(v) for k, v in out.items()})
    terms = loss_j({k: jnp.asarray(v) for k, v in out.items()})
    ot = {k: torch.from_numpy(v).requires_grad_(True) for k, v in out.items()}
    got = T.petr_loss(ot, tb["gt_boxes"], tb["gt_classes"], tb["matches_gt"], tb["matches_pred"])
    got["loss"].backward()
    assert set(got) == set(terms)
    for k in terms:
        np.testing.assert_allclose(float(got[k]), float(terms[k]), rtol=1e-6)
    for k in out:
        assert_close_f32(ot[k].grad, grads[k])


# --------------------------------------------------------------------- #
# Training                                                              #
# --------------------------------------------------------------------- #


def memory_agreement(t_out, j_out, t_mem, j_mem, k):
    """Compare two propagated memories on the queries both packages chose
    (see the module docstring); ``*_out`` are the step's forward outputs."""
    def as_np(x):
        return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def chosen(existence):
        s = 1.0 / (1.0 + np.exp(-as_np(existence).astype(np.float64)))
        return np.argsort(-s, axis=1, kind="stable")[:, :k], s

    (it, st), (ij, sj) = chosen(t_out["existence"]), chosen(j_out["existence"])
    for s in range(it.shape[0]):
        pos_t = {int(q): n for n, q in enumerate(it[s])}
        pos_j = {int(q): n for n, q in enumerate(ij[s])}
        for q in set(pos_t) ^ set(pos_j):
            cut = min(st[s, it[s, -1]], sj[s, ij[s, -1]])
            assert max(st[s, q], sj[s, q]) >= cut - 1e-2
        common = sorted(set(pos_t) & set(pos_j))
        for mt, mj in zip(t_mem, j_mem):
            got = as_np(mt)[s, [pos_t[q] for q in common]]
            want = as_np(mj)[s, [pos_j[q] for q in common]]
            assert rel_to_max(got, want) < 3e-2


def jax_param_grads(model_j, params, batch, args):
    """``jax.grad`` of the train step's loss at ``params``, by flax path."""
    def loss(p, b, a):
        return J._batch_loss(model_j.apply(p, *a), b)["loss"]

    return _flatten(np_tree(jax.jit(jax.grad(loss))(params, batch, args))["params"])


def assert_step_matches(model, grads_j, params2):
    """The port's gradients (``p.grad`` after the step) and updated
    parameters against JAX's, leaf by leaf (see the module docstring)."""
    grads_t = {path: to_flax(param.grad.numpy())
               for path, (param, (_, to_flax)) in _leaves(model).items()}
    assert set(grads_t) == set(grads_j)
    largest = max(np.linalg.norm(g) for g in grads_j.values())
    want_p = _flatten(np_tree(params2)["params"])
    got_p = _flatten(jax_params_of(model)["params"])
    for path, gj in grads_j.items():
        gt, name = grads_t[path], "/".join(path)
        diff = np.abs(got_p[path] - want_p[path])
        assert diff.max() <= 2 * LR * (1 + 1e-2), name
        if path[-2:] == ("key", "bias"):
            assert max(np.linalg.norm(gt), np.linalg.norm(gj)) < 1e-3 * largest, name
            continue
        assert np.linalg.norm(gt - gj) / np.linalg.norm(gj) < 0.3, name
        assert np.median(diff) < 1e-6, name


@pytest.mark.parametrize("mode", ["plain", "streaming", "motion", "remat"])
def test_one_train_step_matches_jax(jax_models, mode):
    model_j, params = jax_models[mode]
    slots = KW["num_queries"] + (MEM if mode != "plain" else 0)
    jb, tb = example_batches(9, num_queries=slots)
    _, memory, memory_ref, ego = inputs(3)
    tm = T.PETRDetector(**KW, **MODES[mode])
    opt = optax.adamw(LR)
    if mode == "plain":
        args_j = (jb["images"],)
        _, step_j = J.make_petr_train_step(model_j)
        params2, _, metrics_j = jax.jit(step_j)(params, opt.init(params), jb)
        init_t, step_t = T.make_petr_train_step(tm)
        model, adamw = init_t(0, tb["images"])
        load_jax_params(model, np_tree(params))
        _, _, metrics_t = step_t(model, adamw, tb)
    elif mode == "streaming":
        args_j = (jb["images"], jnp.asarray(memory))
        _, step_j = J.make_streaming_petr_train_step(model_j)
        out_j = model_j.apply(params, *args_j)
        params2, _, mem_j, metrics_j = jax.jit(step_j)(params, opt.init(params), jb,
                                                       jnp.asarray(memory))
        init_t, step_t = T.make_streaming_petr_train_step(tm)
        model, adamw, mem0 = init_t(0, tb["images"])
        assert tuple(mem0.shape) == (B, MEM, 16) and float(mem0.abs().sum()) == 0.0
        load_jax_params(model, np_tree(params))
        out_t = model(tb["images"], torch.from_numpy(memory))
        _, _, mem_t, metrics_t = step_t(model, adamw, tb, torch.from_numpy(memory))
        assert not mem_t.requires_grad
        memory_agreement(out_t, out_j, [mem_t], [mem_j], MEM)
    else:
        jb = dict(jb, ego_transform=jnp.asarray(ego))
        tb = dict(tb, ego_transform=torch.from_numpy(ego))
        _, step_j = J.make_motion_petr_train_step(model_j)
        mj, rj = jnp.asarray(memory), jnp.asarray(memory_ref)
        args_j = (jb["images"], mj, rj, jb["ego_transform"])
        out_j = model_j.apply(params, *args_j)
        params2, _, mem_j, ref_j, metrics_j = jax.jit(step_j)(params, opt.init(params), jb, mj,
                                                              rj)
        init_t, step_t = T.make_motion_petr_train_step(tm)
        model, adamw, mem0, ref0 = init_t(0, tb["images"])
        assert tuple(ref0.shape) == (B, MEM, 3)
        load_jax_params(model, np_tree(params))
        mt, rt = torch.from_numpy(memory), torch.from_numpy(memory_ref)
        out_t = model(tb["images"], mt, rt, tb["ego_transform"])
        _, _, mem_t, ref_t, metrics_t = step_t(model, adamw, tb, mt, rt)
        assert not (mem_t.requires_grad or ref_t.requires_grad)
        memory_agreement(out_t, out_j, [mem_t, ref_t], [mem_j, ref_j], MEM)
    assert set(metrics_t) == set(metrics_j)
    for k in metrics_j:
        assert not metrics_t[k].requires_grad
        np.testing.assert_allclose(float(metrics_t[k]), float(metrics_j[k]), rtol=2e-2)
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert_step_matches(model, jax_param_grads(model_j, params, jb, args_j), params2)


def test_train_step_factories_check_the_model():
    with pytest.raises(ValueError, match="num_memory > 0"):
        T.make_streaming_petr_train_step(T.PETRDetector(**KW))
    with pytest.raises(ValueError, match="motion_aware=True"):
        T.make_motion_petr_train_step(T.PETRDetector(**KW, num_memory=4))


def test_adamw_matches_optax_on_identical_gradients():
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    init = [(rng.normal(size=s) * 0.1).astype(np.float32) for s in shapes]
    params_j = [jnp.asarray(p) for p in init]
    opt = optax.adamw(LR)
    state = opt.init(params_j)
    params_t = [torch.from_numpy(p.copy()).requires_grad_(True) for p in init]
    adamw = T.adamw(params_t)
    for _ in range(5):
        grads = [(rng.normal(size=s) * 10.0 ** rng.integers(-6, 2)).astype(np.float32)
                 for s in shapes]
        updates, state = opt.update([jnp.asarray(g) for g in grads], state, params_j)
        params_j = optax.apply_updates(params_j, updates)
        for p, g in zip(params_t, grads):
            p.grad = torch.from_numpy(g)
        adamw.step()
        for p, w in zip(params_t, params_j):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=0, atol=1e-7)


def test_example_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.make_petr_example_batch()
