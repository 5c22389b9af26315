"""Parity of ``accvlab_tpu_torch.models`` with ``accvlab_tpu.models``.

A width-8 CenterNet gets the JAX package's flax parameters through
``load_jax_params``, so both packages run the same weights on the same
numpy inputs, made from a seed.

Tolerances, and why:

* float32 parts (SAME-padded convs, GroupNorm, the losses and their input
  gradients on float32 head outputs, decode): within 1e-6 relative, or of
  the largest magnitude where a value sits near zero; sums run in another
  order than XLA's.
* The bf16 backbone: one bf16 rounding step is 2^-8 of the value, and a
  float32 difference in the last bits of a GroupNorm output moves some
  bf16 roundings of the next conv; the heads agree within 3e-2 of their
  largest magnitude and the loss within 2e-2 relative (XLA also keeps some
  jitted intermediates above bf16).
* One Adam step: its first update is ±lr·sign(g), so a gradient that the
  bf16 noise moves across zero moves the parameter by up to 2·lr; every
  parameter is within 2·lr of JAX's and the median within 1e-6.
* Adam against ``optax.adam`` on identical gradients: 1e-7 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flax.linen as nn
from accvlab_tpu.models import centernet as J
from accvlab_tpu.models import train_utils as JU
from accvlab_tpu_torch.models import centernet as T
from accvlab_tpu_torch.models import train_utils as TU
from accvlab_tpu_torch.models.params import jax_params_of, load_jax_params
from accvlab_tpu_torch.bench_pipeline import dense_focal_loss

WIDTH, CLASSES, LR = 8, 10, 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_model():
    model = J.CenterNetDetector(num_classes=CLASSES, width=WIDTH)
    images = jnp.zeros((1, 32, 48, 3), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), images)
    return model, params


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(params):
    return load_jax_params(T.CenterNetDetector(CLASSES, WIDTH), np_tree(params))


def rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_close_f32(got, want):
    """1e-6 relative, or 1e-6 of the largest magnitude for values near 0."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


# --------------------------------------------------------------------- #
# Parameters and layers                                                 #
# --------------------------------------------------------------------- #


def test_load_jax_params_round_trips_every_leaf(jax_model):
    _, params = jax_model
    want = np_tree(params)
    back = jax_params_of(port_model(params))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_w) == len(flat_b) == 5 * 3 + 3 * 2
    for path, leaf in flat_w:
        assert flat_b[path].dtype == leaf.dtype
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "no_params_key"])
def test_load_jax_params_raises_on_a_mismatch(jax_model, fault):
    tree = np_tree(jax_model[1])
    inner = tree["params"]
    if fault == "missing":
        del inner["head_size"]["bias"]
    elif fault == "extra":
        inner["ConvBlock_5"] = {"Conv_0": {"kernel": np.zeros((3, 3, 16, 16), np.float32)}}
    elif fault == "shape":
        inner["ConvBlock_1"]["Conv_0"]["kernel"] = np.zeros((3, 3, 8, 9), np.float32)
    else:
        tree = inner
    model = T.CenterNetDetector(CLASSES, WIDTH)
    before = [p.clone() for p in model.parameters()]
    with pytest.raises(ValueError):
        load_jax_params(model, tree)
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))


@pytest.mark.parametrize("hw", [(32, 48), (33, 47), (17, 6)])
@pytest.mark.parametrize("stride", [1, 2])
def test_same_padding_matches_xla(hw, stride):
    """XLA's 'SAME' pads a stride-2 3x3 conv over an even size 0 before and
    1 after; float32, so any shift would show far above the tolerance."""
    rng = np.random.default_rng(hw[0] * 10 + stride)
    x = rng.normal(size=(2, *hw, 5)).astype(np.float32)
    w = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = T.conv2d_same(torch.from_numpy(x).permute(0, 3, 1, 2),
                        torch.from_numpy(w).permute(3, 2, 0, 1), stride).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert_close_f32(got, want)


def test_group_norm_matches_flax():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 5, 7, 16)) * 2 + 1).astype(np.float32)
    gn = nn.GroupNorm(num_groups=8, dtype=jnp.float32)
    params = gn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.normal(size=a.shape).astype(np.float32)), params)
    want = gn.apply(params, jnp.asarray(x))
    p = params["params"]
    got = T.group_norm(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.tensor(np.asarray(p["scale"])),
                       torch.tensor(np.asarray(p["bias"]))).permute(0, 2, 3, 1)
    assert_close_f32(got, want)


def test_init_follows_flax_initialisers():
    model = T.init_params(T.CenterNetDetector(CLASSES, 64), torch.Generator().manual_seed(0))
    w = model.blocks[1].conv.weight.detach()  # fan_in 576, 36,864 draws
    std = (1.0 / 576) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.02 and abs(float(w.mean())) < 0.02 * std
    assert float(w.abs().max()) <= 2.0 * std / T.LECUN_TRUNCATION
    assert all(float(h.bias.abs().max()) == 0.0 for h in model.heads().values())
    assert float(model.blocks[0].norm.weight.min()) == 1.0 == float(model.blocks[0].norm.weight.max())
    again = T.init_params(T.CenterNetDetector(CLASSES, 64), torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


# --------------------------------------------------------------------- #
# Forward, losses, decode                                               #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("hw", [(32, 48), (33, 47)])
def test_forward_matches_jax(jax_model, hw):
    model, params = jax_model
    images = np.random.default_rng(hw[1]).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = jax.jit(model.apply)(params, jnp.asarray(images))
    got = port_model(params)(torch.from_numpy(images))
    for name in ("heatmap", "offset", "size"):
        assert got[name].shape == want[name].shape and got[name].dtype == torch.float32
        assert rel_to_max(got[name].detach(), want[name]) < 3e-2, name


def head_outputs(seed, b=2, hf=4, wf=6):
    rng = np.random.default_rng(seed)
    return {"heatmap": (rng.normal(size=(b, hf, wf, CLASSES)) * 3).astype(np.float32),
            "offset": rng.normal(size=(b, hf, wf, 2)).astype(np.float32),
            "size": (rng.normal(size=(b, hf, wf, 2)) * 4).astype(np.float32)}


def loss_cases():
    jb = J.make_example_batch(hw=(16, 24))
    tb = T.make_example_batch(hw=(16, 24), device="cpu")
    jheat, theat = jb["targets"]["heatmap"], tb["targets"]["heatmap"]
    return {
        "focal_loss": (lambda o: J.focal_loss(o["heatmap"], jheat),
                       lambda o: T.focal_loss(o["heatmap"], theat)),
        "centernet_loss": (lambda o: J.centernet_loss(o, jb["targets"])["loss"],
                           lambda o: T.centernet_loss(o, tb["targets"])["loss"]),
        "bench_dense_loss": (lambda o: bench_dense_loss_jax(o, jheat),
                             lambda o: dense_focal_loss(o, theat)),
    }


def bench_dense_loss_jax(o, heat):
    """``bench.py:307-320``, the loss inside ``measure_input_idle``'s step."""
    pred = jax.nn.sigmoid(o["heatmap"].astype(jnp.float32))
    pos = heat >= 0.999
    pos_loss = jnp.where(pos, ((1 - pred) ** 2) * -jnp.log(pred + 1e-6), 0.0)
    neg_loss = jnp.where(~pos, ((1 - heat) ** 4) * (pred**2) * -jnp.log(1 - pred + 1e-6), 0.0)
    n_pos = jnp.maximum(jnp.sum(pos), 1.0)
    focal = (jnp.sum(pos_loss) + jnp.sum(neg_loss)) / n_pos
    reg = jnp.mean(jnp.abs(o["offset"])) + jnp.mean(jnp.abs(o["size"]))
    return focal + 0.01 * reg


@pytest.mark.parametrize("name", ["focal_loss", "centernet_loss", "bench_dense_loss"])
def test_losses_and_input_gradients_match_jax(name):
    fn_j, fn_t = loss_cases()[name]
    # 8 targets per sample on a 4x6 grid: duplicate centres in the gather
    heads = head_outputs(7)
    loss_j, grads_j = jax.value_and_grad(fn_j)({k: jnp.asarray(v) for k, v in heads.items()})
    heads_t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in heads.items()}
    loss_t = fn_t(heads_t)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    for k in heads:
        grad = heads_t[k].grad
        assert_close_f32(torch.zeros_like(heads_t[k]) if grad is None else grad, grads_j[k])


def test_centernet_loss_terms_match_jax():
    jb = J.make_example_batch(hw=(16, 24))
    tb = T.make_example_batch(hw=(16, 24), device="cpu")
    heads = head_outputs(11)
    want = J.centernet_loss({k: jnp.asarray(v) for k, v in heads.items()}, jb["targets"])
    got = T.centernet_loss({k: torch.from_numpy(v) for k, v in heads.items()}, tb["targets"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


def test_example_batch_is_the_same_data():
    jb, tb = J.make_example_batch(seed=4), T.make_example_batch(seed=4, device="cpu")
    np.testing.assert_array_equal(tb["images"].numpy(), np.asarray(jb["images"]))
    for k, v in jb["targets"].items():
        got = tb["targets"][k]
        if k == "heatmap":
            np.testing.assert_array_equal(got.numpy(), np.asarray(v))
        else:
            np.testing.assert_array_equal(got.tensor.numpy(), np.asarray(v.tensor))
            np.testing.assert_array_equal(got.sample_sizes.numpy(), np.asarray(v.sample_sizes))


def test_decode_detections_matches_jax_on_the_valid_prefix():
    heads = head_outputs(5, hf=16, wf=24)
    heads["heatmap"] -= 4.0  # about 25 pixels per image above the threshold
    want = J.decode_detections({k: jnp.asarray(v) for k, v in heads.items()}, max_detections=40,
                               score_threshold=0.97)
    got = T.decode_detections({k: torch.from_numpy(v) for k, v in heads.items()},
                              max_detections=40, score_threshold=0.97)
    sizes = np.asarray(want["scores"].sample_sizes)
    np.testing.assert_array_equal(got["scores"].sample_sizes.numpy(), sizes)
    assert 0 < sizes.min() and sizes.max() < 40
    for k in ("boxes", "scores", "classes"):
        assert tuple(got[k].tensor.shape) == want[k].tensor.shape
        for b, n in enumerate(sizes):
            g, w = got[k].tensor[b, :n].numpy(), np.asarray(want[k].tensor[b, :n])
            if k == "classes":
                np.testing.assert_array_equal(g, w)
            else:
                assert_close_f32(g, w)


# --------------------------------------------------------------------- #
# Training                                                              #
# --------------------------------------------------------------------- #


def test_one_train_step_matches_jax(jax_model):
    model, params = jax_model
    jb = J.make_example_batch(hw=(32, 48))
    tb = T.make_example_batch(hw=(32, 48), device="cpu")
    init_j, step_j = J.make_train_step(model)
    opt_state = optax.adam(LR).init(params)
    params2, _, metrics_j = jax.jit(step_j)(params, opt_state, jb)

    init_t, step_t = T.make_train_step(T.CenterNetDetector(CLASSES, WIDTH))
    tmodel, opt = init_t(0, tb["images"])
    load_jax_params(tmodel, np_tree(params))
    _, _, metrics_t = step_t(tmodel, opt, tb)
    # float32 parameters, cast inside forward: their gradients arrive in float32
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in tmodel.parameters())

    assert set(metrics_t) == set(metrics_j)
    for k in metrics_j:
        assert not metrics_t[k].requires_grad
        np.testing.assert_allclose(float(metrics_t[k]), float(metrics_j[k]), rtol=2e-2)
    want = jax.tree_util.tree_leaves(np_tree(params2))
    got = jax.tree_util.tree_leaves(jax_params_of(tmodel))
    diffs = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    assert diffs.max() <= 2 * LR * (1 + 1e-3) and np.median(diffs) < 1e-6


def test_init_fn_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    init_t, _ = T.make_train_step(T.CenterNetDetector(CLASSES, WIDTH))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_t(0, np.zeros((1, 32, 48, 3), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.make_example_batch()


def test_adam_matches_optax_on_identical_gradients():
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    # weights of the model's size (|p| < 1, where a float32 step is at most
    # 1.2e-7), gradients over eight decades
    init = [(rng.normal(size=s) * 0.1).astype(np.float32) for s in shapes]
    params_j = [jnp.asarray(p) for p in init]
    opt = optax.adam(LR)
    state = opt.init(params_j)
    params_t = [torch.from_numpy(p.copy()).requires_grad_(True) for p in init]
    adam = T.adam(params_t)
    for _ in range(5):
        grads = [(rng.normal(size=s) * 10.0 ** rng.integers(-6, 2)).astype(np.float32)
                 for s in shapes]
        updates, state = opt.update([jnp.asarray(g) for g in grads], state, params_j)
        params_j = optax.apply_updates(params_j, updates)
        for p, g in zip(params_t, grads):
            p.grad = torch.from_numpy(g)
        adam.step()
        for p, w in zip(params_t, params_j):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=0, atol=1e-7)


def tiny_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32),
            "count": np.array(seed, np.int32)}


@pytest.mark.parametrize("step", [None, 0, 7, "tensor"])
def test_ema_matches_train_utils(step):
    ema0, params = tiny_tree(1), tiny_tree(2)
    s_j = 7 if step == "tensor" else step
    s_t = torch.tensor(7) if step == "tensor" else step
    want = JU.ema_update(JU.ema_init({k: jnp.asarray(v) for k, v in ema0.items()}),
                         {k: jnp.asarray(v) for k, v in params.items()}, decay=0.99, step=s_j)
    ema_t = TU.ema_init({k: torch.from_numpy(v) for k, v in ema0.items()})
    got = TU.ema_update(ema_t, {k: torch.from_numpy(v) for k, v in params.items()}, decay=0.99,
                        step=s_t)
    assert TU.ema_params(got) is got
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)
    assert int(got["count"]) == 2


def test_ema_init_copies():
    src = {"w": torch.ones(3)}
    ema = TU.ema_init(src)
    src["w"].add_(1.0)
    assert float(ema["w"][0]) == 1.0


class _Linear(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(b.copy()))


@pytest.mark.parametrize("remat", [False, True])
def test_grad_accumulation_matches_train_utils(remat):
    rng = np.random.default_rng(9)
    w, b = rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32)
    x = rng.normal(size=(8, 5)).astype(np.float32)
    y = rng.normal(size=(8, 3)).astype(np.float32)
    sizes = rng.integers(0, 4, (8,)).astype(np.int32)

    def loss_j(p, mb):
        err = (mb["x"] @ p["w"] + p["b"] - mb["y"]) * mb["keep"].sample_sizes[:, None]
        return jnp.mean(err**2)

    from accvlab_tpu.ragged import RaggedBatch as JR
    batch_j = {"x": jnp.asarray(x), "y": jnp.asarray(y),
               "keep": JR(jnp.asarray(y), sample_sizes=jnp.asarray(sizes))}
    params_j = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    opt = optax.adam(LR)
    step_j = JU.make_grad_accum_step(loss_j, opt, 2, remat=remat)
    params2, _, lj = step_j(params_j, opt.init(params_j), batch_j)

    def loss_t(m, mb):
        err = (mb["x"] @ m.w + m.b - mb["y"]) * mb["keep"].sample_sizes[:, None]
        return (err**2).mean()

    model = _Linear(w, b)
    batch_t = {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
               "keep": T.RaggedBatch(torch.from_numpy(y), sample_sizes=torch.from_numpy(sizes))}
    step_t = TU.make_grad_accum_step(loss_t, 2, remat=remat)
    _, _, lt = step_t(model, T.adam(model.parameters()), batch_t)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    np.testing.assert_allclose(model.w.detach().numpy(), np.asarray(params2["w"]), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(model.b.detach().numpy(), np.asarray(params2["b"]), rtol=0,
                               atol=1e-7)
    with pytest.raises(ValueError):
        TU.make_grad_accum_step(loss_t, 3)(model, T.adam(model.parameters()), batch_t)
