"""Weight-only int8/int4 quantization of the port (``accvlab_tpu_torch.models.quantize``)
against ``accvlab_tpu.models.quantize``, case by case with ``tests/test_quantize.py``.

The storage is the JAX package's number for number: on the same numpy weights
``q`` and ``scale`` are bitwise equal (int8 and int4), and so are the
dequantized weights and ``params_nbytes``. A CenterNet's parameters are
quantized in their flax layout (``load_jax_params`` gives both packages the
same weights), and the quantized port model is held against JAX's quantized
``apply`` within the forward tolerance of
``tests/test_torch_models.py::test_forward_matches_jax`` (3e-2 of the heads'
largest magnitude: the bf16 backbone).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from accvlab_tpu.models import quantize as JQ
from accvlab_tpu.models.centernet import CenterNetDetector as JCenterNet
from accvlab_tpu_torch.models import params as P
from accvlab_tpu_torch.models.centernet import CenterNetDetector
from accvlab_tpu_torch.models.quantize import (
    QuantizedTensor,
    _quantize_leaf_int4,
    dequantize_params,
    freeze_params_quantized,
    params_nbytes,
    quantize_params,
)

CLASSES, WIDTH = 4, 16
FORWARD_TOL = 3e-2  # tests/test_torch_models.py::test_forward_matches_jax


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    """The JAX model and params, and the port model with the same weights."""
    jmodel = JCenterNet(num_classes=CLASSES, width=WIDTH)
    params = jmodel.init(jax.random.PRNGKey(0), np.zeros((2, 32, 32, 3), np.float32))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    model = P.load_jax_params(CenterNetDetector(CLASSES, WIDTH), np_params)
    return jmodel, params, model.eval().requires_grad_(False)


def _images(batch, seed=1):
    return np.random.default_rng(seed).standard_normal((batch, 32, 32, 3)).astype(np.float32)


def _flax_paths(model):
    """port parameter name -> flax path ("ConvBlock_0/Conv_0/kernel")."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(param)]: "/".join(path) for path, (param, _) in P._leaves(model).items()}


def _jax_leaves(tree):
    flat = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, JQ.QuantizedTensor))
    return {"/".join(str(getattr(k, "key", k)) for k in path[1:]): leaf for path, leaf in flat}


# --------------------------------------------------------------------------- #
# the JAX file's cases                                                        #
# --------------------------------------------------------------------------- #


def test_structure_and_selection(models):
    _, _, model = models
    qp = quantize_params(model)
    assert any(k.endswith("conv.weight") and isinstance(v, QuantizedTensor)
               for k, v in qp.items())
    assert all(not isinstance(v, QuantizedTensor) for k, v in qp.items() if k.endswith("bias"))
    for name, leaf in qp.items():
        if isinstance(leaf, QuantizedTensor):
            assert leaf.q.dtype == torch.int8
            assert leaf.scale.shape[-1] == leaf.q.shape[-1]
            assert leaf.shape == tuple(dict(model.named_parameters())[name].shape)


def test_dequantize_error_bound(models):
    _, _, model = models
    deq = dequantize_params(quantize_params(model))
    for name, orig in model.named_parameters():
        o, r = orig.numpy(), deq[name].numpy()
        assert o.shape == r.shape
        if o.ndim >= 2 and o.size >= 1024:
            # per output channel (axis 0 of OIHW): error <= amax / 254
            amax = np.abs(o).max(axis=tuple(range(1, o.ndim)), keepdims=True)
            assert (np.abs(o - r) <= amax / 254 + 1e-7).all()
        else:
            np.testing.assert_array_equal(o, r)


def test_model_output_close_to_full_precision(models):
    _, _, model = models
    x = torch.from_numpy(_images(2))
    want = model(x)["heatmap"].numpy()
    got = freeze_params_quantized(model, quantize_params(model))(x)["heatmap"].numpy()
    assert np.abs(got - want).max() / max(1e-3, float(np.abs(want).max())) < 0.12
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99


def test_bytes_shrink_about_4x(models):
    _, _, model = models
    assert params_nbytes(quantize_params(model)) < params_nbytes(model) / 3


def test_quantized_tree_flows_through_export(models):
    """The dequantization traces: an exported function of the quantized
    weights computes their squared norm (the JAX file's jit case)."""
    _, _, model = models
    qp = quantize_params(model)

    class Norm(torch.nn.Module):
        def forward(self, x):
            deq = dequantize_params(qp, torch.float32)
            return x * sum((v * v).sum() for v in deq.values())

    ep = torch.export.export(Norm(), (torch.ones(()),))
    want = sum(float((v.double() ** 2).sum()) for v in dequantize_params(qp).values())
    assert float(ep.module()(torch.ones(()))) == pytest.approx(want, rel=1e-5)


def test_idempotent_requantization(models):
    _, _, model = models
    qp = quantize_params(model, min_size=64)
    qp2 = quantize_params(qp, min_size=64)
    assert qp.keys() == qp2.keys()
    for k in qp:
        a, b = qp[k], qp2[k]
        assert type(a) is type(b)
        if isinstance(a, QuantizedTensor):
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
            assert not isinstance(b.scale, QuantizedTensor)


def test_quantize_accepts_numpy_leaves(models):
    _, _, model = models
    np_params = {n: p.numpy() for n, p in model.named_parameters()}
    assert any(isinstance(v, QuantizedTensor) for v in quantize_params(np_params).values())


def test_predicate_and_min_size(models):
    _, _, model = models
    assert not any(isinstance(v, QuantizedTensor)
                   for v in quantize_params(model, min_size=1 << 30).values())
    everything2d = quantize_params(model, predicate=lambda t: t.ndim >= 2)
    assert all(isinstance(v, QuantizedTensor) for k, v in everything2d.items()
               if k.endswith("weight") and "conv" in k)


def test_composes_with_serving_export(tmp_path, models):
    from accvlab_tpu_torch.models.serving import export_inference, load_inference, save_inference

    _, _, model = models
    x = torch.from_numpy(_images(2))
    p_full, p_q = str(tmp_path / "full.accvserve"), str(tmp_path / "int8.accvserve")
    save_inference(p_full, model, x)
    art = export_inference(freeze_params_quantized(model, quantize_params(model)), (x,))
    with open(p_q, "wb") as f:
        f.write(art)
    assert os.path.getsize(p_q) < os.path.getsize(p_full)
    # the int8 tensors are the program's constants, and no float copy of the
    # weights they replace is
    qp = quantize_params(model)
    serve = load_inference(p_q, device="cpu")
    consts = list(serve._program.constants.values()) + list(serve._program.state_dict.values())
    assert sorted(c.numel() for c in consts if c.dtype == torch.int8) == sorted(
        v.q.numel() for v in qp.values() if isinstance(v, QuantizedTensor))
    assert sum(c.numel() * 4 for c in consts if c.dtype == torch.float32) <= params_nbytes(qp)
    got = serve(x)["heatmap"].numpy()
    want = model(x)["heatmap"].numpy()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99


def np_int4_oracle(w, gs):
    """Scalar numpy mirror of the int4 quantize+dequantize round trip."""
    shape = w.shape
    c = shape[-1]
    w2 = w.reshape(-1, c).astype(np.float32)
    rows = w2.shape[0]
    gs = gs or rows
    n_groups = -(-rows // gs)
    if (n_groups * gs) % 2:
        n_groups += 1
    rows_p = n_groups * gs
    wp = np.zeros((rows_p, c), np.float32)
    wp[:rows] = w2
    wg = wp.reshape(n_groups, gs, c)
    amax = np.abs(wg).max(axis=1, keepdims=True)
    scale = np.where(amax > 0, amax / 7.0, 1.0).astype(np.float32)
    q = np.clip(np.round(wg / scale), -7, 7).astype(np.int8)
    dq = (q.astype(np.float32) * scale).reshape(rows_p, c)[:rows]
    return dq.reshape(shape), scale


INT4_CASES = [
    ((64, 16), None),
    ((64, 16), 16),
    ((128, 8), 64),
    ((5, 3), 3),      # within-group padding (2 groups x 3 rows = even)
    ((9, 4), 3),      # odd n_groups*gs -> EXTRA all-padding group
    ((7, 4), None),   # odd rows, single group
    ((3, 3, 8, 12), 8),  # conv kernel: rows = 3*3*8
]


@pytest.mark.parametrize("shape,gs", INT4_CASES)
def test_int4_matches_numpy_oracle(shape, gs):
    rng = np.random.default_rng(sum(shape) * 7 + len(shape))
    w = rng.normal(scale=0.2, size=shape).astype(np.float32)
    qt = _quantize_leaf_int4(torch.from_numpy(w), gs)
    assert qt.bits == 4 and qt.shape == shape and qt.q.dtype == torch.uint8
    want, scale = np_int4_oracle(w, gs)
    np.testing.assert_array_equal(qt.dequantize().numpy(), want)
    rows = int(np.prod(shape[:-1]))
    step = np.repeat(scale, gs or rows, axis=1).reshape(-1, shape[-1])[:rows]
    err = np.abs(qt.dequantize().numpy().reshape(rows, -1) - w.reshape(rows, -1))
    assert (err <= step / 2 + 1e-7).all()


def test_int4_bytes_shrink_about_8x():
    w = np.random.default_rng(0).normal(size=(256, 256)).astype(np.float32)
    nb = params_nbytes(quantize_params({"w": w}, bits=4, group_size=64))
    assert nb == 256 * 256 // 2 + (256 // 64) * 256 * 4
    assert w.nbytes / nb > 7.0


def test_int4_group_scales_beat_per_channel_on_heterogeneous_rows():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(np.concatenate(
        [rng.normal(scale=0.01, size=(96, 32)), rng.normal(scale=10.0, size=(32, 32))]
    ).astype(np.float32))
    err_flat = (_quantize_leaf_int4(w, None).dequantize() - w).abs()
    err_grp = (_quantize_leaf_int4(w, 32).dequantize() - w).abs()
    assert err_grp[:96].mean() < 0.15 * err_flat[:96].mean()


def test_int4_through_export():
    from accvlab_tpu_torch.models.serving import export_inference, load_inference

    rng = np.random.default_rng(2)
    w = rng.normal(scale=0.1, size=(64, 48)).astype(np.float32)
    qp = quantize_params({"k": w}, bits=4, group_size=16)

    def fn(x):
        return x @ dequantize_params(qp)["k"]

    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    art = export_inference(fn, (x,))
    got = load_inference(art, device="cpu")(x)
    torch.testing.assert_close(got, x @ dequantize_params(qp)["k"], rtol=1e-5, atol=1e-5)
    # the artifact holds the packed bytes (1.5 KB), not the floats (12 KB)
    consts = load_inference(art, device="cpu")._program.constants.values()
    assert [c.shape for c in consts if c.dtype == torch.uint8] == [qp["k"].q.shape]
    assert not any(c.dtype == torch.float32 and c.numel() >= w.size for c in consts)


def test_int4_validation():
    with pytest.raises(ValueError, match="bits"):
        quantize_params({}, bits=2)
    with pytest.raises(ValueError, match="group_size"):
        quantize_params({}, bits=8, group_size=64)
    with pytest.raises(ValueError, match="group_size"):
        _quantize_leaf_int4(torch.ones((8, 8)), 0)


def test_quantized_params_checkpoint_roundtrip(tmp_path):
    from accvlab_tpu_torch.models.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
        save_checkpoint,
    )

    w = np.random.default_rng(3).normal(size=(64, 32)).astype(np.float32)
    qp = quantize_params({"w": w}, bits=4, group_size=16)
    save_checkpoint(str(tmp_path), 1, qp, None, {"quantized": True})
    restored, _, meta = restore_checkpoint(latest_checkpoint(str(tmp_path)),
                                           {"params": qp, "opt_state": None})
    rq = restored["w"]
    assert isinstance(rq, QuantizedTensor)
    assert rq.bits == 4 and rq.shape == (64, 32) and rq.group_size == 16
    assert torch.equal(rq.q, qp["w"].q)
    assert torch.equal(rq.dequantize(), qp["w"].dequantize())
    assert meta["pipeline"]["quantized"] is True


# --------------------------------------------------------------------------- #
# number for number against the JAX package                                  #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("bits,shape,gs", [(8, (64, 16), None), (8, (3, 3, 8, 12), None),
                                           (8, (5, 3), None)]
                         + [(4, s, g) for s, g in INT4_CASES])
def test_q_and_scale_bitwise_equal_jax(bits, shape, gs):
    w = np.random.default_rng(sum(shape) + bits).normal(scale=0.2, size=shape)
    w = w.astype(np.float32)
    kw = {} if bits == 8 else {"bits": 4, "group_size": gs}
    want = JQ.quantize_params({"w": w}, min_size=1, **kw)["w"]
    got = quantize_params({"w": w}, min_size=1, **kw)["w"]
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))
    assert params_nbytes({"w": got}) == JQ.params_nbytes({"w": want})


@pytest.mark.parametrize("bits,gs", [(8, None), (4, None), (4, 64)])
def test_centernet_storage_equals_jax(models, bits, gs):
    """Quantized in flax's layout: each leaf's q and scale are JAX's, the
    dequantized weight is JAX's in the port's layout, and the byte counts
    agree."""
    _, params, model = models
    kw = {} if bits == 8 else {"bits": 4, "group_size": gs}
    want = _jax_leaves(JQ.quantize_params(params, **kw))
    got = quantize_params(model, **kw)
    paths = _flax_paths(model)
    n_quantized = 0
    for name, leaf in got.items():
        ref = want[paths[name]]
        assert isinstance(leaf, QuantizedTensor) == isinstance(ref, JQ.QuantizedTensor), name
        if isinstance(leaf, QuantizedTensor):
            n_quantized += 1
            np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(ref.q), err_msg=name)
            np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(ref.scale),
                                          err_msg=name)
            deq = np.asarray(ref.dequantize())
            np.testing.assert_array_equal(leaf.dequantize().numpy(),
                                          deq.transpose(P.HWIO_TO_OIHW), err_msg=name)
    assert n_quantized >= 4
    assert params_nbytes(got) == JQ.params_nbytes(JQ.quantize_params(params, **kw))


@pytest.mark.parametrize("bits,gs", [(8, None), (4, 64)])
def test_quantized_centernet_matches_jax_apply(models, bits, gs):
    jmodel, params, model = models
    kw = {} if bits == 8 else {"bits": 4, "group_size": gs}
    x = _images(2, seed=5)
    want = jax.jit(JQ.freeze_params_quantized(jmodel.apply, JQ.quantize_params(params, **kw)))(
        jnp.asarray(x))
    got = freeze_params_quantized(model, quantize_params(model, **kw))(torch.from_numpy(x))
    for name in ("heatmap", "offset", "size"):
        g, w = got[name].numpy().astype(np.float64), np.asarray(want[name], np.float64)
        assert g.shape == w.shape
        assert np.abs(g - w).max() / np.abs(w).max() < FORWARD_TOL, name
