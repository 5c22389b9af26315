"""Serving artifacts of the port (``accvlab_tpu_torch.models.serving``), case by
case with ``tests/test_serving_export.py``.

On the CPU an artifact's program runs the same ATen operations as the live
module on the same shapes, so the round trip is held bitwise. Against the
JAX package's own artifact on the same weights (``load_jax_params``) the
tolerance is the forward's, 3e-2 of the heads' largest magnitude
(``tests/test_torch_models.py::test_forward_matches_jax``: the bf16
backbone). The sharded cases wait for the port of ``parallel``
(ROADMAP.md).
"""

import json
import os
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from accvlab_tpu_torch._device import F32MatmulScope
from accvlab_tpu_torch.detection_serving import detection_fn
from accvlab_tpu_torch.models import serving as S
from accvlab_tpu_torch.models.centernet import CenterNetDetector, init_params
from accvlab_tpu_torch.models.serving import (
    export_inference,
    freeze_params,
    load_inference,
    read_artifact_info,
    save_inference,
)
from accvlab_tpu_torch.ragged import RaggedBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORWARD_TOL = 3e-2  # tests/test_torch_models.py::test_forward_matches_jax


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def small_model():
    model = CenterNetDetector(num_classes=4, width=8)
    init_params(model, torch.Generator().manual_seed(0))
    return model.eval().requires_grad_(False)


def _images(batch, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((batch, 32, 32, 3)).astype(np.float32))


def _assert_trees_equal(got, want):
    gl, gs = pytree.tree_flatten(got)
    wl, ws = pytree.tree_flatten(want)
    assert gs == ws, "tree structure changed"
    for g, w in zip(gl, wl):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_roundtrip_matches_module(tmp_path, small_model):
    path = str(tmp_path / "centernet.accvserve")
    info = save_inference(path, small_model, _images(2))
    assert os.path.exists(path)
    assert not any(".tmp." in f for f in os.listdir(tmp_path))
    serve = load_inference(path, device="cpu")
    x = _images(2, seed=3)
    _assert_trees_equal(serve(x), small_model(x))
    assert info["accvlab_tpu_torch_version"] and info["torch_version"] == torch.__version__
    assert info["program_format"] == "torch.export"
    assert serve.info["fn_name"]


def test_artifact_is_self_contained_no_model_code(tmp_path, small_model):
    """A fresh interpreter in which importing the model module or the
    pipeline fails serves the artifact (detections included: the loader
    registers RaggedBatch on its own)."""
    path = str(tmp_path / "art.accvserve")
    save_inference(path, detection_fn(small_model), _images(2))
    xpath = str(tmp_path / "x.pt")
    torch.save(_images(2, seed=9), xpath)
    code = (
        "import sys\n"
        "sys.modules['accvlab_tpu_torch.models.centernet'] = None\n"
        "sys.modules['accvlab_tpu_torch.pipeline'] = None\n"
        "import torch\n"
        "from accvlab_tpu_torch.models.serving import load_inference\n"
        f"serve = load_inference({path!r}, device='cpu')\n"
        f"out = serve(torch.load({xpath!r}))\n"
        "print('heatmap', tuple(out['heatmap'].shape), type(out['detections']['boxes']).__name__)\n"
        "print(sorted(m for m, v in sys.modules.items() if v is not None\n"
        "             and m.startswith('accvlab_tpu')))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "heatmap (2, 8, 8, 4) RaggedBatch" in r.stdout
    mods = r.stdout.strip().splitlines()[-1]
    assert "centernet" not in mods and "pipeline" not in mods and "'accvlab_tpu'" not in mods


def test_batch_polymorphic_serves_any_batch(small_model):
    art = export_inference(freeze_params(small_model), (_images(2),), batch_polymorphic=True)
    info = read_artifact_info(art)
    assert info["batch_polymorphic"] is True
    assert not info["in_specs"][0].startswith("float32[2,")
    serve = load_inference(art, device="cpu")
    for batch in (1, 2, 5):
        assert serve(_images(batch, seed=batch))["heatmap"].shape == (batch, 8, 8, 4)
    x = _images(3, seed=42)  # an unseen batch size: the same operations as the module's
    _assert_trees_equal(serve(x), small_model(x))


def test_float32_fn_roundtrips_exactly(tmp_path):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))

    def fn(a):
        return {"y": torch.tanh(a @ w)}

    path = str(tmp_path / "f32.accvserve")
    save_inference(path, fn, x)
    assert torch.equal(load_inference(path, device="cpu")(x)["y"], fn(x)["y"])


def test_artifact_names_both_platforms(small_model):
    """Constants are saved on the CPU and moved at load: the header names
    both devices (the JAX example's ``("tpu", "cpu")``)."""
    art = export_inference(freeze_params(small_model), (_images(2),))
    assert read_artifact_info(art)["platforms"] == ["cuda", "cpu"]
    serve = load_inference(art, device="cpu")
    assert serve.device == torch.device("cpu")
    assert all(c.device.type == "cpu" for c in serve._program.constants.values())
    assert serve(_images(2))["heatmap"].shape == (2, 8, 8, 4)


def test_batch_polymorphic_rejects_scalar_leaves(small_model):
    with pytest.raises(ValueError, match="leading batch dimension"):
        export_inference(freeze_params(small_model), (np.float32(1.0),), batch_polymorphic=True)


def test_batch_polymorphic_needs_an_example_batch_of_two(small_model):
    with pytest.raises(ValueError, match="2 or more"):
        export_inference(freeze_params(small_model), (_images(1),), batch_polymorphic=True)


def test_header_audit_and_error_contracts(small_model):
    art = export_inference(freeze_params(small_model), (_images(2),))
    info = read_artifact_info(art)
    assert info["format_version"] == 1
    assert info["nr_devices"] == 1
    assert info["platforms"]
    assert info["float32_matmul"] == "highest"
    assert info["custom_ops"] == [] and info["pytree_types"] == []
    assert len(info["in_specs"]) == 1 and len(info["out_specs"]) == 3

    with pytest.raises(ValueError, match="bad magic"):
        read_artifact_info(b"ORBAX-CHECKPOINT" + art)
    with pytest.raises(ValueError, match="truncated"):
        read_artifact_info(art[: len(art) - 8])
    with pytest.raises(ValueError, match="truncated"):
        read_artifact_info(art[:18])
    hj = json.dumps({"format_version": 99}).encode()
    with pytest.raises(ValueError, match="newer"):
        read_artifact_info(S._MAGIC + struct.pack("<II", len(hj), 0) + hj)


def test_sharded_export_and_load_wait_for_parallel(small_model):
    """The sharded side's contracts without a process group: ``mesh`` needs
    ``in_shardings``, and an unsharded artifact (one device) does not load
    onto a mesh of two (tests/test_torch_sharded_serving.py runs meshes)."""

    class TwoRanks:
        def size(self):
            return 2

    with pytest.raises(ValueError, match="together"):
        export_inference(freeze_params(small_model), (_images(2),), mesh=object())
    art = export_inference(freeze_params(small_model), (_images(2),))
    with pytest.raises(ValueError, match="same-size mesh"):
        load_inference(art, device="cpu", mesh=TwoRanks())


def test_detections_come_back_as_ragged_batches(small_model):
    fn = detection_fn(small_model)
    art = export_inference(fn, (_images(2),), batch_polymorphic=True)
    info = read_artifact_info(art)
    assert info["pytree_types"] == ["accvlab_tpu_torch.ragged.RaggedBatch"]
    x = _images(3, seed=4)
    got = load_inference(art, device="cpu")(x)
    assert isinstance(got["detections"]["scores"], RaggedBatch)
    _assert_trees_equal(got, fn(x))


def test_jax_artifact_is_refused():
    import jax.numpy as jnp
    from accvlab_tpu.models import serving as JS

    art = JS.export_inference(lambda x: {"y": jnp.tanh(x)}, (np.zeros((2, 3), np.float32),))
    assert "jax_version" in JS.read_artifact_info(art)
    with pytest.raises(ValueError, match="JAX serving artifact"):
        load_inference(art, device="cpu")


def test_artifact_matches_jax_artifact_on_the_same_weights(tmp_path):
    """The port's artifact and the JAX package's own artifact of the same
    CenterNet weights agree within the forward tolerance."""
    import jax
    from accvlab_tpu.models import serving as JS
    from accvlab_tpu.models.centernet import CenterNetDetector as JCenterNet
    from accvlab_tpu_torch.models.params import load_jax_params

    jmodel = JCenterNet(num_classes=4, width=8)
    params = jmodel.init(jax.random.PRNGKey(2), np.zeros((2, 32, 32, 3), np.float32))
    model = load_jax_params(CenterNetDetector(4, 8), jax.tree_util.tree_map(np.asarray, params))
    x = _images(2, seed=6)
    jpath, tpath = str(tmp_path / "jax.accvserve"), str(tmp_path / "torch.accvserve")
    JS.save_inference(jpath, jmodel.apply, params, x.numpy(), batch_polymorphic=True)
    save_inference(tpath, model.eval().requires_grad_(False), x, batch_polymorphic=True)
    x3 = _images(3, seed=7)
    want = JS.load_inference(jpath)(x3.numpy())
    got = load_inference(tpath, device="cpu")(x3)
    for name in ("heatmap", "offset", "size"):
        g, w = got[name].numpy().astype(np.float64), np.asarray(want[name], np.float64)
        assert g.shape == w.shape
        assert np.abs(g - w).max() / np.abs(w).max() < FORWARD_TOL, name


def test_export_fuzz_random_trees():
    """Random nested input/output trees, mixed dtypes: structure preserved,
    float32 and integer paths exact."""
    rng = np.random.default_rng(0)
    for case in range(6):
        in_shapes = [tuple(int(d) for d in rng.integers(1, 7, size=rng.integers(1, 4)))
                     for _ in range(int(rng.integers(1, 4)))]
        w = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))

        def fn(*args):
            outs = {}
            for i, a in enumerate(args):
                x = a.to(torch.float32).reshape(-1)
                x = torch.nn.functional.pad(x, (0, (-x.numel()) % 5)).reshape(-1, 5)
                outs[f"o{i}"] = {"y": torch.tanh(x @ w),
                                 "n": torch.tensor(x.shape[0], dtype=torch.int32)}
            return outs, tuple(a.sum() for a in args)

        args = tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32)) if i % 2 == 0
                     else torch.from_numpy(rng.integers(-9, 9, s).astype(np.int32))
                     for i, s in enumerate(in_shapes))
        serve = load_inference(export_inference(fn, args), device="cpu")
        _assert_trees_equal(serve(*args), fn(*args))


def test_matmul_precision_scopes_on_two_threads():
    """A loaded program and a pipeline's device stage may hold the float32
    matmul scope on two threads at once: a scope closing on one thread must
    not end the other's, and the caller's settings come back once both
    closed."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def a():
        with F32MatmulScope():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def b():
        a_in.wait(10)
        with F32MatmulScope():
            b_in.set()
            a_out.wait(10)
            seen["inside_b_after_a_left"] = torch.get_float32_matmul_precision()

    try:
        ts = [threading.Thread(target=a), threading.Thread(target=b)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(20)
        assert seen["inside_b_after_a_left"] == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_loaded_program_runs_under_its_recorded_precision():
    calls = []

    def fn(x):
        return x * 2.0

    serve = load_inference(export_inference(fn, (torch.ones(2, 2),)), device="cpu")
    original = serve._module

    def spy(*args):
        calls.append(torch.get_float32_matmul_precision())
        return original(*args)

    serve._module = spy
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        serve(torch.ones(2, 2))
        assert calls == ["highest"]
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_matmul_precision_scopes_under_thread_stress():
    """Many threads opening and closing the scope with a short switch
    interval: inside every scope the precision is full float32, and the
    caller's setting is back once all closed."""
    prev_prec, prev_switch = torch.get_float32_matmul_precision(), sys.getswitchinterval()
    torch.set_float32_matmul_precision("medium")
    bad = []

    def worker():
        for _ in range(200):
            with F32MatmulScope():
                if torch.get_float32_matmul_precision() != "highest":
                    bad.append(torch.get_float32_matmul_precision())

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert bad == []
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        sys.setswitchinterval(prev_switch)
        torch.set_float32_matmul_precision(prev_prec)
