"""The PyTorch port stands alone: it imports no JAX and nothing of
``accvlab_tpu``, keeps byte-identical copies of the host C++ it shares, and
runs on the CPU only when asked to."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "accvlab_tpu_torch")
SUBPACKAGES = [
    "accvlab_tpu_torch",
    "accvlab_tpu_torch.bench_pipeline",
    "accvlab_tpu_torch.heatmap",
    "accvlab_tpu_torch.hostcopy",
    "accvlab_tpu_torch.models",
    "accvlab_tpu_torch.pipeline",
    "accvlab_tpu_torch.pipeline.inputs",
    "accvlab_tpu_torch.pipeline.operators",
    "accvlab_tpu_torch.pipeline.processing_steps",
    "accvlab_tpu_torch.ragged",
    "accvlab_tpu_torch.train_centernet_e2e",
]
COPIED_CSRC = [("hostcopy/csrc/pack.cpp", "accvlab_tpu/hostcopy/csrc/pack.cpp")]


def _port_files():
    out = []
    for root, _, files in os.walk(PORT):
        if "_build" in root or "__pycache__" in root:
            continue
        out += [os.path.relpath(os.path.join(root, f), REPO) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.fixture(scope="module")
def imported_modules():
    code = (
        "import importlib, json, sys\n"
        f"for m in {SUBPACKAGES!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("module", SUBPACKAGES)
def test_subpackage_imports_without_jax(imported_modules, module):
    assert module in imported_modules
    assert "jax" not in imported_modules
    assert not any(m == "accvlab_tpu" or m.startswith("accvlab_tpu.") for m in imported_modules)


@pytest.mark.parametrize("path", _port_files())
def test_no_jax_or_reference_import(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    for name in names:
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax", "accvlab_tpu"), (
            f"{path} imports {name}"
        )


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
            assert not any(m.split(".")[0] in ("jax", "accvlab_tpu") for m in mods)


@pytest.mark.parametrize("copy,original", COPIED_CSRC)
def test_copied_csrc_is_byte_identical(copy, original):
    with open(os.path.join(PORT, copy), "rb") as a, open(os.path.join(REPO, original), "rb") as b:
        assert a.read() == b.read()


def _entry_points():
    from accvlab_tpu_torch.heatmap import draw_gaussians, draw_heatmap, draw_heatmap_batched
    from accvlab_tpu_torch.hostcopy import start_copy
    from accvlab_tpu_torch.ragged import RaggedBatch

    z = np.zeros
    rb = RaggedBatch(z((1, 1, 2), np.int32), sample_sizes=np.ones(1, np.int32))
    rr = RaggedBatch(z((1, 1), np.int32), sample_sizes=np.ones(1, np.int32))
    return {
        "draw_heatmap": lambda **kw: draw_heatmap(z((1, 4, 4), np.float32), z((1, 2), np.int32),
                                                  z(1, np.int32), z(1, np.int32), **kw),
        "draw_heatmap_batched": lambda **kw: draw_heatmap_batched(z((1, 4, 4), np.float32), rb, rr,
                                                                  **kw),
        "draw_gaussians": lambda **kw: draw_gaussians(z((1, 4, 4), np.float32), z(1, bool),
                                                      z(1, np.int32), z((1, 2), np.int32),
                                                      z(1, np.float32), [1.0], 0.5, **kw),
        "start_copy": lambda **kw: start_copy([z(3, np.float32)], use_background_thread=False,
                                              **kw).get(),
        "get_pipeline": lambda **kw: _tiny_pipeline(**kw),
    }


def _tiny_pipeline(**kw):
    from accvlab_tpu_torch.bench_pipeline import build_pipeline

    p = build_pipeline(batch_size=1, num_threads=1, hw=(16, 32), num_cams=1, out_hw=(8, 16),
                       heatmap_hw=(4, 8), num_samples=2, **kw)
    p.stop()
    return p


@pytest.mark.parametrize("name", ["draw_heatmap", "draw_heatmap_batched", "draw_gaussians",
                                  "start_copy", "get_pipeline"])
def test_entry_points_default_to_cuda(name):
    fn = _entry_points()[name]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    fn(device="cpu")  # explicit CPU runs the plain versions
