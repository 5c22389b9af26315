"""The 2-D detection example end to end: the port's
``accvlab_tpu_torch/object_detection_2d_pipeline.py`` against the JAX
example's ``build_pipeline`` (``examples/object_detection_2d_pipeline.py``)
on the CPU, at the example's own sizes (2 cameras of 372x512 JPEG, batch 4,
out 256x512, heatmaps 10x64x128), on both wires.

The two packages draw their device randomness differently (threefry
against ``torch.Generator``), so the augmentation is scripted: both device
random contexts are patched to return the same values, a quarter of the way
into each range (every coin passes, every augmentation applies: scale 0.95,
shift (-10, -10), brightness -8, hue -6, contrast 0.875 of mode 1,
saturation 0.9, channel order 3). Checked on two batches through each
package's ``StructuredOutputIterator``, as the example iterates it:

* images within 1/57 + 1e-5 on the YUV wire (its planes are bitwise
  JAX's: a uint8 step after the warp, divided by the normalizer's std of at
  least 57.1) and within 4/57.1 + 1e-5 on the DCT wire (its planes are
  within 1 of JAX's, which moves an RGB value by up to 3 levels, and the
  warp may add 1: tests/test_torch_dct_wire.py's propagated tolerance), at
  most 2 % of values differing;
* heatmaps within rtol 1e-6 (the converter's default fast exp, whose
  float32 result may differ from XLA's in the last bit, the repo's stated
  tolerance for it);
* the other fields (active, centres, offsets, sizes, ``image_hw``,
  boxes, categories, tokens) equal, the float ones within 1e-5.

Also: both example modules import without JAX.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_ATOL = {"yuv": 1 / 57 + 1e-5, "dct": 4 / 57.1 + 1e-5}
MAX_SHARE_DIFFERING = 0.02
FRACTION = 0.25


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_object_detection_2d_pipeline",
        os.path.join(REPO, "examples", "object_detection_2d_pipeline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _patch_draws(monkeypatch):
    import jax.numpy as jnp

    from accvlab_tpu.pipeline.random_context import DeviceRandomContext as J
    from accvlab_tpu_torch.pipeline.random_context import DeviceRandomContext as T

    def j_uniform(self, low=0.0, high=1.0, shape=()):
        return jnp.full(shape, low + FRACTION * (high - low), jnp.float32)

    def j_randint(self, low, high, shape=()):
        return jnp.full(shape, (low + high) // 2, jnp.int32)

    def t_uniform(self, low=0.0, high=1.0, shape=()):
        return torch.full(tuple(shape), low + FRACTION * (high - low), dtype=torch.float32,
                          device=self._device)

    def t_randint(self, low, high, shape=()):
        return torch.full(tuple(shape), (low + high) // 2, dtype=torch.int32,
                          device=self._device)

    monkeypatch.setattr(J, "uniform", j_uniform)
    monkeypatch.setattr(J, "randint", j_randint)
    monkeypatch.setattr(T, "uniform", t_uniform)
    monkeypatch.setattr(T, "randint", t_randint)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}{k}."))
    return out


def _batches(loader, pipe, n=2):
    try:
        it = iter(loader)
        return [_leaves(next(it)) for _ in range(n)]
    finally:
        pipe.stop()


@pytest.mark.parametrize("wire", ["dct", "yuv"])
def test_example_matches_jax_example(wire, monkeypatch):
    from accvlab_tpu_torch import object_detection_2d_pipeline as port

    _patch_draws(monkeypatch)
    jax_out = _batches(*_jax_example().build_pipeline(batch_size=4, wire=wire))
    loader, pipe = port.build_pipeline(batch_size=4, wire=wire, device="cpu")
    assert isinstance(loader, torch.utils.data.DataLoader) and len(loader) == 16
    torch_out = _batches(loader, pipe)
    for j, t in zip(jax_out, torch_out):
        assert set(j) == set(t)
        for name in sorted(j):
            g, w = t[name], j[name]
            assert g.shape == w.shape and g.dtype == w.dtype, name
            if name.endswith(".image"):
                np.testing.assert_allclose(g, w, rtol=0, atol=IMAGE_ATOL[wire], err_msg=name)
                assert float(np.mean(g != w)) <= MAX_SHARE_DIFFERING, name
            elif name.endswith("heatmap"):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=name)
            elif g.dtype.kind != "f":
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)
    hm = torch_out[0]["cameras.0.annotations.heatmap"]
    assert hm.shape == (4, 10, 64, 128) and hm.max() == 1.0


def test_wire_dct_without_libjpeg_raises(monkeypatch):
    from accvlab_tpu_torch import object_detection_2d_pipeline as port
    from accvlab_tpu_torch.pipeline import native_jpeg

    monkeypatch.setattr(native_jpeg, "available", lambda: False)
    monkeypatch.setattr(native_jpeg, "build_error", lambda: "no libjpeg (test)")
    with pytest.raises(RuntimeError, match="no libjpeg \\(test\\).*wire='yuv'"):
        port.build_pipeline(device="cpu")


def test_host_shard_info_without_distributed():
    from accvlab_tpu_torch.object_detection_2d_pipeline import host_shard_info

    assert host_shard_info() == (0, 1)


@pytest.mark.parametrize("module", ["accvlab_tpu_torch.object_detection_2d_pipeline",
                                    "accvlab_tpu_torch.custom_processing_step"])
def test_example_imports_and_runs_without_jax(module):
    code = (f"import sys, {module} as m\n"
            "assert 'jax' not in sys.modules\n"
            "assert not any(k.split('.')[0] == 'accvlab_tpu' for k in sys.modules)\n"
            "print('ok')\n")
    if module.endswith("custom_processing_step"):
        code += "m.main()\n"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")
