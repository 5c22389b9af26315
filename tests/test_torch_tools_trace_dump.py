"""The port's ``TraceRangeWrapper`` and ``TensorDumper`` against the JAX
package's, on the CPU.

Trace ranges: the disabled wrapper is a no-op; the range-order checks raise
the JAX wrapper's assertions, message for message; every range (and the
handle-based free functions' ranges) shows in a ``torch.profiler`` trace
(``enable()`` defaulting to the card is in ``tests/test_torch_import.py``).

TensorDumper: the same data (numpy inputs, as JAX arrays on one side and
torch tensors on the other) dumped by each package gives the same files:
the JSON documents equal key for key and the ``.npy``, ``.meta.json`` and
pickle side files byte for byte, for every dump type, RaggedBatch dumping in
both modes, custom converters and gradients; a dump written by either
package compares clean in the other (image entries are not read back by
either, and report "one side is null" in both); a mismatch is reported with
the JAX package's error text. bfloat16 crosses as JSON (a bfloat16 ``.npy`` loads
back as raw 2-byte items in numpy, so the JAX package cannot compare its
own bfloat16 BINARY dumps; the port reads them through the side file's
recorded dtype).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accvlab_tpu.tools as jtools
import accvlab_tpu_torch.tools as ttools
from accvlab_tpu.ragged import RaggedBatch as JRB
from accvlab_tpu_torch.ragged import RaggedBatch as TRB


@pytest.fixture(autouse=True)
def _fresh_singletons():
    for m in (jtools, ttools):
        m.TensorDumper._reset_singleton()
        m.TraceRangeWrapper._reset_singleton()
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    for m in (jtools, ttools):
        m.TensorDumper._reset_singleton()
        m.TraceRangeWrapper._reset_singleton()


# --------------------------------------------------------------------- #
# trace ranges                                                          #
# --------------------------------------------------------------------- #


def _enabled(mod, **kw):
    w = mod.TraceRangeWrapper()
    if mod is ttools:
        kw["device"] = "cpu"
    w.enable(**kw)
    return w


def _assertion(fn):
    try:
        fn()
    except AssertionError as e:
        return str(e)
    return None


ORDER_CASES = {
    "out_of_order_pop": lambda w: (w.range_push("a"), w.range_push("b"), w.range_pop("a")),
    "pop_without_push": lambda w: w.range_pop("a"),
    "disable_with_open_range": lambda w: (w.range_push("a"), w.disable()),
}


@pytest.mark.parametrize("name", sorted(ORDER_CASES))
def test_range_order_checks_raise_as_in_jax(name):
    want = _assertion(lambda: ORDER_CASES[name](_enabled(jtools, keep_track_of_range_order=True)))
    got = _assertion(lambda: ORDER_CASES[name](_enabled(ttools, keep_track_of_range_order=True)))
    assert want is not None and got == want


def test_order_is_not_checked_unless_asked():
    w = _enabled(ttools)
    w.range_push("a")
    w.range_push("b")
    w.range_pop("a")  # names are not checked
    w.range_pop()
    assert not w._stack
    w.disable()


def test_disabled_wrapper_is_a_no_op():
    w = ttools.TraceRangeWrapper()
    assert not w.is_enabled
    w.range_pop("never pushed")
    w.range_push("x")
    assert w._stack == []
    assert ttools.NVTXRangeWrapper is ttools.TraceRangeWrapper


def test_ranges_show_in_the_profiler_trace():
    from torch.profiler import ProfilerActivity, profile

    w = _enabled(ttools, sync_on_push=True, sync_on_pop=True, keep_track_of_range_order=True)
    h = ttools.register_string("free.range")
    assert h == ttools.register_string("free.range") != 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        w.range_push("outer")
        w.range_push("inner")
        torch.ones(8).sum()
        w.range_pop("inner")
        w.range_pop("outer")
        ttools.range_push(h)
        ttools.range_push(0)  # handle 0: a no-op
        ttools.range_pop()
        ttools.range_pop()
        ttools.range_pop()  # nothing open: a no-op
    names = {e.key for e in prof.key_averages()}
    assert {"outer", "inner", "free.range"} <= names
    w.disable()


# --------------------------------------------------------------------- #
# TensorDumper                                                          #
# --------------------------------------------------------------------- #

def T(mod, name):
    """The dump type ``name`` of ``mod``'s TensorDumper (each package has its enum)."""
    return mod.TensorDumper.Type[name]


class Box:
    """A custom type, dumped through a registered converter."""

    def __init__(self, xy):
        self.xy = xy


def _data(kind):
    """Numpy data of one dump, with its dump type, for ``kind``."""
    rng = np.random.default_rng(abs(hash(kind)) % 1000)
    img = rng.integers(0, 255, (6, 8, 3)).astype(np.float32)
    base = {"f32": rng.normal(size=(3, 4)).astype(np.float32),
            "i32": rng.integers(-5, 5, (5,)).astype(np.int32),
            "u8": rng.integers(0, 255, (2, 3)).astype(np.uint8),
            "b": rng.random((4,)) > 0.5,
            "nested": [rng.normal(size=(2,)).astype(np.float32), {"deep": np.float32(1.5)}]}
    return {"json": (base, "JSON"), "binary": (base, "BINARY"), "pickle": (base, "PICKLE"),
            "image_rgb": ({"img": img}, "IMAGE_RGB"), "image_bgr": ({"img": img}, "IMAGE_BGR"),
            "image_i": ({"img": img[..., 0]}, "IMAGE_I")}[kind]


def _as(pkg, tree):
    """numpy leaves -> JAX arrays (pkg "jax") or torch tensors (pkg "torch")."""
    if isinstance(tree, dict):
        return {k: _as(pkg, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as(pkg, v) for v in tree]
    if isinstance(tree, Box):
        return Box(_as(pkg, tree.xy))
    arr = np.asarray(tree)
    return jnp.asarray(arr) if pkg == "jax" else torch.from_numpy(np.array(arr))


def _ragged(pkg):
    t = np.arange(12, dtype=np.float32).reshape(2, 3, 2)
    s = np.array([2, 3], np.int32)
    return (JRB(jnp.asarray(t), sample_sizes=jnp.asarray(s)) if pkg == "jax"
            else TRB(torch.from_numpy(t), sample_sizes=torch.from_numpy(s)))


def _collect(mod, pkg, td, kind, ragged_per_sample=False, perturb=None):
    """One iteration's data in package ``pkg`` (``perturb`` edits the numpy data)."""
    data, dump_type = _data(kind)
    if perturb is not None:
        perturb(data)
    td.push_range("step")
    td.push_range(lambda: "inner")
    td.add_tensor_data("values", _as(pkg, data), T(mod, dump_type),
                       dump_type_override={"i32": T(mod, "JSON")} if kind == "binary" else None,
                       exclude=["u8"] if kind == "pickle" else None)
    td.pop_range()
    td.pop_range()
    td.enable_ragged_batch_dumping(as_per_sample=ragged_per_sample)
    td.add_tensor_data("ragged", _ragged(pkg), T(mod, "JSON"))
    td.register_custom_converter(Box, lambda b: {"xy": b.xy})
    td.add_tensor_data("box", _as(pkg, Box(np.array([1.0, 2.0], np.float32))), T(mod, "JSON"))
    w = {"w": np.ones((2, 2), np.float32), "b": np.zeros(3, np.float32)}
    td.add_grad_data("layer", _as(pkg, w), T(mod, "BINARY"),
                     permute_grad_axes_override={"w": (1, 0)})
    grads = {"w": np.arange(4, dtype=np.float32).reshape(2, 2), "b": np.full(3, 0.5, np.float32)}
    # a sequence, in the order the entries were registered
    td.set_gradients(_as(pkg, [grads["w"], grads["b"]]))
    return data


def _dump(mod, pkg, path, kind, **kw):
    td = mod.TensorDumper()
    td.enable(str(path))
    _collect(mod, pkg, td, kind, **kw)
    td.dump()
    td.disable()
    mod.TensorDumper._reset_singleton()


KINDS = ["json", "binary", "pickle", "image_rgb", "image_bgr", "image_i"]


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_dumps_are_the_same_files_and_cross_compare_clean(tmp_path, kind, per_sample):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    _dump(jtools, "jax", jdir, kind, ragged_per_sample=per_sample)
    _dump(ttools, "torch", tdir, kind, ragged_per_sample=per_sample)
    with open(jdir / "dump_000000.json") as f:
        jdoc = json.load(f)
    with open(tdir / "dump_000000.json") as f:
        tdoc = json.load(f)
    assert tdoc == jdoc
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in os.listdir(jdir):
        if name.endswith((".npy", ".meta.json", ".pkl")) and not name.endswith(".png.meta.json"):
            assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    # each package compares the other's dump as the JAX package compares its
    # own: clean, but for images, which neither reads back ("one side is null")
    want = _compare_against(jtools, "jax", jdir, kind, per_sample)
    assert (want == []) == (not kind.startswith("image"))
    assert _compare_against(ttools, "torch", jdir, kind, per_sample) == want
    assert _compare_against(jtools, "jax", tdir, kind, per_sample) == want
    assert _compare_against(ttools, "torch", tdir, kind, per_sample) == want


def _compare_against(mod, pkg, ref_dir, kind, per_sample, perturb=None):
    td = mod.TensorDumper()
    td.enable(str(ref_dir.parent / f"cur_{pkg}"))
    td.set_dump_is_compare(eps_numerical_data=1e-6, num_errors_per_tensor_to_show=2,
                           compare_dir=str(ref_dir))
    _collect(mod, pkg, td, kind, ragged_per_sample=per_sample, perturb=perturb)
    errors = td.compare_to_dumped_data(eps_numerical_data=1e-6, num_errors_per_tensor_to_show=2,
                                       raise_on_error=False)
    td.disable()
    mod.TensorDumper._reset_singleton()
    return errors


def _bump(data):
    data["f32"][1, 2] += np.float32(1e-3)
    data["f32"][0, 0] = np.nextafter(data["f32"][0, 0] + np.float32(2e-6), np.float32(np.inf))
    data["i32"][3] += 1


@pytest.mark.parametrize("kind", ["json", "binary", "pickle"])
def test_mismatches_are_reported_with_the_jax_text(tmp_path, kind):
    jdir = tmp_path / "jax"
    _dump(jtools, "jax", jdir, kind)
    want = _compare_against(jtools, "jax", jdir, kind, False, perturb=_bump)
    got = _compare_against(ttools, "torch", jdir, kind, False, perturb=_bump)
    assert want and got == want


def test_compare_mode_dump_raises_the_jax_error(tmp_path):
    jdir = tmp_path / "jax"
    _dump(jtools, "jax", jdir, "binary")
    msgs = []
    for mod, pkg in ((jtools, "jax"), (ttools, "torch")):
        td = mod.TensorDumper()
        td.enable(str(tmp_path / f"cur_{pkg}"))
        td.set_dump_is_compare(1e-6, compare_dir=str(jdir))
        _collect(mod, pkg, td, "binary", perturb=_bump)
        with pytest.raises(ValueError) as e:
            td.dump()
        assert td.get_dump_count() == 1  # the iteration still advanced
        msgs.append(str(e.value))
        td.disable()
        mod.TensorDumper._reset_singleton()
    assert msgs[1] == msgs[0]


def test_missing_and_extra_entries_reported_as_in_jax(tmp_path):
    jdir = tmp_path / "jax"
    _dump(jtools, "jax", jdir, "json")
    out = []
    for mod, pkg in ((jtools, "jax"), (ttools, "torch")):
        td = mod.TensorDumper()
        td.enable(str(tmp_path / f"cur_{pkg}"))
        td.set_dump_is_compare(compare_dir=str(jdir))
        data, _ = _data("json")
        td.add_tensor_data("other", _as(pkg, data["f32"]), T(mod, "JSON"))
        out.append(td.compare_to_dumped_data(dump_count=0, raise_on_error=False))
        out.append(td.compare_to_dumped_data(dump_count=0, raise_on_error=False,
                                             allow_missing_data_in_current=True,
                                             allow_missing_data_in_previous=True))
        td.disable()
        mod.TensorDumper._reset_singleton()
    assert out[2:] == out[:2] and out[0] and out[1] == []


def test_bfloat16_crosses_as_json_and_port_binary_compares(tmp_path):
    x = np.arange(6, dtype=np.float32) / 3
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    for mod, pkg, d in ((jtools, "jax", jdir), (ttools, "torch", tdir)):
        td = mod.TensorDumper()
        td.enable(str(d))
        v = jnp.asarray(x, jnp.bfloat16) if pkg == "jax" else torch.from_numpy(x).bfloat16()
        td.add_tensor_data("bf", v, T(mod, "JSON"))
        td.add_tensor_data("bf_bin", v, T(mod, "BINARY"))
        td.dump()
        td.disable()
        mod.TensorDumper._reset_singleton()
    assert json.loads((tdir / "dump_000000.json").read_text()) == \
        json.loads((jdir / "dump_000000.json").read_text())
    name = "[dump_000000.json]bf_bin.npy"
    assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
    td = ttools.TensorDumper()
    td.enable(str(tmp_path / "cur"))
    td.set_dump_is_compare(compare_dir=str(jdir))  # the JAX package's bfloat16 dump
    td.add_tensor_data("bf", torch.from_numpy(x).bfloat16(), T(ttools, "JSON"))
    td.add_tensor_data("bf_bin", torch.from_numpy(x).bfloat16(), T(ttools, "BINARY"))
    assert td.compare_to_dumped_data(dump_count=0, raise_on_error=False) == []
    td.disable()


def test_dump_counts_and_after_count_actions(tmp_path):
    td = ttools.TensorDumper()
    td.enable(str(tmp_path))
    fired = []
    td.perform_after_dump_count(2, lambda: fired.append(td.get_dump_count()))
    for _ in range(3):
        td.add_tensor_data("x", torch.ones(2), T(ttools, "JSON"))
        td.dump()
    assert fired == [2] and td.get_dump_count() == 3
    assert sorted(os.listdir(tmp_path)) == [f"dump_{i:06d}.json" for i in range(3)]
    td.reset_dump_count()
    assert td.get_dump_count() == 0
    with pytest.raises(RuntimeError, match="already enabled"):
        td.enable(str(tmp_path))
    td.disable()
