"""The port's device-to-host ``start_copy`` plan and layout against the JAX
package's ``start_copy(tree, device="cpu")`` (``_plan_and_copy_d2h``).

The port copies a tree's CUDA tensor leaves to the host through
``_plan_d2h`` (which leaves are packed, into which chunks, at which element
offsets), ``_layout_d2h`` (a chunk laid out on the device) and
``_copy_d2h`` (one copy per chunk or lone leaf). On the CPU the same
functions run on CPU source tensors, so each case of
``tests/test_hostcopy.py:223-390`` goes through both packages with the same
values:

* every copied leaf bitwise JAX's, in JAX's dtype and shape;
* the chunks in JAX's order, each with JAX's leaves and the bytes of JAX's
  on-device concatenation (``_get_d2h_packer``'s output, pads included);
* the leaves copied alone are the device leaves JAX fetches alone;
* host and opaque leaves pass through as the same objects.

The card's streams and events are held in ``tests/test_torch_hostcopy_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accvlab_tpu.hostcopy.async_copy as jcopy
from accvlab_tpu_torch.hostcopy.async_copy import (
    _copy_d2h,
    _flatten,
    _layout_d2h,
    _plan_d2h,
)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _is_array(x):
    return isinstance(x, (np.ndarray, jax.Array))


def _port_tree(jtree):
    """The JAX tree with every jax.Array as a CPU tensor of its values."""
    if isinstance(jtree, dict):
        return {k: _port_tree(v) for k, v in jtree.items()}
    if isinstance(jtree, (list, tuple)):
        return type(jtree)(_port_tree(v) for v in jtree)
    if isinstance(jtree, jax.Array):
        return torch.from_numpy(np.array(jtree))
    return jtree


def _jax_d2h(tree, monkeypatch, **kw):
    """JAX's copy of ``tree`` to the host and its chunks: per chunk the
    indices of its leaves (in flattening order) and the concatenation's
    bytes."""
    leaves = jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: not isinstance(x, (dict, list, tuple)))
    index = {id(leaf): i for i, leaf in enumerate(leaves)}
    chunks = []
    real = jcopy._get_d2h_packer

    def spy(spec):
        packer = real(spec)

        def run(*arrays):
            flat = packer(*arrays)
            chunks.append(([index[id(a)] for a in arrays], np.asarray(flat)))
            return flat

        return run

    monkeypatch.setattr(jcopy, "_get_d2h_packer", spy)
    out = jcopy.start_copy(tree, device="cpu", **kw).get()
    monkeypatch.undo()
    return out, leaves, chunks


def _check(jtree, monkeypatch, pack=True, align=16, max_chunk=32 << 20, background=True):
    want, jleaves, jchunks = _jax_d2h(jtree, monkeypatch, pack_cpu_tensors=pack,
                                      min_packed_alignment_bytes=align,
                                      max_packed_chunk_bytes=max_chunk,
                                      use_background_thread=background)
    tree = _port_tree(jtree)
    leaves = []
    rebuild = _flatten(tree, leaves)
    kinds, chunks = _plan_d2h(leaves, lambda x: isinstance(x, torch.Tensor), pack, align,
                              max_chunk)
    out, events = _copy_d2h(kinds, chunks, {}, True)
    assert events == []  # no card: no stream, no event
    got = rebuild(iter(out))

    # the chunks: JAX's leaves in JAX's order, the layout JAX's bytes
    assert [[i for i, _, _ in items] for _, _, items, _ in chunks] == [i for i, _ in jchunks]
    for (dtype, _, items, total), (_, flat) in zip(chunks, jchunks):
        laid = _layout_d2h(items, total)
        assert laid.dtype == dtype and laid.numel() == total == flat.size
        np.testing.assert_array_equal(laid.numpy(), flat)
        assert laid.numpy().tobytes() == flat.tobytes()
    # the lone leaves: JAX's device leaves outside every chunk
    packed = {i for ids, _ in jchunks for i in ids}
    lone = {i for i, leaf in enumerate(jleaves) if isinstance(leaf, jax.Array)} - packed
    assert {i for i, (kind, _) in enumerate(kinds) if kind == "single"} == lone

    # every leaf: copied leaves bitwise JAX's, host leaves the same objects
    flat_want = jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: not isinstance(x, (dict, list, tuple)))
    flat_got = []
    _flatten(got, flat_got)
    assert len(flat_got) == len(flat_want) == len(leaves)
    for i, (g, w, src) in enumerate(zip(flat_got, flat_want, leaves)):
        if isinstance(src, torch.Tensor):
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            assert isinstance(w, np.ndarray)
            gn = g.numpy()
            assert gn.dtype == w.dtype and gn.shape == w.shape, i
            assert gn.tobytes() == w.tobytes(), i
        else:
            assert g is src, i
            assert (w is src) if _is_array(src) else (w == src)
    return kinds, chunks


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("background", [True, False])
def test_device_to_host(pack, background, monkeypatch):
    rng = np.random.default_rng(3)
    host_np = rng.normal(size=(4,)).astype(np.float32)
    tree = {
        "dev": {
            "a": jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32)),
            "b": jnp.asarray(rng.integers(0, 9, (6,)).astype(np.int32)),
        },
        "big": jnp.asarray(rng.normal(size=(600, 600)).astype(np.float32)),
        "host": host_np,
        "tag": "opaque",
        "scalar": 7,
    }
    kinds, chunks = _check(tree, monkeypatch, pack=pack, background=background)
    # a and b are of different dtypes: two groups of one leaf, each copied
    # alone, as JAX fetches them; big is over 256 KB
    assert chunks == []
    assert [k for k, _ in kinds] == ["single", "single", "single", "host", "host", "host"]


def test_device_to_host_many_small_tensors(monkeypatch):
    rng = np.random.default_rng(4)
    srcs = [rng.normal(size=(rng.integers(1, 50),)).astype(np.float32) for _ in range(64)]
    _, chunks = _check([jnp.asarray(s) for s in srcs], monkeypatch)
    assert len(chunks) == 1 and len(chunks[0][2]) == 64


def test_device_to_host_mixed_dtypes(monkeypatch):
    rng = np.random.default_rng(5)
    srcs = {
        "f32": rng.normal(size=(9,)).astype(np.float32),
        "i32": rng.integers(-5, 5, (11,)).astype(np.int32),
        "u8": rng.integers(0, 255, (13,)).astype(np.uint8),
        "bool": rng.integers(0, 2, (7,)).astype(bool),
        "f32b": rng.normal(size=(2, 3)).astype(np.float32),
        "bool2": rng.integers(0, 2, (3, 2)).astype(bool),
        "i32b": rng.integers(-5, 5, ()).astype(np.int32),
    }
    _, chunks = _check({k: jnp.asarray(v) for k, v in srcs.items()}, monkeypatch)
    assert [d for d, _, _, _ in chunks] == [torch.bool, torch.float32, torch.int32]


def test_d2h_chunking_small_max_chunk(monkeypatch):
    rng = np.random.default_rng(8)
    srcs = [rng.normal(size=(100,)).astype(np.float32) for _ in range(10)]
    _, chunks = _check([jnp.asarray(s) for s in srcs], monkeypatch, max_chunk=1024)
    # 400 bytes each (aligned to 4 elements): two leaves per 1,024-byte chunk
    assert [len(items) for _, _, items, _ in chunks] == [2] * 5


@pytest.mark.parametrize("align", [1, 16, 64, 256])
def test_d2h_alignment_honored(align, monkeypatch):
    rng = np.random.default_rng(9)
    srcs = [rng.integers(0, 255, (n,)).astype(np.uint8) for n in (1, 3, 7, 13, 64, 129)]
    _, chunks = _check([jnp.asarray(s) for s in srcs], monkeypatch, align=align)
    offsets = [off for _, _, items, _ in chunks for _, _, off in items]
    assert all(off % align == 0 for off in offsets)


def test_d2h_alignment_with_chunk_split(monkeypatch):
    rng = np.random.default_rng(11)
    srcs = [rng.normal(size=(int(rng.integers(1, 60)),)).astype(np.float32)
            for _ in range(24)]
    _, chunks = _check([jnp.asarray(s) for s in srcs], monkeypatch, align=64, max_chunk=512)
    assert len(chunks) > 1
    assert all(total * 4 <= 512 for _, _, _, total in chunks)


def test_d2h_zero_size_and_scalar_leaves_cross_alone(monkeypatch):
    """An empty device leaf is fetched alone (``0 < nbytes``); a 0-d leaf
    is packed with its dtype group."""
    tree = {"empty": jnp.zeros((0, 3), jnp.float32), "s": jnp.asarray(np.float32(2.5)),
            "v": jnp.arange(5, dtype=jnp.float32), "obj": None}
    kinds, chunks = _check(tree, monkeypatch)
    assert kinds[0][0] == "single" and len(chunks) == 1


def test_d2h_non_contiguous_source_is_laid_out_in_order():
    """A transposed source leaf is laid out in its logical order."""
    t = torch.arange(12, dtype=torch.int32).reshape(3, 4).t()
    u = torch.arange(5, dtype=torch.int32)
    kinds, chunks = _plan_d2h([t, u], lambda x: True, True, 16, 1 << 20)
    out, _ = _copy_d2h(kinds, chunks, {}, True)
    assert torch.equal(out[0], t) and torch.equal(out[1], u)
    assert out[0].shape == (4, 3)
