"""``start_copy`` between the card and the host: streams, events, chunks.

A copy to the host (``device="cpu"``) of CUDA leaves that the caller's
stream is still writing must wait for those writes, and its handle must
report the copy as pending until it lands; ``get()`` returns host tensors
that hold their data. A copy to the card of torch tensor leaves must be
ordered before the caller's later work on its own stream. Small leaves
cross in one copy per chunk.

Every test here needs an NVIDIA card and skips without one. No JAX is
imported, so the file runs on a card machine without it:
    python -m pytest tests/test_torch_hostcopy_cuda.py -q
"""

import numpy as np
import pytest
import torch

from accvlab_tpu_torch.hostcopy import start_copy

# about 0.1 s of the card's clock: far longer than the host's work below
SLEEP_CYCLES = 200_000_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (copy streams and events)")
    return torch.device("cuda", 0)


def _host_tree(seed: int) -> dict:
    """Small float32, int32, uint8 and bool leaves, and one of 1 MB."""
    rng = np.random.default_rng(seed)
    tree = {f"f{i:02d}": rng.normal(size=(int(rng.integers(1, 300)),)).astype(np.float32)
            for i in range(40)}
    tree.update({f"i{i:02d}": rng.integers(-99, 99, (int(rng.integers(1, 90)), 3)).astype(
        np.int32) for i in range(20)})
    tree["u8"] = rng.integers(0, 255, (33,)).astype(np.uint8)
    tree["flags"] = rng.random(17) < 0.5
    tree["big"] = rng.normal(size=(512, 512)).astype(np.float32)
    return tree


def _written_behind_a_sleep(tree: dict, dev, stream, warm_up: bool = False) -> tuple:
    """The leaves on the card, rewritten on ``stream`` behind a sleep (each
    value ``v`` becomes ``2 v + 1``, a flag its negation); returns the
    tensors and the values they will hold. ``warm_up`` copies them to the
    host once first, so the copy under test takes its pinned and device
    blocks from the allocators' caches, not from a new allocation."""
    leaves = {k: torch.from_numpy(v).to(dev) for k, v in tree.items()}
    if warm_up:
        start_copy(leaves, device="cpu").get()
    torch.cuda.synchronize()
    want = {}
    with torch.cuda.stream(stream):
        torch.cuda._sleep(SLEEP_CYCLES)
        for k, t in leaves.items():
            if t.dtype == torch.bool:
                t.logical_not_()
                want[k] = ~tree[k]
            else:
                t.mul_(2).add_(1)
                want[k] = (tree[k] * 2 + 1).astype(tree[k].dtype)
    return leaves, want


@pytest.mark.cuda
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("background", [True, False])
def test_d2h_waits_for_the_callers_stream_and_lands_before_get_returns(cuda, pack, background):
    stream = torch.cuda.Stream(cuda)
    leaves, want = _written_behind_a_sleep(_host_tree(0), cuda, stream)
    tree = {"dev": leaves, "host": np.arange(4.0), "tag": "opaque", "n": 7}
    with torch.cuda.stream(stream):
        got = start_copy(tree, device="cpu", pack_cpu_tensors=pack,
                         use_background_thread=background).get()
    # read at once, with no synchronisation of our own
    for k, v in want.items():
        g = got["dev"][k]
        assert g.device.type == "cpu" and g.dtype == leaves[k].dtype
        np.testing.assert_array_equal(g.numpy(), v, err_msg=k)
    assert got["host"] is tree["host"] and got["tag"] == "opaque" and got["n"] == 7


@pytest.mark.cuda
def test_d2h_ready_is_false_while_the_sleep_runs(cuda):
    stream = torch.cuda.Stream(cuda)
    leaves, want = _written_behind_a_sleep(_host_tree(1), cuda, stream, warm_up=True)
    with torch.cuda.stream(stream):
        handle = start_copy(leaves, device="cpu", use_background_thread=False)
    assert not handle.ready()  # the copy waits for the sleep on the caller's stream
    got = handle.get()
    assert handle.ready()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.cuda
def test_h2d_tensor_leaves_reach_a_non_default_caller_stream(cuda):
    """Pinned CPU tensor leaves cross on the copy stream, not on the
    background thread's stream (here held by a sleep), and the caller's
    stream waits for them."""
    rng = np.random.default_rng(2)
    src = {f"t{i}": torch.from_numpy(rng.normal(size=(4096,)).astype(np.float32)).pin_memory()
           for i in range(8)}
    src["ints"] = torch.from_numpy(rng.integers(0, 99, (999,)).astype(np.int32)).pin_memory()
    tree = {"tensors": src, "np": rng.normal(size=(50,)).astype(np.float32)}
    stream = torch.cuda.Stream(cuda)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)  # the default stream is busy
    with torch.cuda.stream(stream):
        got = start_copy(tree, cuda).get()
        seen = {k: got["tensors"][k] + 0 for k in src}
        seen_np = got["np"] * 1
    stream.synchronize()
    for k, v in src.items():
        assert got["tensors"][k].is_cuda
        assert torch.equal(seen[k].cpu(), v), k
    np.testing.assert_array_equal(seen_np.cpu().numpy(), tree["np"])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_h2d_cuda_tensor_leaf_moved_after_the_callers_writes(cuda):
    """CUDA leaves written by the caller's stream behind a sleep, beside a
    numpy leaf: the copy stream waits for the caller's event before it
    takes the leaves (on their own device: no copy), and the caller's
    stream reads them after ``get()``."""
    stream = torch.cuda.Stream(cuda)
    leaves, want = _written_behind_a_sleep(_host_tree(3), cuda, stream)
    with torch.cuda.stream(stream):
        got = start_copy({"dev": leaves, "np": np.ones(3, np.float32)}, cuda).get()
        seen = {k: got["dev"][k].clone() for k in leaves}
    stream.synchronize()
    for k, v in want.items():
        np.testing.assert_array_equal(seen[k].cpu().numpy(), v, err_msg=k)


@pytest.mark.cuda
def test_d2h_one_device_to_host_copy_per_chunk(cuda):
    """40 small float32 leaves (one chunk), 20 small int32 leaves (one
    chunk), a lone uint8 leaf, a lone bool leaf and one of 1 MB: five
    device-to-host copies, each leaf bitwise its own ``.cpu()``."""
    from accvlab_tpu_torch.tools.launch_counts import kernel_counts

    tree = {k: torch.from_numpy(v).to(cuda) for k, v in _host_tree(4).items()}
    want = {k: v.cpu() for k, v in tree.items()}
    got = start_copy(tree, device="cpu").get()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    counts = kernel_counts(lambda: start_copy(tree, device="cpu").get(),
                           names=("Memcpy DtoH",))
    assert counts["named"]["Memcpy DtoH"] == 5, counts
    unpacked = kernel_counts(lambda: start_copy(tree, device="cpu",
                                                pack_cpu_tensors=False).get(),
                             names=("Memcpy DtoH",))
    assert unpacked["named"]["Memcpy DtoH"] == len(tree), unpacked
