"""The port's ``parallel`` and the repaired ``start_copy`` options on a card.

Every test here needs an NVIDIA card and skips without one. No JAX is
imported, so the file runs on a card machine without it:
  python -m pytest tests/test_torch_mesh_cuda.py -q
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chip_smoke import mesh_pipeline_parallel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (meshes over NCCL, pinned staging)")
    yield torch.device("cuda", 0)
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.cuda
def test_make_mesh_is_one_nccl_rank_and_shards_on_the_card(cuda):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from accvlab_tpu_torch.parallel import host_shard_info, make_mesh, shard_batch

    mesh = make_mesh()
    assert dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1)
    assert host_shard_info(mesh) == (0, 1)
    batch = shard_batch({"x": np.arange(12, dtype=np.float64).reshape(4, 3)}, mesh)
    x = batch["x"]
    assert isinstance(x, DTensor) and x.placements == (Shard(0), Replicate())
    assert x.to_local().is_cuda and x.dtype == torch.float32
    assert torch.equal(x.full_tensor().cpu(), torch.arange(12.0).reshape(4, 3))


@pytest.mark.cuda
def test_pipeline_parallel_on_one_rank_equals_sequential(cuda):
    res = mesh_pipeline_parallel(cuda)
    assert set(res) == {"loss", "outputs", "grad_w", "grad_b"}


@pytest.mark.cuda
@pytest.mark.parametrize("align", [4, 1])
@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("pack", [True, False])
def test_start_copy_staging_options_on_the_card(cuda, pinned, pack, align):
    """Every staging option. An alignment of 1 byte in the merged chunk puts
    4-byte leaves at odd offsets: each is re-aligned by a copy, which must
    follow the chunk's copy on the copy stream; ~10 MB of small leaves keep
    that copy in flight while the caller's stream runs on."""
    from accvlab_tpu_torch.hostcopy import start_copy

    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(33,)).astype(np.float32),
            "b": rng.integers(0, 9, (7, 3)).astype(np.int32),
            "c": rng.random(5) < 0.5, "big": rng.normal(size=(300, 300)).astype(np.float32),
            "a_head": rng.integers(0, 255, (3,)).astype(np.uint8)}
    for i in range(40):
        n = 60_001 + 2 * i
        tree[f"f{i:02d}"] = rng.normal(size=(n,)).astype(np.float32)
        tree[f"i{i:02d}"] = rng.integers(-9, 9, (n // 7,)).astype(np.int32)
    for _ in range(3):
        got = start_copy(tree, cuda, pinned, pack, align, merge_dtype_chunks=True).get()
        # work on the caller's stream right after get(), as a consumer does
        seen = {k: got[k] + 0 for k in tree}
        for k, v in tree.items():
            assert got[k].is_cuda and got[k].dtype == torch.from_numpy(v).dtype
            np.testing.assert_array_equal(seen[k].cpu().numpy(), v)
            np.testing.assert_array_equal(got[k].cpu().numpy(), v)
