"""The sharded serving side, MoE and the dry run on a card (one NCCL rank).

Every test here needs an NVIDIA card and skips without one. No JAX is
imported, so the file runs on a card machine without it:
  python -m pytest tests/test_torch_sharded_cuda.py -q
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (meshes over NCCL)")
    yield torch.device("cuda", 0)
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_artifact_on_one_nccl_rank_is_the_unsharded_one(cuda):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from accvlab_tpu_torch.detection_serving import seeded_detector
    from accvlab_tpu_torch.models.serving import export_inference, load_inference
    from accvlab_tpu_torch.parallel import make_mesh

    model = seeded_detector(4, 8, seed=0, device=cuda)
    images = torch.rand(4, 32, 48, 3, device=cuda)
    mesh = make_mesh()
    placements = (Shard(0), Replicate())
    art = export_inference(model, (images,), mesh=mesh, in_shardings=(placements,))
    got = load_inference(art, mesh=make_mesh())(images)
    want = load_inference(export_inference(model, (images,)))(images)
    for k, v in got.items():
        assert isinstance(v, DTensor) and v.placements == placements and v.to_local().is_cuda
        assert torch.equal(v.to_local(), want[k]), k


@pytest.mark.cuda
def test_moe_example_trains_on_the_card_without_host_syncs(cuda):
    from accvlab_tpu_torch import moe_expert_parallel_training as ex

    mesh, last, losses = ex.train(2, steps=10)
    assert tuple(mesh.shape) == (1, 1) and last < losses[0]
    model, batch, step, _ = ex.build(2, mesh=mesh)
    assert model.switch.w_in.to_local().is_cuda
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(model, batch, ex.LR)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
@pytest.mark.parametrize("stanza", ["dp_tp", "moe", "pp_tp", "fsdp"])
def test_dryrun_stanza_on_one_rank_matches_the_unsharded_step(cuda, stanza):
    from accvlab_tpu_torch import dryrun_multichip as dr

    res = dr.run_stanzas("cuda", stanzas=(stanza,))[stanza]
    dist.destroy_process_group()
    ref = dr.reference_loss(stanza, 1, cuda)
    assert np.isfinite(res["loss"])
    assert abs(res["loss"] - ref) <= 1e-4 * abs(ref)
