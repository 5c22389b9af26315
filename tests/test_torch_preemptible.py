"""``accvlab_tpu_torch.preemptible_training``, the counterpart of
``examples/preemptible_training.py``: CenterNet trained from the port's
mesh pipeline, checkpointed every step, preempted after step 3 and resumed;
the resumed losses and final parameters are bitwise the uninterrupted
run's, on a world of one gloo rank (in this process) and of two
(``tests/torch_mesh_worker.py``). The half-mesh stanza's counterpart: the
world-2 checkpoint's parameters restore onto a world of one, replicated,
bitwise.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from accvlab_tpu_torch.models.checkpoint import latest_checkpoint
from accvlab_tpu_torch.parallel import make_mesh
from accvlab_tpu_torch.preemptible_training import elastic_restore, main
from torch_mesh_worker import run_ranks


@pytest.fixture
def one_thread_group():
    """One torch thread; the in-process gloo group that ``make_mesh`` makes
    is destroyed after the test."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    if dist.is_initialized():
        dist.destroy_process_group()


def test_resume_is_bitwise_on_one_rank(one_thread_group, tmp_path):
    res = main(workdir=str(tmp_path), device_type="cpu")
    assert dist.get_world_size() == 1
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000003")
    ref, got = torch.stack(res["ref_losses"]), torch.stack(res["res_losses"])
    assert ref.shape == (6,) and torch.equal(ref[3:], got)
    assert torch.isfinite(ref).all() and bool(ref[-1] < ref[0])


def test_resume_is_bitwise_on_two_ranks_and_restores_onto_one(one_thread_group, tmp_path):
    outs = run_ranks("preempt", 2, str(tmp_path))
    # the ranks trained one data-parallel model: the same losses and
    # parameters on both
    for key, value in outs[0].items():
        np.testing.assert_array_equal(outs[1][key], value, err_msg=key)
    np.testing.assert_array_equal(outs[0]["ref_losses"][3:], outs[0]["res_losses"])

    # the world-2 checkpoint (step 3) onto a mesh of one rank, replicated
    path = latest_checkpoint(str(tmp_path / "ckpt"))
    params, meta = elastic_restore(make_mesh(device_type="cpu"), path)
    assert meta["step"] == 3
    keys = [k[len("pre."):] for k in outs[0] if k.startswith("pre.")]
    assert sorted(params) == sorted(keys)
    for k in keys:
        assert params[k].placements == (torch.distributed.tensor.Replicate(),) * 2
        np.testing.assert_array_equal(params[k].full_tensor().numpy(), outs[0][f"pre.{k}"],
                                      err_msg=k)
