"""Checkpoints of the port (``accvlab_tpu_torch.models.checkpoint``): the
unsharded cases of ``tests/test_checkpoint_async.py`` and the proof
obligation of ``examples/preemptible_training.py``.

The sharded restores: a ``DTensor`` template on a mesh of one gloo rank,
and ``tests/test_checkpoint_async.py``'s sharded cases on four gloo ranks
(``tests/torch_mesh_worker.py``). The preempt-and-resume case trains the
port's CenterNet on batches of the port's pipeline (random augmentation on
the device included), checkpoints every 2 steps with ``pipe.get_state()``,
"preempts" after step 3 (its progress is lost), rebuilds model, optimizer
and pipeline, restores and continues: losses and final parameters are
bitwise those of an uninterrupted run.
"""

import os

import numpy as np
import pytest
import torch

from accvlab_tpu_torch.models.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _state(k=0.0):
    return ({"w": torch.full((4, 3), 1.5 + k), "b": torch.arange(3, dtype=torch.float32) + k},
            {"mu": torch.zeros((4, 3))})


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def test_async_save_restores_identically(tmp_path):
    params, opt = _state()
    path = save_checkpoint(str(tmp_path), 7, params, opt, {"iteration": 7}, asynchronous=True)
    # the snapshot is taken before the call returns: an in-place update now
    # does not reach the file
    params["w"].add_(100.0)
    wait_for_checkpoints()
    assert latest_checkpoint(str(tmp_path)) == path
    rp, ro, meta = restore_checkpoint(path, {"params": params, "opt_state": opt})
    assert meta == {"step": 7, "pipeline": {"iteration": 7}}
    want_p, want_o = _state()
    for a, b in zip(_leaves((want_p, want_o)), _leaves((rp, ro))):
        assert torch.equal(a, b)


def test_retention_keeps_newest(tmp_path):
    for step in range(1, 5):
        params, opt = _state(float(step))
        save_checkpoint(str(tmp_path), step, params, opt, keep=2)
    wait_for_checkpoints()
    dirs = sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_") and os.path.isdir(tmp_path / d))
    assert dirs == ["step_00000003", "step_00000004"]
    metas = sorted(f for f in os.listdir(tmp_path) if f.endswith(".meta.json"))
    assert metas == ["step_00000003.meta.json", "step_00000004.meta.json"]
    path = latest_checkpoint(str(tmp_path))
    rp, _, meta = restore_checkpoint(path, dict(zip(("params", "opt_state"), _state())))
    assert meta["step"] == 4
    assert torch.equal(rp["w"], torch.full((4, 3), 5.5))


def test_async_retention_counts_the_save_being_written(tmp_path):
    for step in range(1, 4):
        params, opt = _state(float(step))
        save_checkpoint(str(tmp_path), step, params, opt, asynchronous=True, keep=2)
    wait_for_checkpoints()
    assert sorted(d for d in os.listdir(tmp_path) if os.path.isdir(tmp_path / d)) == [
        "step_00000002", "step_00000003"]


@pytest.fixture
def cpu_group():
    """The in-process group of one gloo rank that ``make_mesh`` makes,
    destroyed after the test."""
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_sharded_restore_waits_for_parallel(tmp_path, cpu_group):
    """(Named when the sharded restore waited for ``parallel``.) A
    ``DTensor`` template leaf restores onto its own mesh and placements,
    bitwise; a template on the meta device will do."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from accvlab_tpu_torch.parallel import make_mesh

    params, opt = _state()
    path = save_checkpoint(str(tmp_path), 1, params, opt)
    mesh = make_mesh(device_type="cpu")
    template = {"params": {"w": distribute_tensor(torch.empty(4, 3), mesh, (Shard(0), Replicate())),
                           "b": params["b"]},
                "opt_state": {"mu": DTensor.from_local(torch.empty((4, 3), device="meta"), mesh,
                                                       (Replicate(), Replicate()))}}
    rp, ro, _ = restore_checkpoint(path, template)
    assert isinstance(rp["w"], DTensor) and rp["w"].placements == (Shard(0), Replicate())
    assert ro["mu"].placements == (Replicate(), Replicate()) and ro["mu"].device.type == "cpu"
    assert torch.equal(rp["w"].full_tensor(), params["w"])
    assert torch.equal(ro["mu"].full_tensor(), opt["mu"])
    assert not isinstance(rp["b"], DTensor) and torch.equal(rp["b"], params["b"])
    # a DTensor is saved as its full tensor: the file restores without a mesh
    path = save_checkpoint(str(tmp_path), 2, rp, ro)
    rp2, _, _ = restore_checkpoint(path, {"params": params, "opt_state": opt})
    assert torch.equal(rp2["w"], params["w"])


def test_inflight_tmp_is_never_listed_or_collected(tmp_path):
    """An in-flight save lives under a temporary name in the checkpoint
    directory: an orphaned one is never returned by latest_checkpoint and
    never counts toward ``keep``."""
    params, opt = _state()
    committed = save_checkpoint(str(tmp_path), 7, params, opt)
    orphan = tmp_path / "step_00000008.accvlab-checkpoint-tmp"
    orphan.mkdir()
    (orphan / "partial").write_text("x")

    assert latest_checkpoint(str(tmp_path)) == committed
    save_checkpoint(str(tmp_path), 9, params, opt, keep=1)
    wait_for_checkpoints()
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000009")
    dirs = set(os.listdir(tmp_path))
    assert "step_00000009" in dirs and "step_00000007" not in dirs
    assert orphan.is_dir()  # cleanup is the owner's call, not GC's


def test_restore_places_tensors_where_the_template_lies(tmp_path):
    params, opt = _state()
    path = save_checkpoint(str(tmp_path), 1, params, opt)
    template = {"params": {"w": torch.empty((4, 3), device="meta"), "b": torch.zeros(3)},
                "opt_state": opt}
    rp, _, _ = restore_checkpoint(path, template)
    assert rp["w"].device.type == "meta" and rp["b"].device.type == "cpu"
    with pytest.raises(ValueError, match="structure"):
        restore_checkpoint(path, {"params": {"w": params["w"]}, "opt_state": opt})


# --------------------------------------------------------------------------- #
# preempt and resume                                                          #
# --------------------------------------------------------------------------- #

STEPS, EVERY, PREEMPT_AFTER = 6, 2, 3


def _trainer():
    from accvlab_tpu_torch.models.centernet import CenterNetDetector, make_train_step
    from accvlab_tpu_torch.train_centernet_e2e import build_train_pipeline

    pipe = build_train_pipeline(batch_size=2, device="cpu", num_threads=1, hw=(64, 96),
                                num_cams=1, out_hw=(32, 64), heatmap_hw=(8, 16),
                                num_samples=16)
    init_fn, step = make_train_step(CenterNetDetector(num_classes=10, width=8))
    model, opt = init_fn(0, torch.zeros((2, 32, 64, 3)), device="cpu")
    return pipe, model, opt, step


def _run(pipe, model, opt, step, first, last, ckpt_dir=None):
    from accvlab_tpu_torch.train_centernet_e2e import batch_to_train_inputs

    losses = []
    for i in range(first, last + 1):
        _, _, metrics = step(model, opt, batch_to_train_inputs(pipe.run()))
        losses.append(metrics["loss"].clone())
        if ckpt_dir is not None and i % EVERY == 0:
            save_checkpoint(ckpt_dir, i, model.state_dict(), opt.state_dict(), pipe.get_state(),
                            asynchronous=True, keep=2)
    return losses


def test_preempt_and_resume_is_bitwise(tmp_path):
    pipe, model, opt, step = _trainer()
    try:
        want_losses = _run(pipe, model, opt, step, 1, STEPS)
    finally:
        pipe.stop()
    want_params = {k: v.clone() for k, v in model.state_dict().items()}

    ckpt = str(tmp_path)
    pipe, model, opt, step = _trainer()
    try:
        got = _run(pipe, model, opt, step, 1, PREEMPT_AFTER, ckpt)  # step 3's work is lost
    finally:
        pipe.stop()
    wait_for_checkpoints()

    pipe, model, opt, step = _trainer()  # a new process would start here
    try:
        path = latest_checkpoint(ckpt)
        params, opt_state, meta = restore_checkpoint(
            path, {"params": model.state_dict(), "opt_state": None})
        assert meta["step"] == 2 and path.endswith("step_00000002")
        model.load_state_dict(params)
        opt.load_state_dict(opt_state)
        pipe.set_state(meta["pipeline"])
        got = got[:meta["step"]] + _run(pipe, model, opt, step, meta["step"] + 1, STEPS)
    finally:
        pipe.stop()
    assert len(got) == STEPS
    for i, (g, w) in enumerate(zip(got, want_losses)):
        assert torch.equal(g, w), f"step {i + 1}: {float(g)} != {float(w)}"
    for k, v in model.state_dict().items():
        assert torch.equal(v, want_params[k]), k
    assert np.isfinite([float(x) for x in got]).all()


# --------------------------------------------------------------------------- #
# sharded save and restore on four gloo ranks                                 #
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def four_rank_restore(tmp_path_factory):
    """One run of four gloo ranks (``tests/torch_mesh_worker.py``) for the
    two sharded cases of ``tests/test_checkpoint_async.py``."""
    from torch_mesh_worker import run_ranks

    return run_ranks("restore", 4, str(tmp_path_factory.mktemp("restore")))


def test_sharded_restore_onto_mesh(four_rank_restore):
    """Plain state restored onto DTensor templates sharded over the data
    axis of a (4, 1) mesh: each rank holds its rows, the whole is bitwise."""
    w = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    for rank, out in enumerate(four_rank_restore):
        np.testing.assert_array_equal(out["onto_mesh_w"], w[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(out["onto_mesh_full"], w)
        np.testing.assert_array_equal(out["onto_mesh_mu"], 0.0)


def test_sharded_save_restores_onto_different_mesh_layout(four_rank_restore):
    """State saved sharded on a (2, 2) mesh (rows over data, columns over
    model) restores onto the transposed rank layout with the transposed
    placements: each rank holds its block of the new layout, bitwise."""
    w = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    coords = set()
    for out in four_rank_restore:
        i, j = (int(c) for c in out["layout_coord"])  # (data, model)
        coords.add((i, j))
        np.testing.assert_array_equal(out["layout_w"], w[4 * j:4 * j + 4, 6 * i:6 * i + 6])
        np.testing.assert_array_equal(out["layout_full"], w)
        np.testing.assert_array_equal(out["layout_mu"], 0.0)
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
