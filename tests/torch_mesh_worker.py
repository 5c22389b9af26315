"""One rank of a multi-rank test of the port's ``parallel`` (launched by
``tests/test_torch_*.py`` through :func:`run_ranks`).

Usage: ``python torch_mesh_worker.py CASE RANK WORLD WORKDIR``. The rank joins
a gloo group on ``WORKDIR/store`` (a ``FileStore``), reads its inputs from
``WORKDIR/inputs.npz``, runs ``CASE`` and writes ``WORKDIR/out_RANK.npz``. It
imports the port and never JAX.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(case: str, world: int, workdir: str, timeout: float = 120.0, inputs=None):
    """Run ``case`` on ``world`` gloo ranks in fresh processes; returns each
    rank's outputs. A rank that fails or outlives ``timeout`` fails the
    caller, and every rank is killed before this returns."""
    os.makedirs(workdir, exist_ok=True)
    if inputs is not None:
        np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, str(r),
                               str(world), workdir],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    try:
        # drain every rank at once: ranks in lockstep collectives and an
        # unread pipe can block each other
        with ThreadPoolExecutor(world) as pool:
            results = list(pool.map(lambda p: p.communicate(timeout=timeout), procs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, f"rank {r} failed:\nstdout:{out}\nstderr:{err[-3000:]}"
    return [dict(np.load(os.path.join(workdir, f"out_{r}.npz"))) for r in range(world)]


# --------------------------------------------------------------------------- #
# cases (run inside a rank)                                                   #
# --------------------------------------------------------------------------- #


def case_shard(rank, world, inputs, workdir):
    """tests/multihost_worker.py's disjoint input shards and global batch,
    tests/test_ragged_sharding.py's ragged loss over the data axis, and one
    batch of the preemptible trainer's pipeline on a (data 1, model 2)
    mesh."""
    import torch
    import torch.distributed as dist
    import torch.utils._pytree as pytree

    from accvlab_tpu_torch.parallel import host_shard_info, make_mesh, shard_batch
    from accvlab_tpu_torch.pipeline import DType, SampleDataGroup
    from accvlab_tpu_torch.pipeline.inputs import (
        DataProvider,
        SampleInfo,
        ShuffledShardedInputCallable,
    )
    from accvlab_tpu_torch.ragged import (
        RaggedBatch,
        average_over_targets,
        batched_indexing_access,
    )

    shard_id, num_shards = host_shard_info()
    assert (shard_id, num_shards) == (rank, world)

    class Provider(DataProvider):
        @property
        def sample_data_structure(self):
            sdg = SampleDataGroup()
            sdg.add_data_field("x", DType.FLOAT)
            return sdg

        def get_data(self, idx):
            sdg = self.sample_data_structure
            sdg["x"] = np.full((4,), float(idx), np.float32)
            return sdg

        def get_number_of_samples(self):
            return 16

    local_batch_size = 4
    inp = ShuffledShardedInputCallable(Provider(), batch_size=local_batch_size, shuffle=True,
                                       seed=7, shard_id=shard_id, num_shards=num_shards)
    rows = [np.asarray(inp(SampleInfo(idx_in_epoch=i, idx_in_batch=i, iteration=0,
                                      epoch_idx=0))[0]) for i in range(local_batch_size)]
    mesh = make_mesh(device_type="cpu")  # (data=2, model=1)
    global_batch = shard_batch({"x": np.stack(rows)}, mesh)["x"]
    assert tuple(global_batch.shape) == (world * local_batch_size, 4)
    total = global_batch.full_tensor().sum()

    # the ragged loss of each rank's shard of the samples, summed over data
    b = inputs["classes"].shape[0] // world
    mine = slice(rank * b, (rank + 1) * b)
    rb_c = shard_batch(RaggedBatch(torch.from_numpy(inputs["classes"][mine]),
                                   sample_sizes=torch.from_numpy(inputs["sizes"][mine])), mesh)
    rb_m = shard_batch(RaggedBatch(torch.from_numpy(inputs["matches"][mine]),
                                   sample_sizes=torch.from_numpy(inputs["sizes"][mine])), mesh)
    assert tuple(rb_c.tensor.shape) == inputs["classes"].shape
    c, m = (pytree.tree_map(lambda d: d.to_local(), rb) for rb in (rb_c, rb_m))
    matched = batched_indexing_access(c, m)
    loss = average_over_targets(matched.apply(lambda x: x * x)).sum()
    dist.all_reduce(loss, group=mesh.get_group("data"))
    ids = [int(r[0]) for r in rows]

    # a (data 1, model 2) mesh: both ranks sit on one data coordinate, so
    # they read the same shard and deliver the same batch
    from accvlab_tpu_torch.parallel.mesh import data_shard_info
    from accvlab_tpu_torch.preemptible_training import build_pipeline

    model_mesh = make_mesh(1, 2, device_type="cpu")
    pipe = build_pipeline(model_mesh, 8)
    try:
        batch = pipe.run()
    finally:
        pipe.stop()
    return {"ids": np.array(sorted(ids)), "total": total.numpy(), "ragged_loss": loss.numpy(),
            "model_mesh_shard": np.array(data_shard_info(model_mesh)),
            "model_mesh_image": batch["image"].to_local().numpy(),
            "model_mesh_label": batch["label"].to_local().numpy()}


def _stage_params(mesh, inputs):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    import torch

    placements = (Replicate(), Shard(0))  # (data, pipe)
    return {k: distribute_tensor(torch.from_numpy(inputs[k]), mesh, placements).requires_grad_()
            for k in ("w", "b")}


def _stage_fn(p, x):
    import torch

    return torch.tanh(x @ p["w"] + p["b"])


def _data_sharded(mesh, a):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    import torch

    return distribute_tensor(torch.from_numpy(a), mesh, (Shard(1), Replicate()))


def case_pipeline_loss(rank, world, inputs, workdir):
    """__graft_entry__.py's pipeline-parallel stanza on (data 2, pipe 2):
    the loss and this rank's stage gradients."""
    from accvlab_tpu_torch.parallel import make_mesh_nd, pipeline_loss

    mesh = make_mesh_nd((2, 2), ("data", "pipe"), device_type="cpu")
    params = _stage_params(mesh, inputs)
    loss = pipeline_loss(params, _data_sharded(mesh, inputs["xs"]),
                         _data_sharded(mesh, inputs["tgts"]), _stage_fn,
                         lambda y, t: ((y - t) ** 2).mean(), mesh=mesh, data_spec=("data",))
    loss.backward()
    return {"loss": loss.detach().numpy(), "stage": np.array(mesh.get_local_rank("pipe")),
            "data": np.array(mesh.get_local_rank("data")),
            **{f"grad_{k}": p.grad.to_local().numpy() for k, p in params.items()}}


def case_pipeline_apply(rank, world, inputs, workdir):
    import torch

    from accvlab_tpu_torch.parallel import make_mesh_nd, pipeline_apply

    mesh = make_mesh_nd((2, 2), ("data", "pipe"), device_type="cpu")
    with torch.no_grad():
        out = pipeline_apply(_stage_params(mesh, inputs), _data_sharded(mesh, inputs["xs"]),
                             _stage_fn, mesh=mesh, data_spec=("data",))
    return {"out": out.numpy(), "stage": np.array(mesh.get_local_rank("pipe")),
            "data": np.array(mesh.get_local_rank("data"))}


def case_restore(rank, world, inputs, workdir):
    """tests/test_checkpoint_async.py's sharded cases: plain state restored
    onto a (4, 1) mesh; state saved sharded on a (2, 2) mesh restored onto
    the transposed rank layout with the transposed placements."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from accvlab_tpu_torch.models.checkpoint import restore_checkpoint, save_checkpoint
    from accvlab_tpu_torch.parallel import make_mesh, make_mesh_nd

    def template(mesh, shape, placements):
        local = torch.empty(shape, device="meta")
        return DTensor.from_local(local, mesh, placements, shape=torch.Size(shape),
                                  stride=local.stride())

    w = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    path = save_checkpoint(os.path.join(workdir, "plain"), 1, {"w": w},
                           {"mu": torch.zeros((8, 6))})
    mesh = make_mesh(device_type="cpu")  # (data 4, model 1)
    placements = (Shard(0), Replicate())
    rp, ro, _ = restore_checkpoint(path, {"params": {"w": template(mesh, (8, 6), placements)},
                                          "opt_state": {"mu": template(mesh, (8, 6),
                                                                       placements)}})
    assert rp["w"].placements == placements and ro["mu"].placements == placements
    out = {"onto_mesh_w": rp["w"].to_local().numpy(),
           "onto_mesh_full": rp["w"].full_tensor().numpy(),
           "onto_mesh_mu": ro["mu"].full_tensor().numpy()}

    w = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    mesh_a = make_mesh_nd((2, 2), ("data", "model"), device_type="cpu")
    params = {"w": distribute_tensor(w, mesh_a, (Shard(0), Shard(1)))}
    opt = {"mu": distribute_tensor(torch.zeros((8, 12)), mesh_a, (Shard(0), Replicate()))}
    path = save_checkpoint(os.path.join(workdir, "sharded"), 1, params, opt)
    # the transposed layout: ranks [[0, 2], [1, 3]], dim 0 over model and
    # dim 1 over data (JAX: P("model", "data"))
    mesh_b = make_mesh_nd((2, 2), ("data", "model"), devices=[0, 2, 1, 3], device_type="cpu")
    tgt = (Shard(1), Shard(0))
    rp, ro, _ = restore_checkpoint(path, {"params": {"w": template(mesh_b, (8, 12), tgt)},
                                          "opt_state": {"mu": template(mesh_b, (8, 12), tgt)}})
    assert rp["w"].placements == tgt and ro["mu"].placements == tgt
    return {**out, "layout_w": rp["w"].to_local().numpy(),
            "layout_full": rp["w"].full_tensor().numpy(),
            "layout_mu": ro["mu"].full_tensor().numpy(),
            "layout_coord": np.array(mesh_b.get_coordinate())}


def case_preempt(rank, world, inputs, workdir):
    """accvlab_tpu_torch.preemptible_training.main on this world (it asserts
    the bitwise resume itself)."""
    import torch

    from accvlab_tpu_torch.preemptible_training import main

    res = main(workdir=os.path.join(workdir, "ckpt"), device_type="cpu")
    return {"ref_losses": torch.stack(res["ref_losses"]).numpy(),
            "res_losses": torch.stack(res["res_losses"]).numpy(),
            **{f"pre.{k}": v.numpy() for k, v in res["pre_params"].items()},
            **{f"res.{k}": v.numpy() for k, v in res["res_params"].items()}}


def main():
    case, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
                            rank=rank, world_size=world)
    try:
        path = os.path.join(workdir, "inputs.npz")
        inputs = dict(np.load(path)) if os.path.exists(path) else {}
        out = globals()[f"case_{case}"](rank, world, inputs, workdir)
        np.savez(os.path.join(workdir, f"out_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
