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
import time
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


def case_dryrun(rank, world, inputs, workdir):
    """accvlab_tpu_torch.dryrun_multichip's stanzas on this world with JAX's
    parameters and batches: each stanza's loss(es), compared gradients or
    parameters, delivered batches and local shapes, flat."""
    from accvlab_tpu_torch.dryrun_multichip import run_stanzas

    out = {}
    for name, res in run_stanzas("cpu", inputs).items():
        out[f"{name}/loss"] = np.array(res["loss"])
        out[f"{name}/losses"] = np.array(res.get("losses", [res["loss"]]))
        for key in ("grads", "params", "batches"):
            for k, v in res.get(key, {}).items():
                out[f"{name}/{key}/{k}"] = np.asarray(v)
        for k, v in res["local_shapes"].items():
            out[f"{name}/local_shapes/{k}"] = np.array(v)
    return out


def _serving_inputs(inputs):
    import torch

    return torch.from_numpy(inputs["images"]), torch.from_numpy(inputs["x"])


def case_serving(rank, world, inputs, workdir):
    """Sharded serving and expert parallelism on 4 ranks:

    * the detector exported on (data 2, model 2), rebound onto the same
      shape over the transposed rank layout; a function that needs a
      collective is refused;
    * JAX's model-parallel artifact (x @ w, w Shard(1) over model) on the
      (model 2) meshes of ranks {0, 1} and {2, 3}, served through
      InferenceServer.from_artifact(mesh=) on each pair in reverse order,
      then with the requests reaching the pair's ranks with skewed timing;
    * the MoE top-2 step on (data 2, expert 2)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from accvlab_tpu_torch.models import InferenceServer
    from accvlab_tpu_torch.models.centernet import CenterNetDetector
    from accvlab_tpu_torch.models.moe import (
        MoEClassifier,
        make_moe_shardings,
        moe_loss,
        shard_moe_params,
    )
    from accvlab_tpu_torch.models.params import load_jax_params
    from accvlab_tpu_torch.models.serving import export_inference, load_inference
    from accvlab_tpu_torch.parallel import make_mesh_nd
    from accvlab_tpu_torch.parallel._collectives import from_full
    from accvlab_tpu_torch.dryrun_multichip import _nest

    images, x = _serving_inputs(inputs)
    out = {}

    # 1. the detector, batch Shard(0) over data, rebound onto the transposed
    # rank layout (rank 1 moves from data 0 to data 1)
    model = CenterNetDetector(num_classes=4, width=8)
    load_jax_params(model, _nest(inputs, "centernet"))
    model.eval().requires_grad_(False)
    mesh = make_mesh_nd((2, 2), ("data", "model"), device_type="cpu")
    batch = (Shard(0), Replicate())
    art = export_inference(model, (images,), mesh=mesh, in_shardings=(batch,))
    fresh = make_mesh_nd((2, 2), ("data", "model"), devices=[0, 2, 1, 3], device_type="cpu")
    got = load_inference(art, mesh=fresh)(images)
    again = load_inference(art, mesh=mesh)(images)
    for k, v in got.items():
        assert isinstance(v, DTensor) and v.placements == batch
        out[f"heads/{k}"] = v.full_tensor().numpy()
        out[f"heads_same_mesh/{k}"] = again[k].full_tensor().numpy()
    out["data_index"] = np.array([mesh.get_local_rank("data"), fresh.get_local_rank("data")])
    try:
        export_inference(lambda t: t - t.mean(dim=0), (images,), mesh=mesh, in_shardings=(batch,))
        out["refused"] = np.array(False)
    except ValueError as e:
        out["refused"] = np.array("collective" in str(e))

    # 2. the model-parallel artifact through the server on (model 2) meshes:
    # ranks {0, 1} and {2, 3} each serve it, on their pair in reverse order
    w = torch.from_numpy(inputs["w"])
    mp = make_mesh_nd((2, 2), ("replica", "model"), device_type="cpu")["model"]
    w_sharded = from_full(w, mp, (Shard(1),))
    art = export_inference(lambda t: {"y": t @ w_sharded}, (np.zeros((2, 4), np.float32),),
                           mesh=mp, in_shardings=((Replicate(),),))
    served = make_mesh_nd((2, 2), ("replica", "model"), devices=[1, 0, 3, 2],
                          device_type="cpu")["model"]
    with InferenceServer.from_artifact(art, mesh=served, batch_sizes=(2,),
                                       max_delay_ms=500.0) as server:
        f0, f1 = server.submit(x[0]), server.submit(x[1])
        lone = server.infer(x[0], timeout=60)
        out["served"] = np.concatenate([f0.result(60)["y"].numpy(), f1.result(60)["y"].numpy(),
                                        lone["y"].numpy()])
    # the same requests reaching the two ranks with skewed timing: in each
    # round one rank gets the first request 0.3 s before the other three,
    # and the other rank gets all four at once
    reqs = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    leader = served.get_coordinate()[0] == 0
    skewed = []
    with InferenceServer.from_artifact(art, mesh=served, batch_sizes=(2,),
                                       max_delay_ms=20.0) as server:
        for leader_slow in (True, False):
            futs = [server.submit(reqs[0])]
            if leader == leader_slow:
                time.sleep(0.3)
            futs += [server.submit(r) for r in reqs[1:]]
            skewed += [f.result(60)["y"].numpy() for f in futs]
    out["skewed"] = np.concatenate(skewed)
    try:
        InferenceServer.from_artifact(art, mesh=served, batch_sizes=(2,), pipeline_depth=2)
        out["depth_refused"] = np.array(False)
    except ValueError as e:
        out["depth_refused"] = np.array("pipeline_depth=1" in str(e))

    # 3. MoE top-2 on (data 2, expert 2): loss and the expert gradients
    em = make_mesh_nd((2, 2), ("data", "expert"), device_type="cpu")
    moe = MoEClassifier(num_experts=8, dim=16, num_classes=5, num_selected=2)
    load_jax_params(moe, _nest(inputs, "moe"))
    full = {"tokens": torch.from_numpy(inputs["moe_tokens"]),
            "labels": torch.from_numpy(inputs["moe_labels"])}
    params_sh, batch_sh = make_moe_shardings(em, moe, full)
    shard_moe_params(moe, em, params_sh)
    loss = moe_loss(moe, {k: from_full(v, em, batch_sh[k]) for k, v in full.items()})
    loss.backward()
    sw = moe.switch
    out["moe_loss"] = loss.detach().numpy()
    for name, p in (("w_in", sw.w_in), ("w_out", sw.w_out), ("router", sw.router.weight),
                    ("dense_0", moe.dense_0.weight)):
        out[f"moe_grad/{name}"] = p.grad.full_tensor().numpy()
    out["moe_local_experts"] = np.array(sw.w_in.to_local().shape[0])
    return out


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
