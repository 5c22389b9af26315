"""Sharded serving artifacts on a mesh of one gloo rank: the counterparts of
``tests/test_serving_export.py::test_mesh_and_shardings_must_pair``,
``::test_sharded_export_rebinds_to_fresh_mesh`` and
``::test_polymorphic_sharded_combination_rejected``, and of a mesh
pipeline's exported device stage (``accvlab_tpu/pipeline/pipeline.py:1242``).

A sharded artifact holds the rank-local program; on one rank it is the whole
function, so its outputs are bitwise the unsharded artifact's, and the mesh
pipeline's exported stage is bitwise its eager stage. Several ranks (rebinding
onto permuted ranks, the model-parallel artifact through the server, the
refusal of a function that needs a collective) run in
``tests/test_torch_multirank_serving.py``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

import jax

from accvlab_tpu.models.centernet import CenterNetDetector as JaxDetector
from accvlab_tpu_torch.models import InferenceServer
from accvlab_tpu_torch.models import serving as S
from accvlab_tpu_torch.models.centernet import CenterNetDetector
from accvlab_tpu_torch.models.params import load_jax_params
from accvlab_tpu_torch.models.serving import export_inference, load_inference, read_artifact_info
from accvlab_tpu_torch.parallel import make_mesh

BATCH = (Shard(0), Replicate())  # (data, model)
#: the sharded artifact against JAX's unsharded apply (the JAX test's bound)
JAX_TOL = 5e-2


@pytest.fixture
def mesh():
    """A (data 1, model 1) mesh of one gloo rank; the group is destroyed
    after the test."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield make_mesh(device_type="cpu")
    torch.set_num_threads(prev)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def detector():
    jmodel = JaxDetector(num_classes=4, width=8)
    params = jmodel.init(jax.random.PRNGKey(0), np.zeros((2, 32, 32, 3), np.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = CenterNetDetector(num_classes=4, width=8)
    load_jax_params(model, params)
    return model.eval().requires_grad_(False), jmodel, params


def _images(batch, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((batch, 32, 32, 3)).astype(np.float32))


def test_header_records_mesh_and_placements_by_axis(mesh, detector):
    model = detector[0]
    info = read_artifact_info(export_inference(model, (_images(4),), mesh=mesh,
                                               in_shardings=(BATCH,)))
    assert info["nr_devices"] == 1
    assert info["mesh"] == {"axis_names": ["data", "model"], "shape": [1, 1]}
    by_axis = {"data": "Shard(0)", "model": "Replicate()"}
    assert info["in_placements"] == [by_axis]
    assert info["in_shapes"] == [[4, 32, 32, 3]]
    assert info["constant_placements"] == []
    # heatmap, offset, size: each keeps the batch's leading dim over data
    assert info["out_placements"] == [by_axis] * 3
    assert info["out_shapes"] == [[4, 8, 8, 4], [4, 8, 8, 2], [4, 8, 8, 2]]
    assert info["batch_polymorphic"] is False and info["platforms"] == ["cuda", "cpu"]


def test_mesh_and_shardings_must_pair(mesh, detector):
    model = detector[0]
    with pytest.raises(ValueError, match="together"):
        export_inference(model, (_images(2),), mesh=mesh)
    with pytest.raises(ValueError, match="together"):
        export_inference(model, (_images(2),), in_shardings=(BATCH,))


def test_polymorphic_sharded_combination_rejected(mesh, detector):
    with pytest.raises(ValueError, match="batch_polymorphic sharded"):
        export_inference(detector[0], (_images(2),), batch_polymorphic=True, mesh=mesh,
                         in_shardings=(BATCH,))


def test_load_needs_a_mesh_of_the_exported_size(mesh, detector):
    """JAX's two load contracts, on an artifact whose header says it was
    exported on a (data 2, model 1) mesh."""
    data = export_inference(detector[0], (_images(2),), mesh=mesh, in_shardings=(BATCH,))
    header, payload = S._unpack(data)
    header.update(nr_devices=2, mesh={"axis_names": ["data", "model"], "shape": [2, 1]})
    two = S._pack(header, payload)
    with pytest.raises(ValueError, match="pass mesh="):
        load_inference(two, device="cpu")
    with pytest.raises(ValueError, match="same-size mesh"):
        load_inference(two, mesh=mesh)
    # an axis of another name is another mesh
    header.update(nr_devices=1, mesh={"axis_names": ["data", "expert"], "shape": [1, 1]})
    with pytest.raises(ValueError, match="mesh axes"):
        load_inference(S._pack(header, payload), mesh=mesh)


def test_platforms_are_checked(mesh, detector):
    model = detector[0]
    with pytest.raises(ValueError, match="platforms"):
        export_inference(model, (_images(2),), platforms=("tpu",))
    art = export_inference(model, (_images(2),), platforms=("cpu",), mesh=mesh,
                           in_shardings=(BATCH,))
    assert read_artifact_info(art)["platforms"] == ["cpu"]
    header, payload = S._unpack(art)
    header["platforms"] = ["cuda"]
    with pytest.raises(ValueError, match="exported for"):
        load_inference(S._pack(header, payload), mesh=mesh)


def test_one_rank_export_rebinds_to_fresh_mesh_bitwise(mesh, detector):
    """Exported on one mesh, loaded on a fresh one: DTensor outputs, Shard(0)
    over data, bitwise the unsharded artifact's, and within JAX's bound of
    JAX's unsharded apply."""
    model, jmodel, params = detector
    x = _images(4, seed=3)
    sharded = export_inference(model, (_images(4),), mesh=mesh, in_shardings=(BATCH,))
    plain = load_inference(export_inference(model, (_images(4),)), device="cpu")(x)
    fresh = make_mesh(device_type="cpu")
    assert fresh is not mesh
    serve = load_inference(sharded, mesh=fresh)
    for inputs in (x, x.numpy(), DTensor.from_local(x, fresh, BATCH, run_check=False)):
        got = serve(inputs)
        assert sorted(got) == sorted(plain)
        for k, v in got.items():
            assert isinstance(v, DTensor) and v.placements == BATCH
            assert torch.equal(v.to_local(), plain[k]), k
    # loaded without a mesh (one rank): plain tensors, the same bits
    alone = load_inference(sharded, device="cpu")(x)
    assert all(torch.equal(alone[k], plain[k]) for k in plain)
    want = jmodel.apply(params, x.numpy())
    for k in want:
        ref = np.asarray(want[k])
        err = np.abs(got[k].to_local().numpy() - ref).max()
        assert err <= JAX_TOL * max(1.0, np.abs(ref).max()), (k, err)


def test_sharded_constant_on_one_rank(mesh):
    """A DTensor constant (JAX's w_sharded): recorded by axis, saved whole,
    and fed to the program as this rank's shard."""
    from accvlab_tpu_torch.parallel._collectives import from_full

    w = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    w_sharded = from_full(w, mesh, (Replicate(), Shard(1)))
    art = export_inference(lambda x: {"y": x @ w_sharded}, (np.zeros((2, 4), np.float32),),
                           mesh=mesh, in_shardings=((Replicate(), Replicate()),))
    info = read_artifact_info(art)
    assert info["constant_placements"] == [{"data": "Replicate()", "model": "Shard(1)"}]
    assert info["out_placements"] == [{"data": "Replicate()", "model": "Replicate()"}]
    x = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 1]])
    got = load_inference(art, mesh=make_mesh(device_type="cpu"))(x)["y"]
    assert torch.equal(got.full_tensor(), x @ w)


def test_server_serves_a_sharded_artifact_on_one_rank(mesh, detector):
    """from_artifact(mesh=): the export batch is the one bucket, a lone
    request is padded to it, and the gathered outputs fan out."""
    model = detector[0]
    art = export_inference(model, (_images(2),), mesh=mesh, in_shardings=(BATCH,))
    x = _images(2, seed=5)
    want = load_inference(art, device="cpu")(x)
    with InferenceServer.from_artifact(art, mesh=make_mesh(device_type="cpu"),
                                       max_delay_ms=2000.0) as server:
        assert server._buckets == (2,)
        f0, f1 = server.submit(x[0]), server.submit(x[1])
        lone = server.infer(x[1], timeout=60)
        got = [f0.result(60), f1.result(60)]
    for i, out in enumerate(got):
        for k in want:
            assert not isinstance(out[k], DTensor)
            assert torch.equal(out[k], want[k][i: i + 1]), k
    assert all(torch.equal(lone[k], want[k][1:2]) for k in want)


def test_mesh_pipeline_device_program_bitwise_eager_stage(mesh):
    """bench.py's device stage (DCT wire, small sizes) of a mesh pipeline:
    exported with Shard(0) over data, replayed through load_inference(mesh=)
    on the rank's leaves, bitwise run_device_stage, as DTensors."""
    from accvlab_tpu_torch.bench_pipeline import build_pipeline

    pipe = build_pipeline(batch_size=2, device="cpu", num_threads=1, hw=(96, 256), num_cams=2,
                          out_hw=(64, 176), heatmap_hw=(16, 44), num_samples=16, num_unique=2,
                          mesh=mesh)
    try:
        batch = pipe.run()
        assert all(isinstance(v, DTensor) for v in batch.values())
        pipe._halt_producer()
        idx, _, _, host = pipe._produce_host_batch()
        leaves = pipe._transfer(host)
        want = pipe.run_device_stage(leaves, idx)
        data = pipe.export_device_program()
        info = read_artifact_info(data)
        by_axis = {"data": "Shard(0)", "model": "Replicate()"}
        assert info["nr_devices"] == 1 and info["mesh"]["axis_names"] == ["data", "model"]
        assert info["in_placements"] == [by_axis] * len(leaves)
        assert info["out_placements"] == [by_axis] * len(want)
        assert info["custom_ops"] == ["accvlab_tpu_torch::draw_gaussians"]
        serve = load_inference(data, mesh=make_mesh(device_type="cpu"))
        for given in (list(leaves), [DTensor.from_local(x, mesh, BATCH, run_check=False)
                                     for x in leaves]):
            got = serve(given, (0, idx))
            assert len(got) == len(want)
            for name, g, w in zip(info["pipeline_output_fields"], got, want):
                assert isinstance(g, DTensor) and g.placements == BATCH, name
                assert torch.equal(g.to_local(), w), name
        assert "accvlab_tpu_torch.draw_gaussians" in pipe.device_program_text()
    finally:
        pipe.stop()
