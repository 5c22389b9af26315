"""The port's ``parallel`` in one process, against the JAX package on the same
inputs: the counterparts of ``tests/test_models_and_parallel.py``'s mesh
tests, ``make_fsdp_shardings`` against JAX's specs on the same shapes, and
``pipeline_loss``/``pipeline_apply`` on a (data 1, pipe 1) mesh, the card's
layout, against JAX's and the plain sequential application.

Meshes of one rank use the gloo group that ``make_mesh`` makes; mesh shapes
of 8 ranks use torch's in-process fake backend (no communication), as JAX's
tests use 8 virtual CPU devices. Every group is destroyed after its test.
Meshes of several communicating ranks: ``tests/test_torch_parallel_multirank.py``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import accvlab_tpu.parallel as J
import accvlab_tpu_torch.parallel as T


@pytest.fixture
def group():
    """One torch thread; whatever process group the test makes is
    destroyed after it."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture
def fake8(group):
    """A world of 8 ranks in this process (torch's fake backend: meshes and
    groups, no communication)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)


def _ids(jmesh):
    return np.vectorize(lambda d: d.id)(jmesh.devices)


def test_make_mesh_shapes(fake8):
    mesh = T.make_mesh(model_parallel=2, device_type="cpu")
    assert tuple(mesh.shape) == (4, 2) and mesh.mesh_dim_names == ("data", "model")
    np.testing.assert_array_equal(mesh.mesh.numpy(), _ids(J.make_mesh(model_parallel=2)))
    mesh1 = T.make_mesh(device_type="cpu")
    assert tuple(mesh1.shape) == tuple(J.make_mesh().devices.shape) == (8, 1)
    with pytest.raises(AssertionError, match="not divisible"):
        T.make_mesh(model_parallel=3, device_type="cpu")
    with pytest.raises(AssertionError, match="mesh 2x2 != 8"):
        T.make_mesh(2, 2, device_type="cpu")
    # a subset of the ranks, as JAX's devices=
    half = T.make_mesh(devices=[0, 1, 2, 3], device_type="cpu")
    assert tuple(half.shape) == (4, 1)


def test_make_mesh_nd(fake8):
    mesh = T.make_mesh_nd((2, 2, 2), ("data", "seq", "model"), device_type="cpu")
    jmesh = J.make_mesh_nd((2, 2, 2), ("data", "seq", "model"))
    assert mesh.mesh_dim_names == jmesh.axis_names
    assert tuple(mesh.shape) == jmesh.devices.shape
    # row-major rank order (JAX orders by the ICI topology, which ranks lack)
    np.testing.assert_array_equal(mesh.mesh.numpy(), np.arange(8).reshape(2, 2, 2))
    with pytest.raises(AssertionError, match="one axis name"):
        T.make_mesh_nd((2, 4), ("data",), device_type="cpu")


def test_make_mesh_nd_runs_a_sharded_computation(group):
    """The JAX test's computation over three axes, on the one-rank mesh."""
    mesh = T.make_mesh_nd((1, 1, 1), ("data", "seq", "model"), device_type="cpu")
    x = torch.arange(2 * 4 * 8, dtype=torch.float32).reshape(2, 4, 8)
    xs = distribute_tensor(x, mesh, (Shard(0), Shard(1), Shard(2)))
    assert float((xs * 2).sum().full_tensor()) == float(x.sum() * 2)


def test_shard_batch_places_on_mesh(group):
    mesh = T.make_mesh(device_type="cpu")
    batch = {"x": np.arange(16 * 3, dtype=np.float32).reshape(16, 3),
             "f64": np.linspace(0, 1, 16)}
    out = T.shard_batch(batch, mesh)
    want = J.shard_batch(batch, J.make_mesh())
    assert out["x"].placements == (Shard(0), Replicate())
    assert out["x"].placements == T.shard_like_batch(mesh, 2)
    assert want["x"].sharding.spec == P("data", None)
    for k in batch:
        got = out[k].full_tensor().numpy()
        assert got.dtype == np.asarray(want[k]).dtype  # float64 lands as float32
        np.testing.assert_array_equal(got, np.asarray(want[k]))
    # a tensor leaf goes as it is
    t = T.shard_batch([torch.ones(4, 2)], mesh)[0]
    assert t.to_local().device.type == "cpu" and tuple(t.shape) == (4, 2)
    with pytest.raises(ValueError, match="leading batch dim"):
        T.shard_like_batch(mesh, 0)


def test_host_shard_info(group):
    assert T.host_shard_info() == J.host_shard_info() == (0, 1)
    T.make_mesh(device_type="cpu")
    assert T.host_shard_info() == (0, 1)


def test_host_shard_info_is_the_rank(fake8):
    assert T.host_shard_info() == (0, 8)


def test_mesh_needs_a_card_unless_cpu_is_asked_for(group):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.make_mesh_nd((1,), ("data",))
    assert not dist.is_initialized()  # nothing fell back to a CPU group


FSDP_SHAPES = [(64, 1024), (1024, 64), (3,), (512, 512), (8, 8193), (256, 256, 3),
               (7, 9362), (1, 65536), (2, 3, 4), (4096,), (100, 1000)]


@pytest.mark.parametrize("axis,model_parallel,min_size", [("data", 1, 2**16),
                                                         ("data", 2, 2**16),
                                                         ("model", 2, 2**16),
                                                         ("data", 1, 16)])
def test_make_fsdp_shardings_matches_jax(fake8, axis, model_parallel, min_size):
    params = {f"p{i}": np.zeros(s, np.float32) for i, s in enumerate(FSDP_SHAPES)}
    jmesh = J.make_mesh(model_parallel=model_parallel)
    want = J.make_fsdp_shardings(params, jmesh, axis=axis, min_size=min_size)
    mesh = T.make_mesh(model_parallel=model_parallel, device_type="cpu")
    tparams = {k: torch.empty(v.shape) for k, v in params.items()}
    got = T.make_fsdp_shardings(tparams, mesh, axis=axis, min_size=min_size)
    dim = mesh.mesh_dim_names.index(axis)
    for k in params:
        spec = tuple(want[k].spec)
        placements = [Replicate(), Replicate()]
        if axis in spec:
            placements[dim] = Shard(spec.index(axis))
        assert got[k] == tuple(placements), (k, spec, got[k])


# --------------------------------------------------------------------------- #
# pipeline parallelism on the card's layout: (data 1, pipe 1)                 #
# --------------------------------------------------------------------------- #

DIM, N_MICRO, MB = 32, 6, 2


def _pp_inputs(seed=2):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(1, DIM, DIM)) * 0.2).astype(np.float32),
            "b": (rng.normal(size=(1, DIM)) * 0.05).astype(np.float32),
            "xs": rng.normal(size=(N_MICRO, MB, DIM)).astype(np.float32),
            "tgts": rng.normal(size=(N_MICRO, MB, DIM)).astype(np.float32)}


def _torch_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _torch_loss(mesh, inputs, remat=True):
    params = {k: distribute_tensor(torch.from_numpy(inputs[k]), mesh,
                                   (Replicate(), Shard(0))).requires_grad_() for k in ("w", "b")}
    loss = T.pipeline_loss(params, torch.from_numpy(inputs["xs"]),
                           torch.from_numpy(inputs["tgts"]), _torch_stage,
                           lambda y, t: ((y - t) ** 2).mean(), mesh=mesh, data_spec=("data",),
                           remat=remat)
    loss.backward()
    return loss.detach(), {k: p.grad.to_local() for k, p in params.items()}


def test_pipeline_loss_one_rank_matches_jax_and_sequential(group):
    inputs = _pp_inputs()
    mesh = T.make_mesh_nd((1, 1), ("data", "pipe"), device_type="cpu")
    loss, grads = _torch_loss(mesh, inputs)

    jmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "pipe"))

    def jloss(p):
        return J.pipeline_loss(p, inputs["xs"], inputs["tgts"],
                               lambda q, x: jnp.tanh(x @ q["w"] + q["b"]),
                               lambda y, t: jnp.mean((y - t) ** 2), mesh=jmesh,
                               data_spec=P("data"))

    with jmesh:
        want, jgrads = jax.value_and_grad(jloss)({k: inputs[k] for k in ("w", "b")})
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]), rtol=1e-5,
                                   atol=1e-7)

    # the plain sequential application of the one stage
    params = {k: torch.from_numpy(inputs[k][0]).requires_grad_() for k in ("w", "b")}
    xs, tgts = torch.from_numpy(inputs["xs"]), torch.from_numpy(inputs["tgts"])
    seq = torch.stack([((_torch_stage(params, xs[i]) - tgts[i]) ** 2).mean()
                       for i in range(N_MICRO)]).sum() / N_MICRO
    seq.backward()
    assert torch.equal(loss, seq.detach())
    for k in grads:
        assert torch.equal(grads[k][0], params[k].grad), k

    # remat changes what the backward keeps, never a value
    loss2, grads2 = _torch_loss(mesh, inputs, remat=False)
    assert torch.equal(loss, loss2)
    for k in grads:
        assert torch.equal(grads[k], grads2[k]), k


def test_pipeline_apply_one_rank_matches_jax(group):
    inputs = _pp_inputs(3)
    mesh = T.make_mesh_nd((1, 1), ("data", "pipe"), device_type="cpu")
    params = {k: torch.from_numpy(inputs[k]) for k in ("w", "b")}  # this rank's slice
    with torch.no_grad():
        got = T.pipeline_apply(params, torch.from_numpy(inputs["xs"]), _torch_stage, mesh=mesh)
    jmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "pipe"))
    with jmesh:
        want = J.pipeline_apply({k: inputs[k] for k in ("w", "b")}, inputs["xs"],
                                lambda q, x: jnp.tanh(x @ q["w"] + q["b"]), mesh=jmesh)
    assert tuple(got.shape) == (N_MICRO, MB, DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_pipeline_rejects_parameters_not_sharded_over_pipe(group):
    inputs = _pp_inputs()
    mesh = T.make_mesh_nd((1, 1), ("data", "pipe"), device_type="cpu")
    params = {k: torch.from_numpy(inputs[k]) for k in ("w", "b")}
    xs = torch.from_numpy(inputs["xs"])
    with pytest.raises(ValueError, match="leading stage dim"):
        T.pipeline_apply(params, xs, _torch_stage, mesh=mesh,
                         param_specs={"w": (Replicate(), Replicate()),
                                      "b": (Replicate(), Shard(0))})
    with pytest.raises(ValueError, match="2 stages, not 1"):
        T.pipeline_apply({"w": torch.zeros(2, DIM, DIM), "b": torch.zeros(2, DIM)}, xs,
                         _torch_stage, mesh=mesh)
