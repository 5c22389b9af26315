"""The port's executor on a mesh (``get_pipeline(mesh=)``), the counterpart of
``tests/test_dct_wire.py::test_dct_wire_on_mesh_pipeline``.

On a mesh of one gloo rank (``device="cpu"``) the DCT wire's planes are held
against JAX's pipeline on its 8-device mesh with the unsharded wire's own
tolerance (within 1, ``tests/test_torch_dct_wire.py``) and every delivered
leaf, a ``DTensor`` sharded over ``data``, is bitwise the port's unsharded
pipeline's. A positional call in JAX's parameter order (``..., worker_mode,
mesh, echo_factor``) builds the same pipeline in both packages. Echo with a
mid-echo resume runs on the mesh as without it (process workers on a mesh:
``tests/test_torch_process_workers.py``).
"""

import io

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

import accvlab_tpu.parallel as jpar
import accvlab_tpu.pipeline as jpipe
import accvlab_tpu.pipeline.processing_steps as jsteps
import accvlab_tpu_torch.pipeline as tpipe
import accvlab_tpu_torch.pipeline.processing_steps as tsteps
from accvlab_tpu.pipeline.inputs import DataProvider as JDataProvider
from accvlab_tpu.pipeline.inputs import ShuffledShardedInputCallable as JInput
from accvlab_tpu_torch.bench_pipeline import build_pipeline
from accvlab_tpu_torch.parallel import make_mesh
from accvlab_tpu_torch.pipeline.inputs import DataProvider, ShuffledShardedInputCallable

SRC_HW, OUT_HW = (96, 256), (64, 176)
BATCH = 8
#: the most planes may differ (by 1) from JAX's decode (tests/test_torch_dct_wire.py)
PLANE_SHARE = 1e-3


@pytest.fixture
def mesh():
    """A mesh of one gloo rank; the group is destroyed after the test."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield make_mesh(device_type="cpu")
    torch.set_num_threads(prev)
    dist.destroy_process_group()


def make_jpeg(seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (SRC_HW[0] // 8, SRC_HW[1] // 8, 3), np.uint8)
    img = Image.fromarray(base).resize((SRC_HW[1], SRC_HW[0]), Image.BILINEAR)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=90)
    return np.frombuffer(buf.getvalue(), np.uint8).copy()


JPEGS = [make_jpeg(s) for s in range(8)]


def _provider(base, pkg):
    class Provider(base):
        @property
        def sample_data_structure(self):
            s = pkg.SampleDataGroup()
            s.add_data_field("image", pkg.DType.UINT8)
            return s

        def get_data(self, idx):
            s = self.sample_data_structure
            s["image"] = JPEGS[idx % len(JPEGS)]
            return s

        def get_number_of_samples(self):
            return len(JPEGS)

    return Provider()


def _definition(pkg, steps, inp_cls, base, rgb: bool):
    chain = [steps.DCTWirePacker("image", SRC_HW, OUT_HW),
             steps.DCTWireUnpacker("image", SRC_HW, OUT_HW)]
    if rgb:
        chain.append(steps.YCbCrToRGBConverter("image"))
    return pkg.PipelineDefinition(inp_cls(_provider(base, pkg), batch_size=BATCH, shuffle=False),
                                  chain, copy_external_source_passthrough_outputs=False)


def _jax_planes():
    """JAX's pipeline on its 8-device mesh, built by a positional call in
    JAX's order: batch_size, num_threads, device, seed, prefetch_queue_depth,
    worker_mode, mesh, echo_factor."""
    defn = _definition(jpipe, jsteps, JInput, JDataProvider, rgb=False)
    pipe = defn.get_pipeline(BATCH, 2, None, 0, None, "thread", jpar.make_mesh(), 1)
    try:
        return {k: np.asarray(v) for k, v in pipe.run().items()}
    finally:
        pipe.stop()


def _torch_batch(mesh, rgb):
    defn = _definition(tpipe, tsteps, ShuffledShardedInputCallable, DataProvider, rgb=rgb)
    pipe = defn.get_pipeline(BATCH, 2, "cpu", 0, None, "thread", mesh, 1)  # JAX's order
    try:
        return pipe.run()
    finally:
        pipe.stop()


def test_dct_wire_on_mesh_pipeline(mesh):
    planes = _torch_batch(mesh, rgb=False)
    want = _jax_planes()
    assert set(planes) == set(want)
    for name, leaf in planes.items():
        assert isinstance(leaf, DTensor) and leaf.placements == (Shard(0), Replicate())
        got = leaf.full_tensor().numpy()
        assert got.shape == want[name].shape and got.dtype == want[name].dtype, name
        d = np.abs(got.astype(np.int32) - want[name].astype(np.int32))
        assert d.max() <= 1 and float(np.mean(d > 0)) <= PLANE_SHARE, name

    # the whole DCT wire with the colour conversion: bitwise the unsharded
    # pipeline's batch
    sharded = _torch_batch(mesh, rgb=True)
    unsharded = _torch_batch(None, rgb=True)
    assert set(sharded) == set(unsharded) == {"image"}
    assert tuple(sharded["image"].shape) == (BATCH,) + OUT_HW + (3,)
    assert torch.equal(sharded["image"].full_tensor(), unsharded["image"])
    assert torch.equal(sharded["image"].to_local(), unsharded["image"])


def test_mesh_pipeline_device_must_be_the_meshs(mesh):
    defn = _definition(tpipe, tsteps, ShuffledShardedInputCallable, DataProvider, rgb=True)
    with pytest.raises(ValueError, match="not the mesh's 'cpu'"):
        defn.get_pipeline(BATCH, 1, "cuda", mesh=mesh)


SMALL = dict(batch_size=2, num_threads=2, hw=(64, 96), num_cams=1, out_hw=(32, 64),
             heatmap_hw=(8, 16), num_samples=16, device="cpu")


def _flat(out):
    return {k: (v.full_tensor() if isinstance(v, DTensor) else v) for k, v in out.items()}


def _equal(a, b):
    a, b = _flat(a), _flat(b)
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_mesh_pipeline_echo_and_resume_as_unsharded(mesh):
    """bench.py's pipeline (DCT wire, augmentation on) with echo factor 2:
    the mesh pipeline delivers the unsharded pipeline's batches bitwise, and
    a mid-echo get_state resumes bitwise on a new mesh pipeline."""
    plain = build_pipeline(echo_factor=2, **SMALL)
    sharded = build_pipeline(echo_factor=2, mesh=mesh, **SMALL)
    try:
        want = [plain.run() for _ in range(5)]
        got = [sharded.run() for _ in range(3)]
        state = sharded.get_state()
        assert all(_equal(g, w) for g, w in zip(got, want))
    finally:
        plain.stop()
        sharded.stop()
    assert state["echo"] == {"factor": 2, "next": 1}
    resumed = build_pipeline(echo_factor=2, mesh=mesh, **SMALL)
    try:
        resumed.set_state(state)
        assert all(_equal(resumed.run(), w) for w in want[3:])
        # the resumed mesh pipeline's device program is a sharded artifact
        # (tests/test_torch_sharded_serving.py replays one)
        from accvlab_tpu_torch.models.serving import read_artifact_info

        info = read_artifact_info(resumed.export_device_program())
        assert info["nr_devices"] == 1 and info["mesh"]["axis_names"] == ["data", "model"]
    finally:
        resumed.stop()
