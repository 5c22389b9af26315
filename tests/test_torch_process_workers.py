"""``get_pipeline(worker_mode="process")`` on the port: spawned workers run
the input callable and the per-sample host steps.

* process mode gives the thread mode's batches bit for bit over 2 epochs
  (host randomness keyed per sample, device randomness per batch), with a
  batch-level host step left in the producer;
* a mid-epoch ``get_state`` -> fresh pipeline -> ``set_state`` in process
  mode continues bit for bit;
* leaves of 64 KiB and more come back through shared memory, and no
  segment (nor the pool's payload file in the temporary directory) is left
  after ``stop()``, after a worker's error too (which raises in the
  consumer);
* no worker initialises CUDA;
* on a mesh of one gloo rank, process mode delivers ``DTensor`` leaves whose
  full tensors are thread mode's batches, bit for bit.

Two workers and small images: the workers import torch. The providers and
steps are module-level classes, so the spawned workers can unpickle them;
this module imports no JAX, so neither do they.
"""

import glob
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from accvlab_tpu_torch.pipeline import DType, PipelineDefinition, SampleDataGroup
from accvlab_tpu_torch.pipeline.inputs import DataProvider, ShuffledShardedInputCallable
from accvlab_tpu_torch.pipeline.processing_steps import (
    ImageRange01Normalizer,
    PaddingToUniform,
    PhotoMetricDistorter,
    PipelineStepBase,
)

def _pool_files():
    """The pools' shared-memory segments and payload files."""
    return set(glob.glob("/dev/shm/avtorch*")) | set(
        glob.glob(os.path.join(tempfile.gettempdir(), "avtorch*")))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class TinyProvider(DataProvider):
    """Ragged boxes and images of ``hw`` (96 KiB at 128x256: the shared
    memory path)."""

    def __init__(self, hw=(8, 12), n=8, fail_at=None):
        self._hw, self._n, self._fail_at = tuple(hw), n, fail_at

    @property
    def sample_data_structure(self):
        sdg = SampleDataGroup()
        sdg.add_data_field("image", DType.UINT8)
        sdg.add_data_field("boxes", DType.FLOAT)
        sdg.add_data_field("idx", DType.INT32)
        return sdg

    def get_data(self, i):
        if self._fail_at is not None and i % 4 == self._fail_at:
            raise ValueError("synthetic sample failure")
        rng = np.random.default_rng(i)
        sdg = self.sample_data_structure
        sdg["image"] = rng.integers(0, 256, (*self._hw, 3)).astype(np.uint8)
        sdg["boxes"] = rng.normal(size=(1 + i % 3, 4)).astype(np.float32)
        sdg["idx"] = np.int32(i)
        return sdg

    def get_number_of_samples(self):
        return self._n


class HostJitter(PipelineStepBase):
    """A host step with a per-sample draw."""

    placement = "host"

    def _check_and_adjust_data_format_input_to_output(self, data_empty):
        return data_empty

    def _process(self, data):
        data["boxes"] = data["boxes"] + self.random.uniform(-1.0, 1.0, (4,))
        return data


class CudaProbe(PipelineStepBase):
    """A host step that records whether CUDA is initialised where it runs."""

    placement = "host"

    def _check_and_adjust_data_format_input_to_output(self, data_empty):
        data_empty.add_data_field("cuda_init", DType.BOOL)
        return data_empty

    def _process(self, data):
        data.add_data_field("cuda_init", DType.BOOL)
        data["cuda_init"] = np.bool_(torch.cuda.is_initialized())
        return data


def build(worker_mode, hw=(8, 12), fail_at=None, extra=(), shuffle=True):
    inp = ShuffledShardedInputCallable(TinyProvider(hw, fail_at=fail_at), batch_size=4,
                                       shuffle=shuffle)
    steps = [HostJitter(), *extra, PaddingToUniform("boxes", fill_value=-1.0),
             ImageRange01Normalizer("image"),
             PhotoMetricDistorter("image", min_max_brightness=(-0.1, 0.1),
                                  min_max_hue=(-5.0, 5.0), min_max_contrast=(0.8, 1.2),
                                  min_max_saturation=(0.8, 1.2))]
    definition = PipelineDefinition(inp, steps, copy_external_source_passthrough_outputs=False)
    return definition.get_pipeline(batch_size=4, num_threads=2, device="cpu", seed=5,
                                   worker_mode=worker_mode)


def _epochs(pipe, n_epochs=2):
    out = []
    try:
        for e in range(n_epochs):
            if e:
                pipe.reset()
            out += [{k: v.clone() for k, v in b[0].items()} for b in pipe]
    finally:
        pipe.stop()
    return out


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert torch.equal(g[k], w[k]), k


def test_process_mode_equals_thread_mode_over_two_epochs():
    before = _pool_files()
    thread = _epochs(build("thread"))
    pipe = build("process")
    process = _epochs(pipe)
    _assert_equal(process, thread)
    assert len(process) == 4
    assert process[0]["boxes"].shape[1] == 3  # padded to the batch maximum in the producer
    assert _pool_files() == before
    with pytest.raises(ValueError, match="worker_mode"):
        PipelineDefinition(ShuffledShardedInputCallable(TinyProvider(), 4), []).get_pipeline(
            4, device="cpu", worker_mode="fork")


def test_process_mode_resume_bitwise():
    ref = _epochs(build("thread"), 1)
    pipe = build("process")
    try:
        next(pipe)
        state = json.loads(json.dumps(pipe.get_state()))
    finally:
        pipe.stop()
    fresh = build("process")
    try:
        fresh.set_state(state)
        rest = [{k: v.clone() for k, v in b[0].items()} for b in fresh]
    finally:
        fresh.stop()
    _assert_equal(rest, ref[1:])


def test_shared_memory_transport_and_cleanup():
    before = _pool_files()
    hw = (128, 256)  # 96 KiB per image: over the 64 KiB threshold
    thread = _epochs(build("thread", hw), 1)[:2]
    pipe = build("process", hw)
    try:
        process = [{k: v.clone() for k, v in pipe.run().items()} for _ in range(2)]
        assert pipe._workers is not None
    finally:
        pipe.stop()
    assert pipe._workers is None
    _assert_equal(process, thread)
    assert _pool_files() == before, "shared-memory segments left after stop()"


def test_worker_error_raises_in_the_consumer_without_leak():
    before = _pool_files()
    pipe = build("process", hw=(128, 256), fail_at=2, shuffle=False)  # sample 2 of batch 0
    try:
        with pytest.raises(RuntimeError, match="synthetic sample failure"):
            pipe.run()
    finally:
        pipe.stop()
    assert _pool_files() == before


def test_no_cuda_in_the_workers():
    pipe = build("process", extra=(CudaProbe(),))
    try:
        b = pipe.run()
    finally:
        pipe.stop()
    assert not bool(b["cuda_init"].any())


@pytest.mark.parametrize("wire", ["yuv", "dct"])
def test_bench_wires_process_equals_thread(wire):
    """bench.py's pipeline on both JPEG wires at a small size: the decoder
    (YUV) runs in the workers, the wire packers in the producer."""
    from accvlab_tpu_torch.bench_pipeline import build_pipeline

    kw = dict(batch_size=2, device="cpu", num_threads=2, hw=(48, 64), num_cams=2,
              out_hw=(32, 48), heatmap_hw=(8, 12), num_samples=6, num_unique=2, wire=wire,
              decoder="native", grouping="split12")
    outs = {}
    for mode in ("thread", "process"):
        pipe = build_pipeline(worker_mode=mode, **kw)
        outs[mode] = _epochs(pipe, 1)
        assert ("decoded_by" in pipe.stats()) == (wire == "yuv" and mode == "thread")
    _assert_equal(outs["process"], outs["thread"])


def test_bench_pipeline_on_a_mesh_process_equals_thread():
    """Process workers on a mesh of one gloo rank: every leaf a DTensor
    whose full tensor is the thread mode's unsharded batch, bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from accvlab_tpu_torch.bench_pipeline import build_pipeline
    from accvlab_tpu_torch.parallel import make_mesh

    kw = dict(batch_size=2, device="cpu", num_threads=2, hw=(64, 96), num_cams=1,
              out_hw=(32, 64), heatmap_hw=(8, 16), num_samples=16)
    before = _pool_files()
    try:
        thread = build_pipeline(**kw)
        process = build_pipeline(worker_mode="process", mesh=make_mesh(device_type="cpu"), **kw)
        try:
            for _ in range(2):
                got, want = process.run(), thread.run()
                assert set(got) == set(want)
                for name, leaf in got.items():
                    assert isinstance(leaf, DTensor), name
                    assert torch.equal(leaf.full_tensor(), want[name]), name
        finally:
            thread.stop()
            process.stop()
    finally:
        dist.destroy_process_group()
    assert _pool_files() == before
