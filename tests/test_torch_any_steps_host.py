"""``placement = "any"`` steps on both sides of the host/device boundary.

With no device step before them, ``ImageRange01Normalizer`` and
``ImageMeanStdDevNormalizer`` run on the host on one sample's numpy image;
after a device step they run on the batch's tensors. Both packages run the
same definitions on the same provider (two uint8 samples, made from a seed
with numpy), and the outputs agree within 1e-6 absolute (float32 scaling of
values up to 255; both sides compute in the same float32 order). The verify
recipe ImageDecoder -> ImageToTileSizePadder -> ImageRange01Normalizer runs
host-only in both, libjpeg on both sides.
"""

import io

import numpy as np
import pytest
import torch

import accvlab_tpu.pipeline as jpipe
import accvlab_tpu.pipeline.processing_steps as jsteps
import accvlab_tpu_torch.pipeline as tpipe
import accvlab_tpu_torch.pipeline.processing_steps as tsteps
from accvlab_tpu.pipeline.inputs import DataProvider as JProvider
from accvlab_tpu.pipeline.inputs import ShuffledShardedInputCallable as JInput
from accvlab_tpu_torch.pipeline.inputs import DataProvider as TProvider
from accvlab_tpu_torch.pipeline.inputs import ShuffledShardedInputCallable as TInput

ATOL = 1e-6
IMAGES = np.random.default_rng(8).integers(0, 256, (4, 6, 10, 3), np.uint8)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jpeg(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return np.frombuffer(buf.getvalue(), np.uint8).copy()


JPEGS = [_jpeg(np.random.default_rng(i).integers(0, 256, (21, 30, 3), np.uint8))
         for i in range(4)]


def _provider(base, pkg, jpeg: bool):
    class Provider(base):
        @property
        def sample_data_structure(self):
            sdg = pkg.SampleDataGroup()
            sdg.add_data_field("image", pkg.DType.UINT8)
            sdg.add_data_field("idx", pkg.DType.INT32)
            return sdg

        def get_data(self, i):
            sdg = self.sample_data_structure
            sdg["image"] = JPEGS[i] if jpeg else IMAGES[i]
            sdg["idx"] = i
            return sdg

        def get_number_of_samples(self):
            return 4

    return Provider()


class _JaxDeviceNoop(jsteps.PipelineStepBase):
    placement = "device"

    def _check_and_adjust_data_format_input_to_output(self, data_empty):
        return data_empty

    def _process(self, data):
        return data


class _TorchDeviceNoop(tsteps.PipelineStepBase):
    placement = "device"

    def _check_and_adjust_data_format_input_to_output(self, data_empty):
        return data_empty

    def _process(self, data):
        return data


def _run_both(make_steps, device_side: bool, jpeg: bool = False, batches: int = 2):
    out = {}
    for name, pkg, steps_mod, base, inp_cls, noop in (
        ("jax", jpipe, jsteps, JProvider, JInput, _JaxDeviceNoop),
        ("torch", tpipe, tsteps, TProvider, TInput, _TorchDeviceNoop),
    ):
        steps = ([noop()] if device_side else []) + make_steps(steps_mod, name)
        inp = inp_cls(_provider(base, pkg, jpeg), batch_size=2, shuffle=False)
        kw = {"device": "cpu"} if name == "torch" else {}
        pipe = pkg.PipelineDefinition(inp, steps).get_pipeline(batch_size=2, num_threads=2,
                                                               seed=0, **kw)
        if name == "torch":
            host, dev = pipe._host_steps, pipe._device_steps
            assert (len(dev) == len(steps)) if device_side else (not dev and host)
        try:
            out[name] = [{k: np.asarray(v) for k, v in pipe.run().items()}
                         for _ in range(batches)]
        finally:
            pipe.stop()
    return out


def _assert_close(out):
    for j, t in zip(out["jax"], out["torch"]):
        assert set(j) == set(t)
        for k in j:
            assert j[k].shape == t[k].shape and j[k].dtype == t[k].dtype, k
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=ATOL, err_msg=k)


NORMALIZERS = {
    "range01": lambda s, _: [s.ImageRange01Normalizer("image")],
    "mean_std": lambda s, _: [s.ImageMeanStdDevNormalizer("image", 100.0, 50.0)],
    "mean_std_per_channel": lambda s, _: [
        s.ImageMeanStdDevNormalizer("image", [103.5, 116.3, 123.7], [57.4, 57.1, 58.4])],
}


@pytest.mark.parametrize("name", sorted(NORMALIZERS))
def test_normalizer_alone_runs_on_the_host_as_in_jax(name):
    _assert_close(_run_both(NORMALIZERS[name], device_side=False))


@pytest.mark.parametrize("name", sorted(NORMALIZERS))
def test_normalizer_after_a_device_step_runs_on_tensors_as_in_jax(name):
    _assert_close(_run_both(NORMALIZERS[name], device_side=True))


def test_host_step_receives_numpy_and_device_step_tensors():
    seen = []

    class Spy(tsteps.ImageRange01Normalizer):
        def _process(self, data):
            seen.append(type(data["image"]))
            return super()._process(data)

    def steps(s, name):
        return [Spy("image") if name == "torch" else s.ImageRange01Normalizer("image")]

    _run_both(steps, device_side=False, batches=1)
    assert seen and set(seen) == {np.ndarray}  # one sample per call, prefetch included
    seen.clear()
    _run_both(steps, device_side=True, batches=1)
    assert seen == [torch.Tensor]  # the batch, once


def test_verify_recipe_decode_pad_normalize_host_only_matches_jax():
    from accvlab_tpu_torch.pipeline import native_jpeg

    assert native_jpeg.available()

    def steps(s, name):
        kw = {"decoder": "auto"} if name == "torch" else {}
        return [s.ImageDecoder("image", **kw), s.ImageToTileSizePadder("image", 8),
                s.ImageRange01Normalizer("image")]

    out = _run_both(steps, device_side=False, jpeg=True)
    assert out["torch"][0]["image"].shape == (2, 24, 32, 3)
    assert (out["torch"][0]["image"][:, 21:] == 0).all()
    _assert_close(out)
