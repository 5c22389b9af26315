"""The device stage as a program (``TorchPipeline.device_program_text`` and
``export_device_program``), case by case with ``tests/test_pipeline_export.py``
and ``tests/test_pipeline_trace.py``'s two ``device_program_text`` cases.

The artifact takes the host-stage leaves and the batch key; its loader makes
the stage's random draws from the key with the recorded schedule. On the
same leaves and key it is bitwise ``run_device_stage``: on a photometric
pipeline, on an affine one whose ``Selection`` draws for every option (and
whose shift draws in per-sample tensor bounds), and on bench.py's DCT wire
(small sizes), whose heatmap step calls the registered rasterizer operator.
A replay that is handed one draw too many or too few raises.
"""

import io
import os

import numpy as np
import pytest
import torch

from accvlab_tpu_torch.models.serving import load_inference, read_artifact_info, save_inference
from accvlab_tpu_torch.pipeline import (
    DeviceRandomContext,
    DType,
    PipelineDefinition,
    ReplayRandomContext,
    SampleDataGroup,
)
from accvlab_tpu_torch.pipeline.inputs import DataProvider, ShuffledShardedInputCallable
from accvlab_tpu_torch.pipeline.processing_steps import (
    AffineTransformer,
    ImageDecoder,
    ImageRange01Normalizer,
    ImageToTileSizePadder,
    PhotoMetricDistorter,
)

SEED = 7


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jpeg(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    return np.frombuffer(buf.getvalue(), np.uint8).copy()


class SyntheticProvider(DataProvider):
    """Solid-colour JPEGs + label + token string (``test_pipeline_end_to_end``'s)."""

    def __init__(self, n=8, h=20, w=24):
        self._images = [_jpeg(np.full((h, w, 3), (i * 29) % 256, np.uint8)) for i in range(n)]
        self._n = n

    @property
    def sample_data_structure(self):
        sdg = SampleDataGroup()
        sdg.add_data_field("image", DType.UINT8)
        sdg.add_data_field("label", DType.INT32)
        sdg.add_data_field("token", DType.STRING)
        return sdg

    def get_data(self, i):
        sdg = self.sample_data_structure
        sdg["image"] = self._images[i]
        sdg["label"] = i % 3
        sdg["token"] = f"sample_{i:03d}"
        return sdg

    def get_number_of_samples(self):
        return self._n


def _device_steps(kind):
    if kind == "photometric":
        return [PhotoMetricDistorter("image", min_max_brightness=(0.9, 1.1),
                                     min_max_hue=(-0.05, 0.05), min_max_contrast=(0.9, 1.1),
                                     min_max_saturation=(0.9, 1.1))]
    A = AffineTransformer
    return [A(output_hw=(16, 20), resizing_mode=A.ResizingMode.STRETCH,
              image_field_names="image",
              transformation_steps=[
                  A.UniformScaling(1.0, 1.0, 1.5),
                  A.ShiftInsideOriginalImage(0.5, True, True),
                  A.Selection(0.7, option_probs=[0.5, 0.5],
                              options=[[A.Rotation(0.5, 10.0)],
                                       [A.Translation(1.0, [-2.0, -2.0], [2.0, 2.0])]])])]


def build_pipeline(batch_size=4, kind="photometric", device_steps=True):
    steps = [ImageDecoder("image"), ImageToTileSizePadder("image", 8),
             ImageRange01Normalizer("image")]
    if device_steps:
        steps += _device_steps(kind)
    definition = PipelineDefinition(
        ShuffledShardedInputCallable(SyntheticProvider(), batch_size=batch_size, shuffle=False),
        steps, copy_external_source_passthrough_outputs=False)
    return definition.get_pipeline(batch_size=batch_size, num_threads=2, seed=SEED,
                                   device="cpu")


def _delivered_pipeline(kind="photometric"):
    pipe = build_pipeline(kind=kind)
    pipe.run()
    return pipe


def _random_leaves(pipe, seed):
    """Leaves of the last device-stage call's specs, random values."""
    rng = np.random.default_rng(seed)
    specs, _ = pipe._last_device_spec
    return tuple(torch.from_numpy((rng.random(shape) * 200).astype(np.float32)).to(dtype)
                 if dtype.is_floating_point
                 else torch.from_numpy(rng.integers(0, 200, shape)).to(dtype)
                 for shape, dtype in specs)


def _assert_leaves_equal(got, want, names):
    assert len(got) == len(want) == len(names)
    for g, w, name in zip(got, want, names):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("kind", ["photometric", "affine_selection"])
def test_export_roundtrips_bit_exact(tmp_path, kind):
    pipe = _delivered_pipeline(kind)
    try:
        path = str(tmp_path / "preprocess.accvserve")
        header = pipe.export_device_program(path)
        assert os.path.exists(path)
        assert header["pipeline_input_fields"] == list(pipe._host_out_blueprint.field_names_flat)
        assert header["pipeline_output_fields"] == list(pipe.output_names)
        assert header["draw_schedule"]
        info = read_artifact_info(path)
        assert info["nr_devices"] == 1 and info["float32_matmul"] == "highest"

        leaves = _random_leaves(pipe, 0)
        serve = load_inference(path, device="cpu")
        got = serve(leaves, (SEED, 3))
        want = pipe.run_device_stage(leaves, 3)  # the same draws: key (seed, batch 3)
        _assert_leaves_equal(got, want, header["pipeline_output_fields"])
    finally:
        pipe.stop()


def test_export_returns_bytes_without_path():
    pipe = _delivered_pipeline()
    try:
        data = pipe.export_device_program()
        assert isinstance(data, bytes)
        assert read_artifact_info(data)["pipeline_input_fields"]
        assert load_inference(data, device="cpu") is not None
    finally:
        pipe.stop()


def test_export_before_first_batch_raises():
    pipe = build_pipeline()
    try:
        with pytest.raises(RuntimeError, match="deliver at least one batch"):
            pipe.export_device_program()
    finally:
        pipe.stop()


def test_export_without_device_steps_raises():
    pipe = build_pipeline(device_steps=False)
    try:
        pipe.run()
        with pytest.raises(RuntimeError, match="no device-placed steps"):
            pipe.export_device_program()
    finally:
        pipe.stop()


def test_chained_artifacts_preprocess_then_model(tmp_path):
    """Two files on the serving host, no pipeline or model code: the
    preprocess program, then a model program over its image; the result
    equals the in-process composition."""
    pipe = _delivered_pipeline()
    try:
        pre_path = str(tmp_path / "preprocess.accvserve")
        header = pipe.export_device_program(pre_path)
        img_idx = header["pipeline_output_fields"].index("image")
        leaves = _random_leaves(pipe, 1)
        key = (SEED, 11)
        pre_out = pipe.run_device_stage(leaves, 11)
        w = torch.tensor(0.5)

        def model_apply(img):
            return {"score": (img * w).mean(dim=(1, 2, 3))}

        model_path = str(tmp_path / "model.accvserve")
        save_inference(model_path, model_apply, pre_out[img_idx])
    finally:
        pipe.stop()

    pre = load_inference(pre_path, device="cpu")
    model = load_inference(model_path, device="cpu")
    served = model(pre(leaves, key)[img_idx])
    assert torch.equal(served["score"], model_apply(pre_out[img_idx])["score"])


def test_device_program_text_public_inspection():
    """Every device step names its nodes, no float64 enters the stage, and
    nothing reads a value back to the host (``aten._local_scalar_dense``)."""
    pipe = build_pipeline(batch_size=4)
    try:
        with pytest.raises(RuntimeError, match="no device program built yet"):
            pipe.device_program_text()
        pipe.run()
        txt = pipe.device_program_text()
        for name in [type(s).__name__ for s in pipe._device_steps]:
            assert f"# {name}_" in txt, f"step {name!r} missing"
        assert "float64" not in txt
        assert "_local_scalar_dense" not in txt
        opt = pipe.device_program_text(optimized=True)
        assert isinstance(opt, str) and opt and opt != txt
        assert pipe.device_program_text() is txt  # cached
    finally:
        pipe.stop()


def test_device_program_text_requires_device_steps():
    pipe = build_pipeline(batch_size=2, device_steps=False)
    try:
        pipe.run()
        with pytest.raises(RuntimeError, match="no device-placed steps"):
            pipe.device_program_text()
    finally:
        pipe.stop()


def test_replay_with_a_draw_too_many_or_too_few_raises():
    ctx = DeviceRandomContext((0, 1), device="cpu")
    a = ctx.uniform(0.0, 1.0, (3,))
    b = ctx.randint(0, 6, (3,))
    draws, schedule = (a, b), ctx.schedule
    assert [e["kind"] for e in schedule] == ["uniform", "randint"]

    too_many = ReplayRandomContext(draws, schedule)
    too_many.uniform(0.0, 1.0, (3,))
    too_many.randint(0, 6, (3,))
    with pytest.raises(RuntimeError, match="schedule has 2"):
        too_many.uniform(0.0, 1.0, (3,))

    too_few = ReplayRandomContext(draws, schedule)
    too_few.uniform(0.0, 1.0, (3,))
    with pytest.raises(RuntimeError, match="took 1 of the schedule's 2"):
        too_few.finish()

    other = ReplayRandomContext(draws, schedule)
    with pytest.raises(RuntimeError, match="recorded schedule has"):
        other.randint(0, 6, (3,))  # out of order
    with pytest.raises(ValueError, match="2 draws"):
        ReplayRandomContext(draws, schedule + [schedule[0]])


def test_exported_stage_with_a_tampered_schedule_raises():
    """An artifact whose schedule lost a draw: its program gets one draw
    input too few, which raises instead of wrapping around."""
    from accvlab_tpu_torch.models import serving as S

    pipe = _delivered_pipeline()
    try:
        data = pipe.export_device_program()
        leaves = _random_leaves(pipe, 2)
    finally:
        pipe.stop()
    header, payload = S._unpack(data)
    header["draw_schedule"] = header["draw_schedule"][:-1]
    serve = load_inference(S._pack(header, payload), device="cpu")
    with pytest.raises(Exception):
        serve(leaves, (SEED, 0))


def test_dct_wire_stage_exports_bitwise():
    """bench.py's device stage on the DCT wire (small sizes): the artifact
    on the last host batch's transferred leaves equals run_device_stage bit
    for bit, through the registered rasterizer operator."""
    from accvlab_tpu_torch.bench_pipeline import build_pipeline as build_bench

    pipe = build_bench(batch_size=2, device="cpu", num_threads=1, hw=(96, 256), num_cams=2,
                       out_hw=(64, 176), heatmap_hw=(16, 44), num_samples=16, num_unique=2)
    try:
        pipe.run()
        pipe._halt_producer()
        idx, _, _, host = pipe._produce_host_batch()
        leaves = pipe._transfer(host)
        want = pipe.run_device_stage(leaves, idx)
        data = pipe.export_device_program()
        info = read_artifact_info(data)
        assert info["custom_ops"] == ["accvlab_tpu_torch::draw_gaussians"]
        # no uint32 in the program (torch 2.11's serializer has none): the
        # packed exceptions enter as their int32 bits
        assert any(x.dtype == torch.uint32 for x in leaves)
        assert not any("uint32" in spec for spec in info["in_specs"] + info["out_specs"])
        assert "uint32" not in pipe.device_program_text()
        got = load_inference(data, device="cpu")(leaves, (0, idx))
        _assert_leaves_equal(got, want, info["pipeline_output_fields"])
        txt = pipe.device_program_text()
        for name in [type(s).__name__ for s in pipe._device_steps]:
            assert f"# {name}_" in txt, name
        assert "accvlab_tpu_torch.draw_gaussians" in txt
    finally:
        pipe.stop()
