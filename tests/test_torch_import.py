"""The PyTorch port stands alone: it imports no JAX and nothing of
``accvlab_tpu``, keeps byte-identical copies of the host C++ it shares, and
runs on the CPU only when asked to."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "accvlab_tpu_torch")
SUBPACKAGES = [
    "accvlab_tpu_torch",
    "accvlab_tpu_torch._draws",
    "accvlab_tpu_torch.batched_loss_computation",
    "accvlab_tpu_torch.bench_pipeline",
    "accvlab_tpu_torch.build_config",
    "accvlab_tpu_torch.build_config.helpers",
    "accvlab_tpu_torch.color",
    "accvlab_tpu_torch.custom_processing_step",
    "accvlab_tpu_torch.detection_serving",
    "accvlab_tpu_torch.dryrun_multichip",
    "accvlab_tpu_torch.heatmap",
    "accvlab_tpu_torch.heatmap._ops",
    "accvlab_tpu_torch.hostcopy",
    "accvlab_tpu_torch.lane_regression_training",
    "accvlab_tpu_torch.models",
    "accvlab_tpu_torch.models.checkpoint",
    "accvlab_tpu_torch.models.moe",
    "accvlab_tpu_torch.models.quantize",
    "accvlab_tpu_torch.models.server",
    "accvlab_tpu_torch.models.serving",
    "accvlab_tpu_torch.moe_expert_parallel_training",
    "accvlab_tpu_torch.object_detection_2d_pipeline",
    "accvlab_tpu_torch.parallel",
    "accvlab_tpu_torch.parallel._collectives",
    "accvlab_tpu_torch.parallel.mesh",
    "accvlab_tpu_torch.parallel.pipeline_parallel",
    "accvlab_tpu_torch.pipeline",
    "accvlab_tpu_torch.pipeline.inputs",
    "accvlab_tpu_torch.pipeline.inputs.elastic_sharded_input_callable",
    "accvlab_tpu_torch.pipeline.internal_helpers",
    "accvlab_tpu_torch.pipeline.mini_parser",
    "accvlab_tpu_torch.pipeline.operators",
    "accvlab_tpu_torch.pipeline.processing_steps",
    "accvlab_tpu_torch.pipeline.processing_steps.bev_bboxes_transformer_3d",
    "accvlab_tpu_torch.pipeline.structured_output_iterator",
    "accvlab_tpu_torch.pipeline.worker_pool",
    "accvlab_tpu_torch.polyline",
    "accvlab_tpu_torch.preemptible_training",
    "accvlab_tpu_torch.ragged",
    "accvlab_tpu_torch.tools",
    "accvlab_tpu_torch.tools.launch_counts",
    "accvlab_tpu_torch.tools.tensor_dumper",
    "accvlab_tpu_torch.tools.trace_range",
    "accvlab_tpu_torch.train_centernet_e2e",
    "accvlab_tpu_torch.train_petr_e2e",
]
COPIED_CSRC = [
    ("hostcopy/csrc/pack.cpp", "accvlab_tpu/hostcopy/csrc/pack.cpp"),
    ("pipeline/csrc/wirepack.cpp", "accvlab_tpu/pipeline/csrc/wirepack.cpp"),
    ("pipeline/csrc/simd_bitplane.h", "accvlab_tpu/pipeline/csrc/simd_bitplane.h"),
    ("pipeline/csrc/jpegdec.cpp", "accvlab_tpu/pipeline/csrc/jpegdec.cpp"),
    ("pipeline/csrc/dctpack.cpp", "accvlab_tpu/pipeline/csrc/dctpack.cpp"),
]


def _port_files():
    out = []
    for root, _, files in os.walk(PORT):
        if "_build" in root or "__pycache__" in root:
            continue
        out += [os.path.relpath(os.path.join(root, f), REPO) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.fixture(scope="module")
def imported_modules():
    code = (
        "import importlib, json, sys\n"
        f"for m in {SUBPACKAGES!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("module", SUBPACKAGES)
def test_subpackage_imports_without_jax(imported_modules, module):
    assert module in imported_modules
    assert "jax" not in imported_modules
    assert not any(m == "accvlab_tpu" or m.startswith("accvlab_tpu.") for m in imported_modules)


@pytest.mark.parametrize("path", _port_files())
def test_no_jax_or_reference_import(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    for name in names:
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax", "accvlab_tpu"), (
            f"{path} imports {name}"
        )


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
            assert not any(m.split(".")[0] in ("jax", "accvlab_tpu") for m in mods)


@pytest.mark.parametrize("copy,original", COPIED_CSRC)
def test_copied_csrc_is_byte_identical(copy, original):
    with open(os.path.join(PORT, copy), "rb") as a, open(os.path.join(REPO, original), "rb") as b:
        assert a.read() == b.read()


def _entry_points():
    from accvlab_tpu_torch.heatmap import draw_gaussians, draw_heatmap, draw_heatmap_batched
    from accvlab_tpu_torch.hostcopy import start_copy
    from accvlab_tpu_torch.models import make_petr_example_batch
    from accvlab_tpu_torch.batched_loss_computation import make_data, make_head
    from accvlab_tpu_torch.pipeline.processing_steps import compress_jpeg_dct, decompress_jpeg_dct
    from accvlab_tpu_torch.ragged import RaggedBatch, auction_matching, batched_auction_matching

    z = np.zeros
    rb = RaggedBatch(z((1, 1, 2), np.int32), sample_sizes=np.ones(1, np.int32))
    rr = RaggedBatch(z((1, 1), np.int32), sample_sizes=np.ones(1, np.int32))
    return {
        "draw_heatmap": lambda **kw: draw_heatmap(z((1, 4, 4), np.float32), z((1, 2), np.int32),
                                                  z(1, np.int32), z(1, np.int32), **kw),
        "draw_heatmap_batched": lambda **kw: draw_heatmap_batched(z((1, 4, 4), np.float32), rb, rr,
                                                                  **kw),
        "draw_gaussians": lambda **kw: draw_gaussians(z((1, 4, 4), np.float32), z(1, bool),
                                                      z(1, np.int32), z((1, 2), np.int32),
                                                      z(1, np.float32), [1.0], 0.5, **kw),
        "start_copy": lambda **kw: start_copy([z(3, np.float32)], use_background_thread=False,
                                              **kw).get(),
        "get_pipeline": lambda **kw: _tiny_pipeline(**kw),
        "auction_matching": lambda **kw: auction_matching(z((2, 3), np.float32), **kw),
        "batched_auction_matching": lambda **kw: batched_auction_matching(
            z((1, 2, 3), np.float32), np.ones(1, np.int32), **kw),
        "make_petr_example_batch": lambda **kw: make_petr_example_batch(hw=(8, 8), **kw),
        "build_stream_pipeline": lambda **kw: _tiny_pipeline(stream=True, **kw),
        "make_data": lambda **kw: make_data(batch_size=1, max_gt=4, num_pred=6, **kw),
        "make_head": lambda **kw: make_head(dim=4, **kw),
        "decompress_jpeg_dct": lambda **kw: decompress_jpeg_dct(
            compress_jpeg_dct(_tiny_jpeg(), (8, 16)), (8, 16), **kw),
        "object_detection_2d_pipeline.build_pipeline": lambda **kw: _tiny_det2d(**kw),
        "StructuredOutputIterator": lambda **kw: _tiny_iterator(**kw),
        "load_inference": lambda **kw: _tiny_load(**kw),
        "InferenceServer.from_artifact": lambda **kw: _tiny_server(**kw),
        "detection_serving.main": lambda **kw: _tiny_serving_main(**kw),
        "lane_regression_training.run": lambda **kw: _tiny_lane_run(**kw),
        "TraceRangeWrapper.enable": lambda **kw: _tiny_trace_enable(**kw),
        "polyline.interpolate": lambda **kw: _tiny_interpolate(**kw),
        "get_as_data_node": lambda **kw: _tiny_data_node(**kw),
        "make_mesh": lambda device=None: _tiny_mesh(device),
        "moe_expert_parallel_training.train": lambda **kw: _tiny_moe_train(**kw),
        "dryrun_multichip": lambda **kw: _tiny_dryrun(**kw),
    }


def _tiny_moe_train(**kw):
    """Two steps of the MoE example; the group it makes is destroyed."""
    import torch.distributed as dist

    from accvlab_tpu_torch.moe_expert_parallel_training import train

    try:
        return train(1, steps=2, **kw)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _tiny_dryrun(**kw):
    """Every stanza on one rank, in a fresh process."""
    from accvlab_tpu_torch.dryrun_multichip import dryrun_multichip

    return dryrun_multichip(1, **kw)


def _tiny_mesh(device):
    """``make_mesh`` takes ``device_type=``; the group it makes is destroyed."""
    import torch.distributed as dist

    from accvlab_tpu_torch.parallel import make_mesh

    try:
        return make_mesh(device_type=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _tiny_lane_run(**kw):
    from accvlab_tpu_torch.lane_regression_training import run

    return run(num_steps=1, batch_size=2, **kw)


def _tiny_trace_enable(**kw):
    from accvlab_tpu_torch.tools import TraceRangeWrapper

    TraceRangeWrapper._reset_singleton()
    try:
        TraceRangeWrapper().enable(**kw)
    finally:
        TraceRangeWrapper._reset_singleton()


def _tiny_interpolate(**kw):
    from accvlab_tpu_torch.polyline import interpolate

    return interpolate(np.zeros((1, 2, 2), np.float32), np.zeros((1, 1), np.float32), **kw)


def _tiny_data_node(**kw):
    from accvlab_tpu_torch.pipeline.internal_helpers import get_as_data_node

    return get_as_data_node(np.zeros(2, np.float32), **kw)


def _tiny_artifact():
    from accvlab_tpu_torch.models.serving import export_inference

    return export_inference(lambda x: {"y": x * 2.0}, (torch.zeros((2, 3)),),
                            batch_polymorphic=True)


def _tiny_load(**kw):
    from accvlab_tpu_torch.models.serving import load_inference

    return load_inference(_tiny_artifact(), **kw)(torch.ones((1, 3)))


def _tiny_server(**kw):
    from accvlab_tpu_torch.models import InferenceServer

    with InferenceServer.from_artifact(_tiny_artifact(), batch_sizes=(1,), **kw) as server:
        return server.infer(np.ones(3, np.float32), timeout=60)


def _tiny_serving_main(**kw):
    from accvlab_tpu_torch.detection_serving import main

    return main(batch_size=2, hw=(16, 16), **kw)


def _tiny_det2d(**kw):
    from accvlab_tpu_torch.object_detection_2d_pipeline import build_pipeline

    loader, pipe = build_pipeline(batch_size=1, num_threads=1, **kw)
    pipe.stop()
    return loader


def _tiny_iterator(**kw):
    """A StructuredOutputIterator over a default pipeline, one batch."""
    from accvlab_tpu_torch.pipeline import (
        DType,
        PipelineDefinition,
        SampleDataGroup,
        StructuredOutputIterator,
    )
    from accvlab_tpu_torch.pipeline.inputs import DataProvider, ShuffledShardedInputCallable
    from accvlab_tpu_torch.pipeline.processing_steps import ImageRange01Normalizer

    class One(DataProvider):
        @property
        def sample_data_structure(self):
            sdg = SampleDataGroup()
            sdg.add_data_field("image", DType.UINT8)
            return sdg

        def get_data(self, i):
            sdg = self.sample_data_structure
            sdg["image"] = np.zeros((2, 2, 3), np.uint8)
            return sdg

        def get_number_of_samples(self):
            return 1

    definition = PipelineDefinition(ShuffledShardedInputCallable(One(), 1),
                                    [ImageRange01Normalizer("image")])
    pipe = definition.get_pipeline(batch_size=1, num_threads=1, **kw)
    try:
        it = StructuredOutputIterator(1, pipe, definition.check_and_get_output_data_structure())
        return next(iter(it))
    finally:
        pipe.stop()


def _tiny_jpeg():
    from accvlab_tpu_torch.pipeline.inputs.multicam_jpeg import encode_bench_jpegs

    return encode_bench_jpegs(1, (16, 32))[0]


def _tiny_pipeline(stream=False, **kw):
    from accvlab_tpu_torch.bench_pipeline import build_pipeline
    from accvlab_tpu_torch.train_petr_e2e import build_stream_pipeline

    size = dict(batch_size=1, num_threads=1, hw=(16, 32), num_cams=1, out_hw=(8, 16),
                heatmap_hw=(4, 8))
    p = (build_stream_pipeline(num_drives=2, drive_length=1, sampler_iterations=1, **size, **kw)
         if stream else build_pipeline(num_samples=2, **size, **kw))
    p.stop()
    return p


@pytest.mark.parametrize("name", ["draw_heatmap", "draw_heatmap_batched", "draw_gaussians",
                                  "start_copy", "get_pipeline", "auction_matching",
                                  "batched_auction_matching", "make_petr_example_batch",
                                  "build_stream_pipeline", "make_data", "make_head",
                                  "decompress_jpeg_dct",
                                  "object_detection_2d_pipeline.build_pipeline",
                                  "StructuredOutputIterator", "load_inference",
                                  "InferenceServer.from_artifact", "detection_serving.main",
                                  "lane_regression_training.run", "TraceRangeWrapper.enable",
                                  "polyline.interpolate", "get_as_data_node", "make_mesh",
                                  "moe_expert_parallel_training.train", "dryrun_multichip"])
def test_entry_points_default_to_cuda(name):
    fn = _entry_points()[name]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    fn(device="cpu")  # explicit CPU runs the plain versions


@pytest.mark.parametrize("module", ["accvlab_tpu_torch.heatmap._ops",
                                    "accvlab_tpu_torch.models.serving"])
def test_serving_modules_import_no_pipeline_or_models(module):
    """The registered rasterizer operator and the artifact loader import
    nothing of ``pipeline`` or of the model definitions: a serving host
    registers the operator alone."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "import torch\n"
        "if 'heatmap._ops' in sys.argv[-1]: torch.ops.accvlab_tpu_torch.draw_gaussians\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code, module], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    mods = json.loads(res.stdout.strip().splitlines()[-1])
    banned = ("accvlab_tpu_torch.pipeline", "accvlab_tpu_torch.models.centernet",
              "accvlab_tpu_torch.models.petr", "accvlab_tpu_torch.models.params")
    assert not [m for m in mods if m.startswith(banned)]
    if module.endswith("_ops"):
        assert not [m for m in mods if m.startswith("accvlab_tpu_torch.models")]


def test_failed_dctpack_build_raises(monkeypatch):
    """A DCT band encoder that does not build raises, naming the compiler's
    error; the packer never reaches the numpy backend (the JAX module warns
    and falls back to it)."""
    from accvlab_tpu_torch.pipeline import DType, SampleDataGroup, dct_native
    from accvlab_tpu_torch.pipeline.processing_steps import DCTWirePacker

    def broken(*a, **kw):
        raise RuntimeError("libaccvlab_dctpack build failed (g++ ...): dctpack.cpp:1: error")

    monkeypatch.setattr(dct_native, "_LIB", None)
    monkeypatch.setattr(dct_native, "build_host_lib", broken)
    with pytest.raises(RuntimeError, match="did not build: .*dctpack.cpp:1: error"):
        dct_native.get_lib()
    packer = DCTWirePacker("image", (16, 32), (8, 16), num_threads=1)
    s = SampleDataGroup()
    s.add_data_field("image", DType.UINT8)
    s["image"] = _tiny_jpeg()
    with pytest.raises(RuntimeError, match="did not build"):
        packer._process_batch([s])


def test_dct_wire_without_libjpeg_raises(monkeypatch):
    """Without the native libjpeg decoder ``wire="dct"`` raises, where
    bench.py falls back quietly to the YUV wire (bench.py:169-175)."""
    from accvlab_tpu_torch.bench_pipeline import build_pipeline
    from accvlab_tpu_torch.pipeline import native_jpeg
    from accvlab_tpu_torch.pipeline.processing_steps import DCTWirePacker

    monkeypatch.setattr(native_jpeg, "available", lambda: False)
    monkeypatch.setattr(native_jpeg, "build_error", lambda: "no libjpeg (test)")
    for wire in ("dct", None):  # named, and as the default
        kw = {} if wire is None else {"wire": wire}
        with pytest.raises(RuntimeError, match="libjpeg.*no libjpeg \\(test\\).*wire='yuv'"):
            build_pipeline(device="cpu", **kw)
    with pytest.raises(RuntimeError, match="native libjpeg"):
        DCTWirePacker("image", (16, 32), (8, 16))
