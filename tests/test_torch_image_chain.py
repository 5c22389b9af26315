"""The rule that sends the device stage's image chain through one kernel
(``accvlab_tpu_torch.pipeline.image_chain``), on the CPU.

* :func:`find_image_chain` finds ``AffineTransformer`` ->
  ``PhotoMetricDistorter`` -> ``ImageMeanStdDevNormalizer`` on one image name
  in bench.py's and the 2-D example's device steps, and nothing in the
  preemptible example's, with a step between that reads the images, with
  different names, in another order or with a normalizer output other than
  FLOAT;
* :func:`takes_images` takes images typed UINT8 on the card only; the
  operator takes a non-contiguous image as its contiguous copy and refuses
  one of another shape;
* on CPU tensors the executor's stage is the steps as written, and counts no
  fused batch;
* the fused path itself (the steps' stand-ins, the parameters, the
  operator's plain version), let onto CPU tensors: bit for bit the steps as
  written, with the same draw schedule, eager and through the traced
  program, every batch counted.

No JAX is imported: ``tests/test_torch_fused_image_stage.py`` takes its
cases from here on a card machine.
"""

import numpy as np
import pytest
import torch

from accvlab_tpu_torch.bench_pipeline import build_pipeline, headline_steps
from accvlab_tpu_torch.object_detection_2d_pipeline import detection_steps
from accvlab_tpu_torch.pipeline import DType, SampleDataGroup
from accvlab_tpu_torch.pipeline import image_chain as chain_mod
from accvlab_tpu_torch.pipeline.image_chain import (
    ImageChain,
    find_image_chain,
    run_device_steps,
    takes_images,
)
from accvlab_tpu_torch.pipeline.inputs.multicam_synthetic import (
    sample_boxes,
    sample_structure,
    structured_noise_frames,
)
from accvlab_tpu_torch.pipeline.operators.image_chain import (
    PARAMS,
    chain_consts,
    pack_params,
    unpack_params,
)
from accvlab_tpu_torch.pipeline.processing_steps import (
    BoundingBoxToHeatmapConverter,
    ImageMeanStdDevNormalizer,
    ImageRange01Normalizer,
    ImageToTileSizePadder,
    PhotoMetricDistorter,
    YCbCrToRGBConverter,
)
from accvlab_tpu_torch.pipeline.random_context import DeviceRandomContext
from accvlab_tpu_torch.tools import clear_program_cache

MEAN, STD = [103.5, 116.3, 123.7], [57.4, 57.1, 58.4]

#: (name, batch, frame hw, output hw, affine prob, photometric prob, BGR):
#: every gate on, every gate off, gates mixed per sample, warps reaching out
#: of the frame (scaling 0.9 and shifts of 16 px at probability 1), the
#: identity map (the output the frame's size, no augmentation), one sample,
#: BGR images
CASES = [
    ("gates_on", 4, (48, 128), (32, 88), 1.0, 1.0, False),
    ("gates_off", 4, (48, 128), (32, 88), 1.0, 0.0, False),
    ("gates_mixed", 16, (48, 128), (32, 88), 0.5, 0.5, False),
    ("identity", 4, (48, 128), (48, 128), 0.0, 1.0, False),
    ("one_sample", 1, (48, 128), (36, 90), 1.0, 1.0, False),
    ("bgr", 4, (48, 128), (32, 88), 1.0, 1.0, True),
]


def chain_steps(out_hw, affine_prob, photometric_prob, is_bgr=False):
    """bench.py's device steps at ``out_hw``, the photometric step on BGR
    images where ``is_bgr``."""
    steps = headline_steps(out_hw, (out_hw[0] // 4, out_hw[1] // 4), affine_prob=affine_prob,
                           photometric_prob=photometric_prob)
    steps[1]._is_bgr = is_bgr
    return steps


def chain_leaves(b, hw, cams, seed, device):
    """A batch of bench.py's blueprint with ``cams`` cameras: ``(blueprint,
    leaves)``, structured-noise frames and bench.py's boxes."""
    blueprint = sample_structure(SampleDataGroup, DType, cams)
    frames = structured_noise_frames(b * cams, hw, seed)
    boxes = [sample_boxes(seed * 1000 + i, cams, hw, 32, 10) for i in range(b)]
    leaves = []
    for c in range(cams):
        leaves += [np.stack([frames[i * cams + c] for i in range(b)]),
                   np.tile(np.asarray(hw, np.int32), (b, 1)),
                   np.stack([boxes[i][c][0] for i in range(b)]),
                   np.stack([boxes[i][c][1] for i in range(b)])]
    return blueprint, [torch.from_numpy(x).to(device) for x in leaves]


def run_chain(steps, blueprint, leaves, key, device, fuse, check=False):
    """The steps on the leaves, their draws from ``key``: ``(outputs by
    name, operator calls, schedule)``, the chain through the operator where
    ``fuse``, else the steps as written."""
    sdg = blueprint.get_empty_like_self()
    sdg.set_data(list(leaves))
    ctx = DeviceRandomContext(key, device=device)
    calls = []
    operator = chain_mod.image_chain

    def apply(i, fn, data):
        return steps[i]._checked(fn, data) if check else fn(data)

    def counted(*args):
        calls.append(args[0].shape)
        return operator(*args)

    chain_mod.image_chain = counted
    try:
        out = run_device_steps(steps, sdg, ctx, find_image_chain(steps) if fuse else None, apply)
    finally:
        chain_mod.image_chain = operator
    return dict(zip(out.field_names_flat, out.get_data())), len(calls), ctx.schedule


def chain_params(steps, blueprint, leaves, key, device):
    """What the fused path hands the operator for the chain of
    :func:`chain_steps` on the leaves, drawn from ``key``: ``(params, out_hw,
    consts)``."""
    sdg = blueprint.get_empty_like_self()
    sdg.set_data(list(leaves))
    ctx = DeviceRandomContext(key, device=device)
    for s in steps:
        s.set_random_context(ctx)
    maps, out_hw = steps[0].image_params(sdg, "image")
    values, is_bgr = steps[1].image_params(sdg)
    return pack_params(maps, values), out_hw, chain_consts(is_bgr, *steps[3].image_params())


@pytest.fixture
def kernel_on_cpu(monkeypatch):
    """Lets the fused path onto CPU tensors: the operator's CPU form is its
    plain version. The programs kept before and during the test are
    dropped: a program is kept under its steps, which on the CPU alone no
    longer decide whether it fuses."""
    clear_program_cache()
    monkeypatch.setattr(chain_mod, "KERNEL_DEVICES", ("cuda", "cpu"))
    yield
    clear_program_cache()


# --------------------------------------------------------------------------- #
# the rule                                                                    #
# --------------------------------------------------------------------------- #


def _converter(image_field_name=None):
    kw = ({"image_field_name": image_field_name} if image_field_name is not None
          else {"image_hw_field_name": "image_hw"})
    return BoundingBoxToHeatmapConverter(annotation_field_name="annotations",
                                         bboxes_in_name="bboxes", heatmap_out_name="heatmap",
                                         heatmap_hw=(16, 44), categories_in_name="categories",
                                         num_categories=10, **kw)


def _photometric(name="image"):
    return PhotoMetricDistorter(name, [-16.0, 16.0], [-10.0, 10.0], [0.8, 1.2], [0.8, 1.2])


@pytest.mark.parametrize("steps,want", [
    (headline_steps(), ImageChain(0, 1, 3, "image")),
    (detection_steps(), ImageChain(2, 3, 5, "image")),
    # the YUV and DCT wires: the decoded planes to RGB on the card, then bench.py's steps
    ([YCbCrToRGBConverter("image")] + headline_steps(), ImageChain(1, 2, 4, "image")),
    # nothing between the three
    ([headline_steps()[i] for i in (0, 1, 3)], ImageChain(0, 1, 2, "image")),
], ids=["headline", "detection_2d", "after_ycbcr", "adjacent"])
def test_chain_is_found(steps, want):
    assert find_image_chain(steps) == want


def _not_chains():
    h = headline_steps
    return {
        # the preemptible example's device steps: padder, [0, 1] floats, photometric
        "preemptible": [ImageToTileSizePadder("image", 8), ImageRange01Normalizer("image"),
                        _photometric()],
        "reads_image_between": [h()[0], h()[1], _converter("image"), h()[3]],
        "unknown_step_between": [h()[0], ImageRange01Normalizer("image"), h()[1], h()[3]],
        "other_name": [h()[0], _photometric("other"), h()[2], h()[3]],
        "normalizer_not_float": [h()[0], h()[1], h()[2],
                                 ImageMeanStdDevNormalizer("image", MEAN, STD, DType.UINT8)],
        "other_order": [h()[1], h()[0], h()[2], h()[3]],
        "no_normalizer": h()[:3],
    }


@pytest.mark.parametrize("case", sorted(_not_chains()))
def test_chain_is_not_found(case):
    assert find_image_chain(_not_chains()[case]) is None


def test_converter_that_reads_another_name_is_no_obstacle():
    h = headline_steps()
    assert find_image_chain([h[0], h[1], _converter("other"), h[3]]) == ImageChain(0, 1, 3,
                                                                                   "image")


def _group(*dtypes):
    sdg = SampleDataGroup()
    for i, dtype in enumerate(dtypes):
        sdg.add_data_group_field(f"cam{i}", SampleDataGroup())
        sdg[f"cam{i}"].add_data_field("image", dtype)
    return sdg


def test_takes_images_on_the_card_only():
    card = torch.device("cuda", 0)
    assert not takes_images(_group(DType.UINT8), "image", "cpu")
    assert takes_images(_group(DType.UINT8), "image", card)
    assert takes_images(_group(DType.UINT8, DType.UINT8), "image", "cuda")
    assert not takes_images(_group(DType.FLOAT), "image", card)
    assert not takes_images(_group(DType.UINT8, DType.FLOAT), "image", card)  # every image
    assert not takes_images(_group(DType.UINT8), "other", card)  # no images under the name
    assert takes_images(sample_structure(SampleDataGroup, DType, 6), "image", card)


def test_operator_takes_a_strided_image_as_its_copy(kernel_on_cpu):
    """A non-contiguous image goes through the operator as its contiguous
    copy: bit for bit the steps as written."""
    steps = chain_steps((32, 88), 1.0, 1.0)
    blueprint, leaves = chain_leaves(4, (48, 128), 1, 3, "cpu")
    leaves[0] = leaves[0].transpose(1, 2).contiguous().transpose(1, 2)
    assert not leaves[0].is_contiguous()
    got, calls, _ = run_chain(steps, blueprint, leaves, (7, 1), "cpu", True)
    want, none, _ = run_chain(steps, blueprint, leaves, (7, 1), "cpu", False)
    assert (calls, none) == (1, 0)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("shape", [(2, 8, 8, 1), (2, 8, 8, 4), (8, 8, 3)],
                         ids=["one_channel", "four_channels", "no_batch"])
def test_operator_refuses_other_shapes(shape):
    params = torch.zeros(shape[0] if len(shape) == 4 else 8, PARAMS)
    with pytest.raises(ValueError, match="uint8 field"):
        chain_mod.image_chain(torch.zeros(shape, dtype=torch.uint8), params, 4, 4,
                              [0.0] * 11)


# --------------------------------------------------------------------------- #
# the stage on CPU tensors                                                    #
# --------------------------------------------------------------------------- #


def _small(num_samples=16, **kw):
    return build_pipeline(batch_size=2, device="cpu", num_threads=2, hw=(96, 256), num_cams=2,
                          out_hw=(64, 176), heatmap_hw=(16, 44), num_samples=num_samples,
                          wire="frames", **kw)


def _outputs(pipe, n):
    try:
        return [{k: v.clone() for k, v in pipe.run().items()} for _ in range(n)], pipe.stats()
    finally:
        pipe.stop()


def _as_written(pipe):
    """``pipe`` with its steps as written, and no program of equal steps kept
    that it would find."""
    clear_program_cache()
    pipe._image_chain = None
    return pipe


def test_cpu_stage_is_the_steps_as_written():
    """On CPU tensors the chain stays the steps as written (eager and
    program batches), and no batch counts as fused."""
    pipe = _small()
    assert find_image_chain(pipe._device_steps) == ImageChain(0, 1, 3, "image")
    assert pipe._image_chain is None
    got, stats = _outputs(pipe, 6)
    want, _ = _outputs(_as_written(_small()), 6)
    clear_program_cache()
    assert stats["fused_stage_batches"] == 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("check", [False, True], ids=["unchecked", "checked"])
def test_fused_path_is_the_steps_bitwise(kernel_on_cpu, case, check):
    """The fused path on CPU tensors (the operator's plain version on the
    packed parameters) against the steps as written: every output bit for
    bit, the same draw schedule."""
    _, b, hw, out_hw, affine_prob, photometric_prob, is_bgr = case
    steps = chain_steps(out_hw, affine_prob, photometric_prob, is_bgr)
    blueprint, leaves = chain_leaves(b, hw, 2, 3, "cpu")
    got, fused, schedule = run_chain(steps, blueprint, leaves, (7, 1), "cpu", True, check)
    want, unfused, want_schedule = run_chain(steps, blueprint, leaves, (7, 1), "cpu", False,
                                             check)
    assert (fused, unfused) == (2, 0)  # one call per camera
    assert schedule == want_schedule
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert got["cameras.[0].image"].shape == (b, *out_hw, 3)


def test_fused_stage_counts_every_batch_and_keeps_the_draws(kernel_on_cpu):
    """The executor's stage through the fused path, eager and through the
    traced program: every batch counted, bit for bit the steps as written,
    the same draw schedule per spec."""
    pipe = _small()
    got, stats = _outputs(pipe, 6)
    ref = _as_written(_small())
    want, ref_stats = _outputs(ref, 6)
    assert stats["fused_stage_batches"] == 6 and ref_stats["fused_stage_batches"] == 0
    assert any(e[2] for e in pipe._stage_specs.values())  # later batches ran the program
    assert pipe._image_chain == ImageChain(0, 1, 3, "image") and ref._image_chain is None
    assert [e[1] for e in pipe._stage_specs.values()] == [e[1] for e in ref._stage_specs.values()]
    for a, b in zip(got, want):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert "accvlab_tpu_torch.image_chain" in pipe.device_program_text()


def test_params_layout():
    """The operator's parameters: one row of PARAMS float32 values per
    sample, the gates 0 or 1."""
    steps = chain_steps((32, 88), 1.0, 0.5)
    blueprint, leaves = chain_leaves(16, (48, 128), 1, 0, "cpu")
    params, out_hw, consts = chain_params(steps, blueprint, leaves, (0, 0), "cpu")
    assert params.shape == (16, PARAMS) and params.dtype == torch.float32
    assert out_hw == (32, 88) and len(consts) == 11
    assert set(params[:, 6:12].unique().tolist()) == {0.0, 1.0}
    sdg = blueprint.get_empty_like_self()
    sdg.set_data(leaves)
    ctx = DeviceRandomContext((0, 0), device="cpu")
    for s in steps:
        s.set_random_context(ctx)
    maps, _ = steps[0].image_params(sdg, "image")
    values, _ = steps[1].image_params(sdg)
    got_maps, got = unpack_params(params)
    assert torch.equal(got_maps, maps)
    for k, v in values.items():
        assert torch.equal(got[k], v), k


def test_cases_cover_the_fill_and_the_identity():
    """The cases reach what they name: warps at probability 1 sample outside
    the frame (the fill's normalized value shows in every camera's images),
    and the identity case samples each output pixel at its own source
    pixel."""
    from accvlab_tpu_torch.pipeline.processing_steps.image_normalizers import mean_std_normalize

    _, b, hw, out_hw, affine_prob, photometric_prob, _ = CASES[1]  # every gate off
    steps = chain_steps(out_hw, affine_prob, photometric_prob)
    blueprint, leaves = chain_leaves(b, hw, 2, 3, "cpu")
    out, _, _ = run_chain(steps, blueprint, leaves, (7, 1), "cpu", False)
    fill = mean_std_normalize(torch.zeros(1, 1, 1, 3, dtype=torch.uint8),
                              *steps[3].image_params(), torch.float32)
    for c in range(2):
        assert bool((out[f"cameras.[{c}].image"] == fill).all(-1).any())
    _, b, hw, out_hw, affine_prob, photometric_prob, _ = CASES[3]  # the identity
    steps = chain_steps(out_hw, affine_prob, photometric_prob)
    blueprint, leaves = chain_leaves(b, hw, 2, 3, "cpu")
    params, _, _ = chain_params(steps, blueprint, leaves, (7, 1), "cpu")
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0]).expand(b, 6)
    assert torch.equal(params[:, :6].abs(), identity)
