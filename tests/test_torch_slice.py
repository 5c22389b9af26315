"""The headline pipeline end to end, in both packages, reduced in size.

bench.py's multi-camera pipeline with raw frames (``wire="frames"`` in
``accvlab_tpu_torch/bench_pipeline.py``; the YUV wire's slice is in
test_torch_yuv.py) at 2 cameras of 96x256, batch 2,
out 64x176, heatmap 10x16x44, built from the same constructor arguments in
both packages and driven through ``get_pipeline(...).run()`` on the CPU.

With the augmentation probabilities at 0 the random draws do not matter, so
every output field is compared: images within 1/57 + 1e-5 (a warped uint8
value may differ by one step, see test_torch_pipeline_steps.py, and the
normalizer divides by std >= 57.1), heatmaps rtol 1e-6, the rest exact. With
bench.py's probabilities the draws differ between the packages (threefry vs
torch.Generator), so only shapes, dtypes and value ranges are compared.
"""

import numpy as np
import pytest
import torch

import accvlab_tpu.pipeline as jpipe
import accvlab_tpu.pipeline.processing_steps as jsteps
from accvlab_tpu.pipeline.inputs import DataProvider as JDataProvider
from accvlab_tpu.pipeline.inputs import ShuffledShardedInputCallable as JInput
from accvlab_tpu_torch.bench_pipeline import build_pipeline
from accvlab_tpu_torch.pipeline.inputs.multicam_synthetic import (
    fill_sample,
    sample_structure,
    structured_noise_frames,
)

HW, CAMS, OUT_HW, HM_HW, BATCH, SAMPLES = (96, 256), 2, (64, 176), (16, 44), 2, 8


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _JaxProvider(JDataProvider):
    """The port's MultiCameraSyntheticProvider, on the JAX package's classes."""

    def __init__(self):
        self._frames = structured_noise_frames(2 * CAMS, HW, 0)

    @property
    def sample_data_structure(self):
        return sample_structure(jpipe.SampleDataGroup, jpipe.DType, CAMS)

    def get_data(self, i):
        return fill_sample(self.sample_data_structure, self._frames, i, CAMS, HW, 32, 10)

    def get_number_of_samples(self):
        return SAMPLES


def jax_pipeline(prob):
    s = jsteps
    steps = [
        s.AffineTransformer(
            output_hw=OUT_HW, resizing_mode=s.AffineTransformer.ResizingMode.STRETCH,
            image_field_names="image",
            transformation_steps=[
                s.AffineTransformer.UniformScaling(prob, 0.9, 1.1),
                s.AffineTransformer.Translation(prob, [-16.0, -16.0], [16.0, 16.0]),
            ],
        ),
        s.PhotoMetricDistorter(
            "image", min_max_brightness=[-16.0, 16.0], min_max_hue=[-10.0, 10.0],
            min_max_contrast=[0.8, 1.2], min_max_saturation=[0.8, 1.2],
            prob_brightness_aug=prob, prob_hue_aug=prob, prob_contrast_aug=prob,
            prob_saturation_aug=prob, prob_swap_channels=prob,
        ),
        s.BoundingBoxToHeatmapConverter(
            annotation_field_name="annotations", bboxes_in_name="bboxes",
            heatmap_out_name="heatmap", heatmap_hw=HM_HW, image_hw_field_name="image_hw",
            categories_in_name="categories", num_categories=10,
            is_active_opt_out_name="active", center_opt_out_name="center",
            center_offset_opt_out_name="offset",
        ),
        s.ImageMeanStdDevNormalizer("image", mean=[103.5, 116.3, 123.7],
                                    std_dev=[57.4, 57.1, 58.4]),
    ]
    inp = JInput(_JaxProvider(), batch_size=BATCH, shuffle=True)
    definition = jpipe.PipelineDefinition(inp, steps, check_data_format=False,
                                          copy_external_source_passthrough_outputs=False)
    return definition.get_pipeline(batch_size=BATCH, num_threads=2, seed=0)


def torch_pipeline(prob):
    return build_pipeline(batch_size=BATCH, device="cpu", num_threads=2, hw=HW, num_cams=CAMS,
                          out_hw=OUT_HW, heatmap_hw=HM_HW, num_samples=SAMPLES,
                          affine_prob=prob, photometric_prob=prob, wire="frames")


def _outputs(pipe, n):
    outs = []
    try:
        for _ in range(n):
            outs.append({k: np.asarray(v) for k, v in pipe.run().items()})
    finally:
        pipe.stop()
    return outs


def test_slice_matches_jax_without_augmentation():
    jax_out = _outputs(jax_pipeline(0.0), 2)
    torch_out = _outputs(torch_pipeline(0.0), 2)
    for j, t in zip(jax_out, torch_out):
        assert set(j) == set(t)
        for name in j:
            g, w = t[name], j[name]
            assert g.shape == w.shape and g.dtype == w.dtype, name
            if name.endswith(".image"):
                np.testing.assert_allclose(g, w, rtol=0, atol=1 / 57 + 1e-5, err_msg=name)
                assert float(np.mean(g != w)) < 0.01, name
            elif name.endswith("heatmap"):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)


def test_slice_with_bench_augmentation_shapes_and_ranges():
    jax_out = _outputs(jax_pipeline(0.5), 1)[0]
    torch_out = _outputs(torch_pipeline(0.5), 1)[0]
    assert set(jax_out) == set(torch_out)
    lo = (0 - np.array([103.5, 116.3, 123.7])) / np.array([57.4, 57.1, 58.4])
    hi = (255 - np.array([103.5, 116.3, 123.7])) / np.array([57.4, 57.1, 58.4])
    for name, g in torch_out.items():
        w = jax_out[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name.endswith(".image"):
            assert (g >= lo - 1e-5).all() and (g <= hi + 1e-5).all()
        elif name.endswith("heatmap"):
            assert g.min() >= 0.0 and g.max() == 1.0
        elif not name.endswith("image_hw"):
            np.testing.assert_array_equal(g, w, err_msg=name)  # boxes are not augmented
