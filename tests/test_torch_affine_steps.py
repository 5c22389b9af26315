"""``AffineTransformer``'s transformation steps on the port against the JAX
step: ``ShiftInsideOriginalImage``, ``ShiftToAlignWithOriginalImageBorder``
(every ``Border``), ``Rotation``, ``NonUniformScaling``, ``Shearing`` and
``Selection``, each with fixed and ranged parameters and a ``prob`` coin.

Both packages run the same step list on the same sample (a 12x16 uint8
image, points, an identity projection matrix) under a
``ScriptedRandomContext`` that records every draw. Checked:

* the draw order: the recorded ``(low, high)`` of every draw equal in both,
  and every scripted value consumed. Coins, the selection's choice and
  ranged draws share the range (0, 1) where possible, so a draw taken out
  of order takes another step's value;
* the transform (read from the projection matrix, which the step
  left-composes with ``[T; 0 0 1]``) and the moved points within 1e-6
  relative to the largest magnitude (float32 cos/sin/tan and dot products
  in XLA against torch);
* the warped uint8 image within 1, at most 2 % of values differing (a
  sample point within rounding of a pixel boundary may land one step apart).
"""

import numpy as np
import pytest
import torch

import accvlab_tpu.pipeline as jpipe
import accvlab_tpu.pipeline.processing_steps as jsteps
import accvlab_tpu_torch.pipeline as tpipe
import accvlab_tpu_torch.pipeline.processing_steps as tsteps

REL = 1e-6
IMAGE_HW = (12, 16)
OUT_HW = (14, 18)
MAX_SHARE_DIFFERING = 0.02


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _recording(pkg):
    class Recording(pkg.ScriptedRandomContext):
        def __init__(self):
            super().__init__()
            self.log = []

        def uniform(self, low=0.0, high=1.0, shape=()):
            self.log.append((float(low), float(high)))
            return super().uniform(low, high, shape)

    return Recording()


def _sample(pkg, batched: bool):
    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, (*IMAGE_HW, 3)).astype(np.uint8)
    points = np.array([[2.0, 3.0, 7.5, 1.0], [15.0, 11.0, 0.0, 0.0]], np.float32)
    proj = np.eye(3, 4, dtype=np.float32)
    sdg = pkg.SampleDataGroup()
    sdg.add_data_field("image", pkg.DType.UINT8)
    sdg.add_data_field("points", pkg.DType.FLOAT)
    sdg.add_data_field("proj", pkg.DType.FLOAT)
    leaves = [image, points, proj]
    sdg.set_data([torch.from_numpy(a[None]) for a in leaves] if batched else leaves)
    return sdg


def _run(steps_mod, pkg, make_steps, script, batched):
    A = steps_mod.AffineTransformer
    step = A(output_hw=OUT_HW, resizing_mode=A.ResizingMode.STRETCH, image_field_names="image",
             point_field_names="points", projection_matrix_field_names="proj",
             transformation_steps=make_steps(A))
    ctx = _recording(pkg)
    for lo, hi, values in script:
        ctx.script_uniform(lo, hi, list(values))
    step.set_random_context(ctx)
    out = step(_sample(pkg, batched))
    leaves = [np.asarray(v) for v in out.get_data()]
    if batched:
        leaves = [v[0] for v in leaves]
    left = {k: v for k, v in ctx._uniform_seqs.items() if v}
    return leaves, ctx.log, left


def _compare(make_steps, script):
    (j_img, j_pts, j_proj), j_log, j_left = _run(jsteps, jpipe, make_steps, script, False)
    (t_img, t_pts, t_proj), t_log, t_left = _run(tsteps, tpipe, make_steps, script, True)
    assert t_log == j_log, "the draws differ in order or range"
    assert not j_left and not t_left, f"scripted values left over: {j_left} / {t_left}"
    for got, want in ((t_proj, j_proj), (t_pts, j_pts)):
        scale = float(np.abs(want).max())
        assert float(np.abs(got.astype(np.float64) - want).max()) <= REL * scale
    assert t_img.dtype == j_img.dtype == np.uint8 and t_img.shape == j_img.shape
    diff = np.abs(t_img.astype(np.int32) - j_img.astype(np.int32))
    assert diff.max() <= 1 and float(np.mean(diff > 0)) <= MAX_SHARE_DIFFERING
    return j_proj[:2, :3], j_log


def _scale(a, s=2.0):
    return a.UniformScaling(1.0, s)


CASES = {
    # a 2x scale about the centre: the scaled image spans x in [-8, 24] and
    # y in [-6, 18], so the shift ranges are (-8, 8) and (-6, 6)
    "shift_inside_xy": (lambda a: [_scale(a), a.ShiftInsideOriginalImage(1.0, True, True)],
                        [(-8.0, 8.0, [3.5]), (-6.0, 6.0, [-2.25])]),
    "shift_inside_x_coin": (lambda a: [_scale(a), a.ShiftInsideOriginalImage(0.5, True, False)],
                            [(-8.0, 8.0, [-7.0]), (-6.0, 6.0, [5.0]), (0.0, 1.0, [0.2])]),
    "shift_inside_coin_fails": (
        lambda a: [_scale(a), a.ShiftInsideOriginalImage(0.5, True, True)],
        [(-8.0, 8.0, [1.0]), (-6.0, 6.0, [1.0]), (0.0, 1.0, [0.7])]),
    "shift_inside_smaller": (lambda a: [_scale(a, 0.5), a.ShiftInsideOriginalImage(1.0, True,
                                                                                     True)],
                             [(-4.0, 4.0, [2.0]), (-3.0, 3.0, [1.5])]),
    "rotation_fixed": (lambda a: [a.Rotation(1.0, 90.0)], []),
    "rotation_fixed_odd": (lambda a: [a.Rotation(1.0, 33.3)], []),
    "rotation_range_coin": (lambda a: [a.Rotation(0.5, -30.0, 30.0)],
                            [(-30.0, 30.0, [17.3]), (0.0, 1.0, [0.1])]),
    "nonuniform_fixed": (lambda a: [a.NonUniformScaling(1.0, [1.2, 0.8])], []),
    "nonuniform_range": (lambda a: [a.NonUniformScaling(0.5, [0.5, 0.9], [1.5, 1.1])],
                         [(0.5, 1.5, [1.37]), (0.9, 1.1, [0.95]), (0.0, 1.0, [0.4])]),
    "nonuniform_equal_bounds": (lambda a: [a.NonUniformScaling(1.0, [1.25, 0.9], [1.25, 1.1])],
                                [(0.9, 1.1, [1.05])]),
    "shear_fixed": (lambda a: [a.Shearing(1.0, [10.0, -5.0])], []),
    "shear_range": (lambda a: [a.Shearing(0.5, [-20.0, -20.0], [20.0, 20.0])],
                    [(-20.0, 20.0, [12.5, -7.75]), (0.0, 1.0, [0.3])]),
    "composition": (lambda a: [a.UniformScaling(0.5, 0.9, 1.1),
                               a.Translation(0.5, [-2.0, -2.0], [2.0, 2.0]),
                               a.Rotation(0.5, -10.0, 10.0), a.Shearing(1.0, [3.0, 1.0])],
                    [(0.9, 1.1, [1.04]), (-2.0, 2.0, [0.5, -1.25]), (-10.0, 10.0, [-4.0]),
                     (0.0, 1.0, [0.1, 0.3, 0.2])]),
}
for _b in ("TOP", "LEFT", "BOTTOM", "RIGHT"):
    CASES[f"align_{_b.lower()}"] = (
        (lambda b: lambda a: [a.UniformScaling(1.0, 0.5), a.Translation(1.0, [1.0, -2.0]),
                              a.ShiftToAlignWithOriginalImageBorder(
                                  1.0, a.ShiftToAlignWithOriginalImageBorder.Border[b])])(_b),
        [])
CASES["align_coin"] = (
    lambda a: [_scale(a, 0.5), a.ShiftToAlignWithOriginalImageBorder(
        0.5, a.ShiftToAlignWithOriginalImageBorder.Border.RIGHT)], [(0.0, 1.0, [0.45])])


@pytest.mark.parametrize("name", sorted(CASES))
def test_transformation_step_matches_jax(name):
    make_steps, script = CASES[name]
    _compare(make_steps, script)


def _selection(a):
    return [a.Selection(
        1.0, option_probs=[0.3, 0.5, 0.2],
        options=[a.Rotation(0.5, -30.0, 30.0),
                 [a.Shearing(1.0, [-20.0, -20.0], [20.0, 20.0]),
                  a.NonUniformScaling(0.5, [0.5, 0.5], [1.5, 1.5])],
                 [a.UniformScaling(1.0, 2.0), a.ShiftInsideOriginalImage(1.0, True, True)]])]


@pytest.mark.parametrize("choice", [0.1, 0.3, 0.6, 0.95])
def test_selection_runs_every_option_and_takes_the_chosen(choice):
    """The choice is drawn first, then every option's steps run and draw in
    order (Rotation's angle and coin, Shearing's two angles, the scaling's
    two factors and coin, the shifts' two ranges), whichever is taken."""
    script = [(0.0, 1.0, [choice, 0.2, 0.9]), (-30.0, 30.0, [25.0]), (-20.0, 20.0, [5.0, -9.0]),
              (0.5, 1.5, [1.3, 0.7]), (-8.0, 8.0, [4.0]), (-6.0, 6.0, [-3.0])]
    trafo, log = _compare(_selection, script)
    assert log[0] == (0.0, 1.0) and len(log) == 10
    # identify the option taken from the transform
    option = 0 if choice <= 0.3 else (1 if choice <= 0.8 else 2)
    single = [
        (lambda a: [a.Rotation(1.0, 25.0)], []),  # the draw 25; its coin 0.2 applies it
        (lambda a: [a.Shearing(1.0, [5.0, -9.0])], []),  # the scaling's coin 0.9 fails
        (lambda a: [_scale(a), a.ShiftInsideOriginalImage(1.0, True, True)],
         [(-8.0, 8.0, [4.0]), (-6.0, 6.0, [-3.0])]),
    ][option]
    want, _ = _compare(*single)
    np.testing.assert_allclose(trafo, want, rtol=0, atol=REL * float(np.abs(want).max()))


def test_selection_probabilities_and_ordering_rules_as_in_jax():
    for mod in (jsteps, tsteps):
        A = mod.AffineTransformer
        with pytest.raises(AssertionError):
            A.Selection(1.0, option_probs=[0.5, 0.2],
                        options=[A.Translation(1.0, [0, 0])] * 2)
        for prior in (A.Rotation(0.5, 10.0), A.Shearing(1.0, [1.0, 1.0]),
                      A.Selection(1.0, [1.0], [A.Rotation(1.0, 10.0)])):
            for after in (A.ShiftInsideOriginalImage(1.0, True, True),
                          A.ShiftToAlignWithOriginalImageBorder(
                              1.0, A.ShiftToAlignWithOriginalImageBorder.Border.TOP)):
                with pytest.raises(ValueError):
                    A(output_hw=(8, 10), resizing_mode=A.ResizingMode.STRETCH,
                      image_hw_field_names="image_hw", transformation_steps=[prior, after])
        A(output_hw=(8, 10), resizing_mode=A.ResizingMode.STRETCH,
          image_hw_field_names="image_hw",
          transformation_steps=[A.NonUniformScaling(1.0, [2.0, 1.0]),
                                A.ShiftInsideOriginalImage(1.0, True, True), A.Rotation(1.0, 5.0)])


def test_per_sample_shift_ranges_on_a_batch():
    """ShiftInsideOriginalImage draws in each sample's own range on a batch
    of two sizes (from ``image_hw``), through the device context (tensor
    bounds): every shift lies within its sample's range, and the card-free
    CPU run is repeatable."""
    A = tsteps.AffineTransformer
    step = A(output_hw=(20, 30), resizing_mode=A.ResizingMode.STRETCH,
             image_hw_field_names="image_hw", point_field_names="points",
             transformation_steps=[A.UniformScaling(1.0, 2.0),
                                   A.ShiftInsideOriginalImage(1.0, True, True)])
    hw = torch.tensor([[12, 16], [20, 40]], dtype=torch.int32)

    def run():
        sdg = tpipe.SampleDataGroup()
        sdg.add_data_field("image_hw", tpipe.DType.INT32)
        sdg.add_data_field("points", tpipe.DType.FLOAT)
        sdg.set_data([hw.clone(), torch.zeros(2, 1, 2)])
        step.set_random_context(tpipe.DeviceRandomContext((0, 5)))
        return step(sdg)["points"][:, 0]

    a, b = run(), run()
    assert torch.equal(a, b)
    # points at the origin: scale 2 about the centre sends (0, 0) to
    # (-w/2, -h/2) of the input; the shift brings it into [-w, 0] x [-h, 0],
    # then the stretch maps the input size onto 30x20
    hwf = hw.to(torch.float32)
    x_in = a[:, 0] / (30.0 / hwf[:, 1])
    y_in = a[:, 1] / (20.0 / hwf[:, 0])
    assert bool(((x_in >= -hwf[:, 1] - 1e-4) & (x_in <= 1e-4)).all())
    assert bool(((y_in >= -hwf[:, 0] - 1e-4) & (y_in <= 1e-4)).all())
