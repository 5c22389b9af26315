"""``AffineTransformer`` with per-sample sizes, against the JAX step.

A batch of two samples whose sources differ in size (40x96 and 56x128),
padded to one shape, with each true size in ``image_hw``. The JAX step reads
``image_hw`` per sample under ``vmap`` and builds each sample's resize from
it (``affine_transformer.py:468-512``); the port builds the ``(B, 2, 3)``
matrices from the ``(B, 2)`` tensor at once, with no read back to the host.
Both run with the same scripted randomness, with and without
``UniformScaling`` + ``Translation``, in every resizing mode.

Checked against the JAX step, sample by sample: the transform matrices
(within 1e-6 relative to the largest entry), the points and projection
matrices it moves (1e-6 relative to their largest magnitude), and the
rewritten ``image_hw`` (equal). The JAX step warps no image when it takes
its sizes from ``image_hw`` (images are then not among its fields), so the
padded images are warped with each side's transform through each package's
``warp_affine``: uint8 within 1, at most 1 % of values differing (XLA may
contract a multiply-add that PyTorch rounds twice).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accvlab_tpu.pipeline as jpipe
import accvlab_tpu.pipeline.processing_steps as jsteps
import accvlab_tpu_torch.pipeline as tpipe
import accvlab_tpu_torch.pipeline.processing_steps as tsteps
from accvlab_tpu.pipeline.operators.image_ops import warp_affine as jwarp
from accvlab_tpu_torch.pipeline.operators.image_ops import warp_affine as twarp

SIZES = [(40, 96), (56, 128)]
PAD_HW = (56, 128)
OUT_HW = (48, 112)
B = len(SIZES)

#: the draws in order, popped per range: the scale, its gate, the
#: translation's x and y, its gate (a gate below 0.5 applies its step)
SCRIPT = [("uniform", 0.9, 1.1, [1.07]), ("uniform", 0.0, 1.0, [0.1, 0.2]),
          ("uniform", -16.0, 16.0, [-11.5, 6.25])]
MODES = [("STRETCH", None), ("PAD", "CENTER"), ("PAD", "TOP_OR_LEFT"),
         ("CROP", "BOTTOM_OR_RIGHT"), ("CROP", "CENTER")]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def scripted(pkg, script):
    ctx = pkg.ScriptedRandomContext()
    for kind, lo, hi, values in script:
        getattr(ctx, f"script_{kind}")(lo, hi, list(values))
    return ctx


def make_step(pkg, mode, anchor, augment):
    a = pkg.AffineTransformer
    steps = [a.UniformScaling(0.5, 0.9, 1.1), a.Translation(0.5, [-16.0, -16.0], [16.0, 16.0])]
    return a(output_hw=OUT_HW, resizing_mode=a.ResizingMode[mode],
             resizing_anchor=a.ResizingAnchor[anchor] if anchor else None,
             image_hw_field_names="image_hw", projection_matrix_field_names="proj",
             point_field_names="pts", transformation_steps=steps if augment else None)


def group(pkg):
    sdg = pkg.SampleDataGroup()
    sdg.add_data_field("image_hw", pkg.DType.INT32)
    sdg.add_data_field("pts", pkg.DType.FLOAT)
    sdg.add_data_field("proj", pkg.DType.FLOAT)
    return sdg


def inputs(seed=0):
    """Per sample: its image (noise inside its true size, zeros in the
    padding), ``image_hw``, 6 rows of two (x, y) points inside it, and a 3x4
    projection matrix."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((B, *PAD_HW, 3), np.uint8)
    pts, proj = [], []
    for i, (h, w) in enumerate(SIZES):
        imgs[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
        pts.append((rng.uniform(0, 1, (6, 4)) * [w, h, w, h]).astype(np.float32))
        proj.append(rng.normal(size=(3, 4)).astype(np.float32) * 100)
    return imgs, np.asarray(SIZES, np.int32), np.stack(pts), np.stack(proj)


def rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("mode,anchor", MODES)
def test_mixed_sizes_match_jax(mode, anchor, augment):
    imgs, hw, pts, proj = inputs()
    script = SCRIPT if augment else []

    jstep = make_step(jsteps, mode, anchor, augment)
    want = {"mat": [], "pts": [], "proj": [], "image_hw": [], "image": []}
    for i in range(B):
        jstep.set_random_context(scripted(jpipe, script))
        want["mat"].append(np.asarray(jstep._get_transformation(jnp.asarray(hw[i]), jnp)))
        sdg = group(jpipe)
        sdg.set_data([jnp.asarray(hw[i]), jnp.asarray(pts[i]), jnp.asarray(proj[i])])
        jstep.set_random_context(scripted(jpipe, script))
        out = jstep(sdg)
        for k in ("image_hw", "pts", "proj"):
            want[k].append(np.asarray(out[k]))
        want["image"].append(np.asarray(jwarp(jnp.asarray(imgs[i]), jnp.asarray(want["mat"][i]),
                                              OUT_HW)))
    want = {k: np.stack(v) for k, v in want.items()}

    tstep = make_step(tsteps, mode, anchor, augment)
    tstep.set_random_context(scripted(tpipe, script))
    mat = tstep._get_transformation(torch.as_tensor(hw).to(torch.float32)).numpy()
    sdg = group(tpipe)
    sdg.set_data([torch.as_tensor(x) for x in (hw, pts, proj)])
    tstep.set_random_context(scripted(tpipe, script))
    out = tstep(sdg)
    image = twarp(torch.as_tensor(imgs), torch.as_tensor(mat), OUT_HW).numpy()

    assert mat.shape == (B, 2, 3)
    for i in range(B):
        assert rel(mat[i], want["mat"][i]) <= 1e-6, (i, mat[i], want["mat"][i])
        assert rel(out["pts"][i].numpy(), want["pts"][i]) <= 1e-6
        assert rel(out["proj"][i].numpy(), want["proj"][i]) <= 1e-6
    # the two samples got different resizes: one shared size could not pass
    assert not np.allclose(mat[0], mat[1])
    np.testing.assert_array_equal(out["image_hw"].numpy(), want["image_hw"])
    assert out["image_hw"].dtype == torch.int32
    d = np.abs(image.astype(np.int32) - want["image"].astype(np.int32))
    assert d.max() <= 1 and float((d > 0).mean()) <= 0.01, (d.max(), float((d > 0).mean()))


def test_sizes_from_images_unchanged_by_the_tensor_path():
    """The main path takes its size from the images: the matrices built from
    a ``(B, 2)`` tensor of that size equal those of an ``image_hw`` field
    holding it, bit for bit."""
    a = tsteps.AffineTransformer
    steps = [a.UniformScaling(0.5, 0.9, 1.1), a.Translation(0.5, [-16.0, -16.0], [16.0, 16.0])]
    imgs = inputs()[0]
    from_images = a(output_hw=OUT_HW, resizing_mode=a.ResizingMode.STRETCH,
                    image_field_names="image", transformation_steps=steps)
    sdg = tpipe.SampleDataGroup()
    sdg.add_data_field("image", tpipe.DType.UINT8)
    sdg["image"] = torch.as_tensor(imgs)
    from_images.set_random_context(scripted(tpipe, SCRIPT))
    got = from_images(sdg)["image"]
    hw = torch.tensor([PAD_HW] * B, dtype=torch.float32)
    from_images.set_random_context(scripted(tpipe, SCRIPT))
    mat = from_images._get_transformation(hw)
    want = twarp(torch.as_tensor(imgs), mat, OUT_HW)
    assert torch.equal(got, want)
