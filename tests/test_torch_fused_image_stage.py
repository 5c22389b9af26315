"""The image chain's kernel (``accvlab_tpu_torch::image_chain`` on CUDA
tensors) on a card.

* The kernel against its plain version, the steps' own pixel code on the
  same parameters: bit for bit for every sample whose hue is off; where the
  hue is on, every differing element one 8-bit level apart after the
  normalization (1/std) at most, on at most 1e-4 of the elements (the steps'
  hue is a cuBLAS product whose summation order is not specified). Every
  gate on, off and mixed, warps reaching out of the frame, the identity map,
  one sample and 16, BGR images, and bench.py's six camera fields at their
  full size.
* The fused stage against the steps as written on the card: every other
  output bit for bit, the draw schedule equal.
* The executor's eager and program batches equal, every batch counted in
  ``stats()["fused_stage_batches"]`` and one launch per camera field.

Every test here needs an NVIDIA card and skips without one. No JAX is
imported, so the file runs on a card machine without it:
    python -m pytest tests/test_torch_fused_image_stage.py -q
"""

import numpy as np
import pytest
import torch

from accvlab_tpu_torch.bench_pipeline import build_pipeline
from accvlab_tpu_torch.pipeline.operators import image_chain as op

import test_torch_image_chain as case_mod

#: bench.py's main path: 16 samples of six 372x1024 cameras to 256x704
MAIN = ("main_path", 16, (372, 1024), (256, 704), 0.5, 0.5, False)
CAMS = {"main_path": 6}
OFF_SHARE_MAX = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the image chain kernel has no CPU form)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def check_against_plain(got, want, hue, inv_std):
    """``got`` (the kernel) against ``want`` (the plain version) for one
    field: bitwise where ``hue`` (per sample) is off, else within a level
    on few elements. Returns the differing elements."""
    for b in torch.nonzero(~hue).flatten().tolist():
        assert torch.equal(got[b], want[b]), f"sample {b} (hue off) differs"
    diff = (got - want).abs()
    level = torch.as_tensor(inv_std, device=got.device) * (1 + 1e-5)
    assert bool((diff <= level).all()), float(diff.max())
    return int((diff > 0).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("case", case_mod.CASES + [MAIN], ids=[c[0] for c in case_mod.CASES]
                         + [MAIN[0]])
def test_kernel_against_plain(cuda, case):
    name, b, hw, out_hw, affine_prob, photometric_prob, is_bgr = case
    steps = case_mod.chain_steps(out_hw, affine_prob, photometric_prob, is_bgr)
    blueprint, leaves = case_mod.chain_leaves(b, hw, CAMS.get(name, 2), 5, cuda)
    params, oh_ow, consts = case_mod.chain_params(steps, blueprint, leaves, (3, 9), cuda)
    hue = params[:, 9] != 0
    before = op.LAUNCHES["image_chain"]
    off = total = 0
    for src in leaves[::4]:  # each camera's image
        got = op.image_chain(src, params, *oh_ow, consts)
        want = op.image_chain_plain(src, params, oh_ow, consts)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (b, *oh_ow, 3) and got.dtype == torch.float32
        off += check_against_plain(got, want, hue, consts[8:11])
        total += got.numel()
    assert op.LAUNCHES["image_chain"] - before == len(leaves) // 4
    print(f"{name}: hue on {int(hue.sum())}/{b} samples, off {off}/{total} = {off / total:.3g}")
    assert off / total <= OFF_SHARE_MAX


@pytest.mark.cuda
def test_kernel_does_not_synchronize(cuda):
    steps = case_mod.chain_steps((32, 88), 1.0, 1.0)
    blueprint, leaves = case_mod.chain_leaves(4, (48, 128), 1, 0, cuda)
    params, oh_ow, consts = case_mod.chain_params(steps, blueprint, leaves, (0, 0), cuda)
    op.image_chain(leaves[0], params, *oh_ow, consts)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        op.image_chain(leaves[0], params, *oh_ow, consts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [case_mod.CASES[2], MAIN], ids=["gates_mixed", "main_path"])
def test_fused_stage_against_steps_as_written(cuda, case):
    name, b, hw, out_hw, affine_prob, photometric_prob, is_bgr = case
    steps = case_mod.chain_steps(out_hw, affine_prob, photometric_prob, is_bgr)
    blueprint, leaves = case_mod.chain_leaves(b, hw, CAMS.get(name, 2), 1, cuda)
    params, _, consts = case_mod.chain_params(steps, blueprint, leaves, (4, 2), cuda)
    got, fused, schedule = case_mod.run_chain(steps, blueprint, leaves, (4, 2), cuda, True)
    want, unfused, want_schedule = case_mod.run_chain(steps, blueprint, leaves, (4, 2), cuda,
                                                      False)
    torch.cuda.synchronize()
    assert (fused, unfused) == (CAMS.get(name, 2), 0) and schedule == want_schedule
    assert got.keys() == want.keys()
    off = total = 0
    for k in got:
        if k.endswith(".image"):
            off += check_against_plain(got[k], want[k], params[:, 9] != 0, consts[8:11])
            total += got[k].numel()
        else:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert off / total <= OFF_SHARE_MAX


@pytest.mark.cuda
def test_stage_eager_and_program_equal_and_counted(cuda):
    """bench.py's pipeline on raw frames (small): the delivered batches,
    eager and program, equal the eager stage run again on their leaves;
    every batch fused; two launches a batch (two cameras)."""
    n = 8
    pipe = build_pipeline(batch_size=2, device=cuda, num_threads=2, hw=(96, 256), num_cams=2,
                          out_hw=(64, 176), heatmap_hw=(16, 44), num_samples=2 * n,
                          wire="frames")
    kept = []
    stage = pipe.run_device_stage

    def keep(leaves, batch_idx, echo_i=0):
        kept.append(([x.clone() for x in leaves], batch_idx, echo_i))
        return stage(leaves, batch_idx, echo_i)

    pipe.run_device_stage = keep
    before = op.LAUNCHES["image_chain"]
    try:
        outs = [{k: v.clone() for k, v in pipe.run().items()} for _ in range(n)]
        stats = pipe.stats()
    finally:
        pipe.stop()
    assert stats["fused_stage_batches"] == n
    assert op.LAUNCHES["image_chain"] - before == 2 * n
    assert any(e[2] for e in pipe._stage_specs.values())  # later batches replayed the program
    assert pipe._image_chain is not None
    for (leaves, batch_idx, echo_i), out in zip(kept, outs):
        before = op.LAUNCHES["image_chain"]
        want, _ = pipe._run_eager(leaves, batch_idx, echo_i)
        assert op.LAUNCHES["image_chain"] - before == 2
        for name, a, b in zip(out, out.values(), want):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert np.isfinite(outs[-1]["cameras.[0].image"].float().cpu().numpy()).all()
