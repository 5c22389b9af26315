"""The CUDA rasterizer (``accvlab_tpu_torch/heatmap/csrc/draw_heatmap.cu``)
against its plain PyTorch version and the committed goldens, on a card.

Every test here needs an NVIDIA card and skips without one (the kernel has
no CPU form). No JAX is imported, so the file runs on a card machine without
it:  python -m pytest tests/test_torch_kernels_cuda.py -q

Tolerances: bitwise for ``exact=True`` (the pinned exp); rtol 1e-6 for the
fast exp (``expf`` in the kernel against ``torch.exp``).
"""

import os

import numpy as np
import pytest
import torch

from accvlab_tpu_torch.heatmap import draw_gaussians, draw_heatmap, draw_heatmap_batched
from accvlab_tpu_torch.ragged import RaggedBatch
from chip_smoke import EDGE_CASES, edge_case, matches_plain

GOLDENS = os.path.join(os.path.dirname(__file__), "data", "goldens", "heatmap_goldens.npz")
BATCHED_CASES = ["batched_ref_shape", "batched_large_radii", "batched_factor3_k05"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU form)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


def group(goldens, name):
    prefix = name + "/"
    return {k[len(prefix):]: goldens[k] for k in goldens.files if k.startswith(prefix)}


def t(x, device):
    return torch.as_tensor(np.asarray(x)).to(device)


def assert_bitwise(got, want):
    got = got.cpu().numpy().astype(np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    same = got.view(np.int32) == want.view(np.int32)
    assert same.all(), f"{(~same).sum()} / {same.size} pixels differ"


def run_golden(g, case, device, implementation, exact):
    kw = dict(diameter_to_sigma_factor=float(g["factor"]), k_scale=float(g["k_scale"]),
              implementation=implementation, exact=exact)
    hm = torch.zeros(g["heatmap"].shape, device=device)
    if case == "flat":
        return draw_heatmap(hm, t(g["centers"], device), t(g["radii"], device),
                            t(g["idxes"], device), **kw)
    sizes = t(g["sizes"], device)
    labels = (RaggedBatch(t(g["labels"], device), sample_sizes=sizes)
              if case == "classwise" else None)
    return draw_heatmap_batched(hm, RaggedBatch(t(g["centers"], device), sample_sizes=sizes),
                                RaggedBatch(t(g["radii"], device), sample_sizes=sizes),
                                labels=labels, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BATCHED_CASES + ["classwise", "flat"])
@pytest.mark.parametrize("exact", [True, False])
def test_kernel_vs_plain_and_goldens(goldens, cuda, case, exact):
    g = group(goldens, case)
    got = run_golden(g, case, cuda, "kernel", exact)
    plain = run_golden(g, case, cuda, "torch", exact)
    torch.cuda.synchronize()
    if exact:
        assert_bitwise(got, plain.cpu().numpy())
        assert_bitwise(got, g["heatmap"])
    else:
        np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(), rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
def test_gaussians_kernel_vs_plain(cuda, exact):
    rng = np.random.default_rng(7)
    b, c, h, w, n = 8, 10, 64, 176, 32
    active = t(rng.random((b, n)) < 0.9, cuda)
    ids = t(rng.integers(-1, c + 1, (b, n)).astype(np.int32), cuda)
    centers = t(np.stack([rng.integers(0, w, (b, n)), rng.integers(0, h, (b, n))], -1)
                .astype(np.int32), cuda)
    radii = t(rng.uniform(0.5, 10.0, (b, n)).astype(np.float32), cuda)
    hm = torch.zeros(b, c, h, w, device=cuda)
    args = (hm, active, ids, centers, radii, [1.0] * c, 1.0 / 3.0)
    got = draw_gaussians(*args, implementation="kernel", exact=exact)
    plain = draw_gaussians(*args, implementation="torch", exact=exact)
    torch.cuda.synchronize()
    if exact:
        assert_bitwise(got, plain.cpu().numpy())
    else:
        np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(), rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_kernel_mask_out_of_range_and_noncontiguous(cuda):
    """Device-resident bad labels draw nothing (never read back), and the
    wrapper takes non-contiguous inputs."""
    hm = torch.zeros(2, 3, 16, 20, device=cuda)
    centers = t([[[4, 4], [9, 9]], [[3, 5], [12, 8]]], cuda).transpose(0, 1).transpose(0, 1)
    radii = t([[2, 3], [1, 2]], cuda)
    sizes = t([2, 2], cuda)
    labels = t([[0, 7], [-3, 2]], cuda)
    args = (hm, RaggedBatch(centers, sample_sizes=sizes), RaggedBatch(radii, sample_sizes=sizes))
    got = draw_heatmap_batched(*args, labels=RaggedBatch(labels, sample_sizes=sizes),
                               implementation="kernel")
    plain = draw_heatmap_batched(*args, labels=RaggedBatch(labels, sample_sizes=sizes),
                                 implementation="torch")
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), plain.cpu().numpy())
    assert float(got[1, :2].max()) == 0.0 and float(got[0, 1:].max()) == 0.0


@pytest.mark.cuda
def test_launch_counter_counts_real_launches_only(cuda):
    """An entry point counts one launch under its own name; an empty map
    launches nothing and counts nothing; direct launches count as "bare"."""
    from accvlab_tpu_torch.heatmap import LAUNCHES, _kernel, reset_launch_counts

    sizes = t([1], cuda)
    centers = RaggedBatch(t([[[3, 4]]], cuda), sample_sizes=sizes)
    radii = RaggedBatch(t([[2]], cuda), sample_sizes=sizes)
    reset_launch_counts()
    draw_heatmap_batched(torch.zeros(1, 8, 8, device=cuda), centers, radii,
                         implementation="kernel")
    draw_heatmap_batched(torch.zeros(1, 0, 8, device=cuda), centers, radii,
                         implementation="kernel")
    i = torch.zeros(1, 1, dtype=torch.int32, device=cuda)
    _kernel.launch_draw("bare", torch.zeros(1, 1, 4, 4, device=cuda), torch.zeros(
        1, 1, 2, dtype=torch.int32, device=cuda), i, None, None, 6.0, 1.0, False, True)
    torch.cuda.synchronize()
    assert LAUNCHES["draw_heatmap_batched"] == 1
    assert LAUNCHES["bare"] == 1
    assert sum(LAUNCHES.values()) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
@pytest.mark.parametrize("exact", [True, False])
def test_kernel_edge_cases_vs_plain(cuda, name, exact):
    """The tiled kernel's cull at its edges (``chip_smoke.EDGE_CASES``): boxes
    larger than the tile and the map, centres outside, reach -0.0 / NaN /
    inf, widths 175 and 1, H = 1, 5,000 targets, one class only, bad ids on
    the card, non-positive peaks."""
    call = edge_case(name, cuda)
    got, plain = call("kernel", exact), call("torch", exact)
    torch.cuda.synchronize()
    assert matches_plain(got, plain, exact), f"{int((got != plain).sum())} pixels differ"


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(8, 4, 1), (8, 32, 1), (32, 8, 2), (64, 4, 4), (1, 32, 2),
                                  (16, 8, 4)])
def test_kernel_any_tile_vs_plain(cuda, tile):
    """Every tile shape the launch takes gives the plain version's bits."""
    from accvlab_tpu_torch.heatmap import _kernel

    rng = np.random.default_rng(11)
    b, c, h, w, n = 4, 3, 30, 90, 40
    active = t(rng.random((b, n)) < 0.9, cuda)
    ids = t(rng.integers(0, c, (b, n)).astype(np.int32), cuda)
    centers = t(np.stack([rng.integers(-10, w + 10, (b, n)), rng.integers(-10, h + 10, (b, n))],
                         -1).astype(np.int32), cuda)
    radii = t(rng.uniform(0.5, 25.0, (b, n)).astype(np.float32), cuda)
    hm = torch.zeros(b, c, h, w, device=cuda)
    got = _kernel.launch_gaussians("bare", hm, active, ids, centers, radii, [1.0, 0.5, 2.0],
                                   0.3, True, tile)
    plain = draw_gaussians(hm, active, ids, centers, radii, [1.0, 0.5, 2.0], 0.3,
                           implementation="torch", exact=True)
    torch.cuda.synchronize()
    assert_bitwise(got, plain.cpu().numpy())


@pytest.mark.cuda
def test_draw_gaussians_makes_no_blocking_copy(cuda):
    """With every input on the card, draw_gaussians neither copies between
    host and card nor waits for the card (the peaks travel by value)."""
    rng = np.random.default_rng(3)
    b, c, h, w, n = 6, 10, 64, 176, 32
    args = (torch.zeros(b, c, h, w, device=cuda), t(rng.random((b, n)) < 0.9, cuda),
            t(rng.integers(0, c, (b, n)).astype(np.int32), cuda),
            t(np.stack([rng.integers(0, w, (b, n)), rng.integers(0, h, (b, n))], -1)
              .astype(np.int32), cuda),
            t(rng.uniform(0.5, 10.0, (b, n)).astype(np.float32), cuda), [1.0] * c, 1.0 / 3.0)
    draw_gaussians(*args, implementation="kernel")  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = draw_gaussians(*args, implementation="kernel")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert float(out.max()) == 1.0


def _gaussian_args(device, b=4, c=10, h=64, w=176, n=32, seed=11):
    rng = np.random.default_rng(seed)
    return (torch.zeros(b, c, h, w, device=device),
            t(rng.random((b, n)) < 0.9, device),
            t(rng.integers(0, c, (b, n)).astype(np.int32), device),
            t(np.stack([rng.integers(0, w, (b, n)), rng.integers(0, h, (b, n))], -1)
              .astype(np.int32), device),
            t(rng.uniform(0.5, 10.0, (b, n)).astype(np.float32), device))


@pytest.mark.cuda
def test_registered_op_vs_plain_and_counts_its_launch(cuda):
    """``accvlab_tpu_torch::draw_gaussians`` on CUDA tensors launches the
    kernel (one count per call) and equals the plain version bitwise with
    the pinned exp."""
    from accvlab_tpu_torch.heatmap import LAUNCHES, reset_launch_counts
    from accvlab_tpu_torch.heatmap._ops import draw_gaussians_op

    hm, active, ids, centers, radii = _gaussian_args(cuda)
    peaks = [1.0 + 0.1 * i for i in range(10)]
    reset_launch_counts()
    got = draw_gaussians_op(hm, active, ids, centers, radii, peaks, 1.0 / 3.0, True)
    assert LAUNCHES["draw_gaussians"] == 1
    plain = draw_gaussians(hm, active, ids, centers, radii, peaks, 1.0 / 3.0,
                           implementation="torch", exact=True)
    torch.cuda.synchronize()
    assert_bitwise(got, plain.cpu().numpy())


@pytest.mark.cuda
def test_registered_op_under_torch_export(cuda):
    """A program exported on CUDA tensors calls the operator, which runs the
    kernel: bitwise the plain version, one launch per call."""
    from accvlab_tpu_torch.heatmap import LAUNCHES, reset_launch_counts
    from accvlab_tpu_torch.models.serving import custom_ops_of

    args = _gaussian_args(cuda)

    class Draw(torch.nn.Module):
        def forward(self, hm, active, ids, centers, radii):
            return draw_gaussians(hm, active, ids, centers, radii, [1.0] * 10, 0.25, exact=True)

    ep = torch.export.export(Draw(), args)
    assert custom_ops_of(ep) == ["accvlab_tpu_torch::draw_gaussians"]
    reset_launch_counts()
    got = ep.module()(*args)
    assert LAUNCHES["draw_gaussians"] == 1
    plain = draw_gaussians(*args, [1.0] * 10, 0.25, implementation="torch", exact=True)
    torch.cuda.synchronize()
    assert_bitwise(got, plain.cpu().numpy())
