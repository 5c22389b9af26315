"""Parity of ``accvlab_tpu_torch.heatmap`` with ``accvlab_tpu.heatmap``.

Every case of ``tests/test_heatmap.py`` and ``tests/test_goldens.py`` runs
through the port's plain PyTorch version on the CPU (the CUDA kernel has no
CPU form); inputs are made with numpy from a seed and go through both
packages. The CUDA kernel's own cases are in ``test_torch_kernels_cuda.py``
(no JAX there, so they run on a card machine without it).

Tolerances: ``exact=True`` is bitwise (the pinned exp). The fast exp differs
by a few ulp between XLA's CPU exp and PyTorch's, so fast-exp comparisons use
rtol 1e-6 (about 8 ulp).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accvlab_tpu.heatmap as jhm
from accvlab_tpu.ragged import RaggedBatch as JRaggedBatch
from accvlab_tpu_torch.heatmap import draw_gaussians, draw_heatmap, draw_heatmap_batched
from accvlab_tpu_torch.heatmap import draw as tdraw
from accvlab_tpu_torch.heatmap import repro_exp as trepro
from accvlab_tpu_torch.ragged import RaggedBatch

GOLDENS = os.path.join(os.path.dirname(__file__), "data", "goldens", "heatmap_goldens.npz")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


def group(goldens, name):
    prefix = name + "/"
    return {k[len(prefix):]: goldens[k] for k in goldens.files if k.startswith(prefix)}


def assert_bitwise(got, want):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    same = got.view(np.int32) == want.view(np.int32)
    assert same.all(), (
        f"{(~same).sum()} / {same.size} pixels differ (max abs diff {np.abs(got - want).max()})"
    )


def golden_draw(heatmap, x, y, radius, factor=6.0, k=1.0):
    """Scalar-loop reference implementing draw_heatmap_cuda_kernel.cuh math."""
    h, w = heatmap.shape
    diameter = 2 * radius + 1
    sigma = diameter / factor
    var = 2.0 * sigma * sigma
    left, right = min(x, radius), min(w - x, radius + 1)
    top, bottom = min(y, radius), min(h - y, radius + 1)
    out = heatmap.copy()
    for i in range(-top, bottom):
        for j in range(-left, right):
            v = np.exp(-(i * i + j * j) / var) * k
            out[y + i, x + j] = max(out[y + i, x + j], v)
    return out


def rb(x, sizes, dtype=np.int32):
    return RaggedBatch(torch.as_tensor(np.asarray(x, dtype)),
                       sample_sizes=torch.as_tensor(np.asarray(sizes, np.int32)))


def jrb(x, sizes, dtype=np.int32):
    return JRaggedBatch(jnp.asarray(np.asarray(x, dtype)),
                        sample_sizes=jnp.asarray(np.asarray(sizes, np.int32)))


def t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------- cases of tests/test_heatmap.py ------------------------ #


def test_batched_matches_golden():
    h, w, batch = 16, 24, 3
    heatmap = np.zeros((batch, h, w), np.float32)
    centers = [[[5, 4], [20, 10], [0, 0]], [[12, 8], [0, 0], [0, 0]], [[3, 15], [22, 2], [10, 10]]]
    radii = [[2, 3, 1], [4, 0, 0], [1, 2, 3]]
    sizes = [2, 1, 3]
    expected = heatmap.copy()
    for b in range(batch):
        for i in range(sizes[b]):
            expected[b] = golden_draw(expected[b], centers[b][i][0], centers[b][i][1], radii[b][i])
    out = draw_heatmap_batched(t(heatmap), rb(centers, sizes), rb(radii, sizes))
    np.testing.assert_allclose(out.numpy(), expected, rtol=3e-5, atol=1e-6)


def test_batched_classwise_matches_golden():
    h, w, nc, batch = 12, 20, 4, 2
    heatmap = np.zeros((batch, nc, h, w), np.float32)
    centers = [[[5, 4], [15, 8]], [[10, 6], [0, 0]]]
    radii = [[2, 3], [4, 0]]
    labels = [[1, 3], [0, 0]]
    sizes = [2, 1]
    expected = heatmap.copy()
    for b in range(batch):
        for i in range(sizes[b]):
            c = labels[b][i]
            expected[b, c] = golden_draw(expected[b, c], centers[b][i][0], centers[b][i][1], radii[b][i])
    out = draw_heatmap_batched(t(heatmap), rb(centers, sizes), rb(radii, sizes),
                               labels=rb(labels, sizes))
    np.testing.assert_allclose(out.numpy(), expected, rtol=3e-5, atol=1e-6)


def test_flat_matches_golden():
    h, w, n_maps = 10, 14, 3
    heatmaps = np.zeros((n_maps, h, w), np.float32)
    centers = np.array([[3, 3], [9, 5], [7, 7], [1, 1]], np.int32)
    radii = np.array([2, 1, 3, 1], np.int32)
    idxes = np.array([0, 2, 0, 1], np.int32)
    expected = heatmaps.copy()
    for i in range(4):
        n = idxes[i]
        expected[n] = golden_draw(expected[n], centers[i][0], centers[i][1], radii[i])
    out = draw_heatmap(t(heatmaps), t(centers), t(radii), t(idxes))
    np.testing.assert_allclose(out.numpy(), expected, rtol=3e-5, atol=1e-6)


def test_overlap_takes_max():
    out = draw_heatmap_batched(torch.zeros(1, 9, 9), rb([[[4, 4], [4, 4]]], [2]), rb([[3, 1]], [2]))
    assert float(out[0, 4, 4]) == pytest.approx(1.0)
    wide_sigma = (2 * 3 + 1) / 6.0
    assert float(out[0, 4, 5]) == pytest.approx(np.exp(-1.0 / (2 * wide_sigma**2)), rel=3e-5)


def test_preserves_existing_values():
    out = draw_heatmap_batched(torch.full((1, 5, 5), 0.9), rb([[[2, 2]]], [1]), rb([[1]], [1]))
    arr = out.numpy()
    assert arr[0, 2, 2] == pytest.approx(1.0)
    assert arr[0, 0, 0] == pytest.approx(0.9)
    assert arr[0, 2, 3] == pytest.approx(0.9)


def test_k_scale_and_factor():
    out = draw_heatmap_batched(torch.zeros(1, 7, 7), rb([[[3, 3]]], [1]), rb([[2]], [1]),
                               diameter_to_sigma_factor=3.0, k_scale=0.5)
    expected = golden_draw(np.zeros((7, 7), np.float32), 3, 3, 2, factor=3.0, k=0.5)
    np.testing.assert_allclose(out[0].numpy(), expected, rtol=3e-5)


def test_empty_targets():
    heatmap = torch.full((2, 4, 4), 0.25)
    out = draw_heatmap_batched(heatmap, rb(np.zeros((2, 3, 2)), [0, 0]), rb(np.zeros((2, 3)), [0, 0]))
    np.testing.assert_array_equal(out.numpy(), heatmap.numpy())


@pytest.mark.parametrize("seed", range(8))
def test_draw_gaussians_fuzz_vs_scalar_and_jax(seed):
    """Random configs of the pipeline variant vs a scalar oracle of the
    DALI-plugin math, and vs the JAX function under jit (segment_max path)
    and its numpy path."""
    rng = np.random.default_rng(900 + seed)
    c = int(rng.integers(1, 4))
    h, w = int(rng.integers(6, 20)), int(rng.integers(6, 24))
    n = int(rng.integers(1, 7))
    active = rng.random(n) < 0.8
    slice_ids = rng.integers(0, c, n).astype(np.int32)
    centers = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], -1).astype(np.int32)
    radii = rng.uniform(0.5, 4.0, n).astype(np.float32)
    ks = rng.uniform(0.5, 1.5, c).astype(np.float32)
    factor = float(rng.uniform(0.3, 1.0))
    hm0 = rng.uniform(0, 0.2, (c, h, w)).astype(np.float32)

    out = draw_gaussians(t(hm0), t(active), t(slice_ids), t(centers), t(radii), ks, factor).numpy()

    expect = hm0.copy()
    for i in range(n):
        if not active[i]:
            continue
        sig = radii[i] * factor
        var = max(2.0 * sig * sig, 1e-12)
        reach = int(np.ceil(radii[i]))
        x0, y0 = int(centers[i, 0]), int(centers[i, 1])
        for yy in range(max(0, y0 - reach), min(h, y0 + reach + 1)):
            for xx in range(max(0, x0 - reach), min(w, x0 + reach + 1)):
                v = ks[slice_ids[i]] * np.exp(-((yy - y0) ** 2 + (xx - x0) ** 2) / var)
                ch = slice_ids[i]
                expect[ch, yy, xx] = max(expect[ch, yy, xx], v)
    np.testing.assert_allclose(out, expect, rtol=3e-5, atol=1e-6)

    jit_out = jax.jit(
        lambda hm, a, s, ce, r: jhm.draw_gaussians(hm, a, s, ce, r, ks, factor)
    )(jnp.asarray(hm0), jnp.asarray(active), jnp.asarray(slice_ids), jnp.asarray(centers),
      jnp.asarray(radii))
    np.testing.assert_allclose(out, np.asarray(jit_out), rtol=1e-6, atol=0)
    np_out = jhm.draw_gaussians(hm0, active, slice_ids, centers, radii, ks, factor)
    np.testing.assert_allclose(out, np.asarray(np_out), rtol=1e-6, atol=0)


def test_draw_gaussians_clamps_ids_and_batches():
    """Out-of-range ids are clamped into a real channel (draw_gaussians.py:71),
    and a batched call equals per-sample calls of the JAX function."""
    rng = np.random.default_rng(5)
    b, c, h, w, n = 3, 4, 12, 16, 6
    hm0 = np.zeros((b, c, h, w), np.float32)
    active = rng.random((b, n)) < 0.9
    ids = rng.integers(-2, c + 2, (b, n)).astype(np.int32)
    centers = np.stack([rng.integers(0, w, (b, n)), rng.integers(0, h, (b, n))], -1).astype(np.int32)
    radii = rng.uniform(0.4, 3.5, (b, n)).astype(np.float32)
    ks = [1.0, 0.8, 1.2, 0.5]
    out = draw_gaussians(t(hm0), t(active), t(ids), t(centers), t(radii), ks, 1.0 / 3.0).numpy()
    for s in range(b):
        ref = jhm.draw_gaussians(jnp.asarray(hm0[s]), jnp.asarray(active[s]), jnp.asarray(ids[s]),
                                 jnp.asarray(centers[s]), jnp.asarray(radii[s]), ks, 1.0 / 3.0)
        np.testing.assert_allclose(out[s], np.asarray(ref), rtol=1e-6, atol=0)


def _random_batched(seed, b, n, h, w, c=None):
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, [w, h], (b, n, 2)).astype(np.int32)
    radii = rng.integers(1, 6, (b, n)).astype(np.int32)
    sizes = rng.integers(0, n + 1, b).astype(np.int32)
    labels = None if c is None else rng.integers(0, c, (b, n)).astype(np.int32)
    hm = (rng.random((b, h, w) if c is None else (b, c, h, w)) * 0.1).astype(np.float32)
    return hm, centers, radii, sizes, labels


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize(
    "shape", [(3, 6, 23, 13), (2, 19, 31, 9), (2, 4, 64, 48)], ids=["partial", "chunks", "wide"]
)
@pytest.mark.parametrize("exact", [False, True])
def test_batched_vs_jax(jimpl, shape, exact):
    """The shapes of the JAX tiled/chunking tests, through both JAX
    implementations (pallas in interpret mode on the CPU)."""
    b, n, h, w = shape
    hm, centers, radii, sizes, _ = _random_batched(sum(shape), b, n, h, w)
    out = draw_heatmap_batched(t(hm), rb(centers, sizes), rb(radii, sizes), exact=exact)
    ref = jhm.draw_heatmap_batched(jnp.asarray(hm), jrb(centers, sizes), jrb(radii, sizes),
                                   implementation=jimpl, exact=exact)
    if exact:
        assert_bitwise(out, np.asarray(ref))
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=0)


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("k_scale", [1.0, 0.5, -0.5])
def test_classwise_and_flat_vs_jax(jimpl, exact, k_scale):
    b, n, c, h, w = 2, 5, 4, 17, 11
    hm, centers, radii, sizes, labels = _random_batched(1, b, n, h, w, c)
    out = draw_heatmap_batched(t(hm), rb(centers, sizes), rb(radii, sizes), k_scale=k_scale,
                               labels=rb(labels, sizes), exact=exact)
    ref = jhm.draw_heatmap_batched(jnp.asarray(hm), jrb(centers, sizes), jrb(radii, sizes),
                                   k_scale=k_scale, labels=jrb(labels, sizes),
                                   implementation=jimpl, exact=exact)
    rng = np.random.default_rng(2)
    n_maps, tt = 3, 7
    hmf = (rng.random((n_maps, h, w)) * 0.1).astype(np.float32)
    cf = rng.integers(0, [w, h], (tt, 2)).astype(np.int32)
    rf = rng.integers(1, 5, (tt,)).astype(np.int32)
    idx = rng.integers(0, n_maps, (tt,)).astype(np.int32)
    outf = draw_heatmap(t(hmf), t(cf), t(rf), t(idx), k_scale=k_scale, exact=exact)
    reff = jhm.draw_heatmap(jnp.asarray(hmf), cf, rf, idx, k_scale=k_scale,
                            implementation=jimpl, exact=exact)
    for got, want in ((out, ref), (outf, reff)):
        if exact:
            assert_bitwise(got, np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_large_heatmap_1024_vs_jax():
    rng = np.random.default_rng(2)
    b, n, h, w = 2, 4, 1024, 1024
    centers = rng.integers(0, [w, h], (b, n, 2)).astype(np.int32)
    radii = rng.integers(5, 40, (b, n)).astype(np.int32)
    sizes = np.array([4, 2], np.int32)
    out = draw_heatmap_batched(torch.zeros(b, h, w), rb(centers, sizes), rb(radii, sizes),
                               exact=True)
    ref = jhm.draw_heatmap_batched(jnp.zeros((b, h, w)), jrb(centers, sizes), jrb(radii, sizes),
                                   implementation="xla", exact=True)
    assert_bitwise(out, np.asarray(ref))


def test_zero_targets_noop():
    hm = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 16, 16)).astype(np.float32))
    out = draw_heatmap(hm, torch.zeros(0, 2, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
                       torch.zeros(0, dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), hm.numpy())
    cb = rb(np.zeros((2, 0, 2)), [0, 0])
    rrb = rb(np.zeros((2, 0)), [0, 0])
    hmb = torch.as_tensor(np.random.default_rng(1).normal(size=(2, 8, 8)).astype(np.float32))
    np.testing.assert_array_equal(draw_heatmap_batched(hmb, cb, rrb).numpy(), hmb.numpy())
    lb = rb(np.zeros((2, 0)), [0, 0])
    hmc = torch.as_tensor(np.random.default_rng(2).normal(size=(2, 4, 8, 8)).astype(np.float32))
    np.testing.assert_array_equal(draw_heatmap_batched(hmc, cb, rrb, labels=lb).numpy(), hmc.numpy())
    out0 = draw_heatmap_batched(hmc, cb, rrb, labels=lb, k_scale=0.0)
    np.testing.assert_array_equal(out0.numpy(), hmc.numpy())


@pytest.mark.parametrize("bad_idx", [-1, 3, 99])
def test_flat_out_of_range_idx_raises_eager(bad_idx):
    with pytest.raises(ValueError, match="heatmap_idxes out of range"):
        draw_heatmap(torch.zeros(3, 8, 12), t([[4, 4], [6, 2]]), t([1, 2]), t([0, bad_idx]))


@pytest.mark.parametrize("bad_label", [-2, 4, 7])
def test_classwise_out_of_range_label_raises_eager(bad_label):
    with pytest.raises(ValueError, match="labels out of range"):
        draw_heatmap_batched(torch.zeros(1, 4, 8, 12), rb([[[4, 4], [6, 2]]], [2]),
                             rb([[1, 2]], [2]), labels=rb([[0, bad_label]], [2]))


def test_classwise_garbage_padding_labels_allowed():
    out = draw_heatmap_batched(torch.zeros(1, 4, 8, 12), rb([[[4, 4], [6, 2]]], [1]),
                               rb([[1, 2]], [1]), labels=rb([[2, 99]], [1]))
    expected = golden_draw(np.zeros((8, 12), np.float32), 4, 4, 1)
    np.testing.assert_allclose(out[0, 2].numpy(), expected, rtol=3e-5, atol=1e-6)
    assert out[0, [0, 1, 3]].max().item() == 0.0


def test_out_of_range_ids_masked_when_not_validated():
    """Ids that are never read back (device-resident) draw nothing: the
    rasterizer's selection matches no map (parity: the JAX jit cases)."""
    hm = torch.zeros(1, 3, 8, 12)
    nums = torch.tensor([2], dtype=torch.int32)
    xs, ys, rr, iv = tdraw._prep_target_params(t([[[4, 4], [6, 2]]]), t([[1, 2]]), nums, 6.0)
    with_bad = tdraw.raster_plain(hm, xs, ys, rr, iv, t([[0, 99]]).int(), None, 1.0, False, True)
    only_first = tdraw.raster_plain(hm, xs, ys, rr, iv, t([[0, -1]]).int(), None, 1.0, False, True)
    ref = draw_heatmap(torch.zeros(1, 8, 12), t([[4, 4]]), t([1]), t([0]))
    np.testing.assert_array_equal(with_bad[0, 0].numpy(), ref[0].numpy())
    np.testing.assert_array_equal(with_bad.numpy(), only_first.numpy())
    assert with_bad[0, 1:].max().item() == 0.0


def test_negative_k_scale_falls_back_and_matches_golden():
    h, w = 10, 14
    heatmap = np.full((1, h, w), 0.25, np.float32)
    centers = [[[5, 4], [9, 6]]]
    radii = [[2, 3]]
    expected = heatmap.copy()
    for i in range(2):
        expected[0] = golden_draw(expected[0], centers[0][i][0], centers[0][i][1], radii[0][i], k=-0.5)
    out = draw_heatmap_batched(t(heatmap), rb(centers, [2]), rb(radii, [2]), k_scale=-0.5)
    np.testing.assert_allclose(out.numpy(), expected, rtol=3e-5, atol=1e-6)


def test_implementation_selection():
    hm = torch.zeros(1, 6, 6)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        draw_heatmap_batched(hm, rb([[[2, 2]]], [1]), rb([[1]], [1]), implementation="kernel")
    with pytest.raises(ValueError, match="implementation must be one of"):
        draw_heatmap_batched(hm, rb([[[2, 2]]], [1]), rb([[1]], [1]), implementation="pallas")
    a = draw_heatmap_batched(hm, rb([[[2, 2]]], [1]), rb([[1]], [1]), implementation="torch")
    b = draw_heatmap_batched(hm, rb([[[2, 2]]], [1]), rb([[1]], [1]), implementation="auto")
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------- cases of tests/test_goldens.py ------------------------ #

BATCHED_CASES = ["batched_ref_shape", "batched_large_radii", "batched_factor3_k05"]


def _golden_batched(g, device, implementation="auto", exact=True, hm=None):
    cb = RaggedBatch(t(g["centers"]).to(device), sample_sizes=t(g["sizes"]).to(device))
    rrb = RaggedBatch(t(g["radii"]).to(device), sample_sizes=t(g["sizes"]).to(device))
    hm = torch.zeros(g["heatmap"].shape, device=device) if hm is None else hm
    return draw_heatmap_batched(hm, cb, rrb, diameter_to_sigma_factor=float(g["factor"]),
                                k_scale=float(g["k_scale"]), implementation=implementation,
                                exact=exact)


def _golden_classwise(g, device, implementation="auto", exact=True):
    sizes = t(g["sizes"]).to(device)
    return draw_heatmap_batched(
        torch.zeros(g["heatmap"].shape, device=device),
        RaggedBatch(t(g["centers"]).to(device), sample_sizes=sizes),
        RaggedBatch(t(g["radii"]).to(device), sample_sizes=sizes),
        labels=RaggedBatch(t(g["labels"]).to(device), sample_sizes=sizes),
        diameter_to_sigma_factor=float(g["factor"]), k_scale=float(g["k_scale"]),
        implementation=implementation, exact=exact,
    )


def _golden_flat(g, device, implementation="auto", exact=True):
    return draw_heatmap(
        torch.zeros(g["heatmap"].shape, device=device), t(g["centers"]).to(device),
        t(g["radii"]).to(device), t(g["idxes"]).to(device),
        diameter_to_sigma_factor=float(g["factor"]), k_scale=float(g["k_scale"]),
        implementation=implementation, exact=exact,
    )


@pytest.mark.parametrize("case", BATCHED_CASES)
def test_batched_bitwise_vs_golden(goldens, case):
    g = group(goldens, case)
    assert_bitwise(_golden_batched(g, CPU), g["heatmap"])


def test_classwise_bitwise_vs_golden(goldens):
    g = group(goldens, "classwise")
    assert_bitwise(_golden_classwise(g, CPU), g["heatmap"])


def test_flat_bitwise_vs_golden(goldens):
    g = group(goldens, "flat")
    assert_bitwise(_golden_flat(g, CPU), g["heatmap"])


def test_drawing_onto_nonzero_heatmap_bitwise(goldens):
    g = group(goldens, "batched_ref_shape")
    once = _golden_batched(g, CPU)
    assert_bitwise(_golden_batched(g, CPU, hm=once), g["heatmap"])


def test_fast_default_close_to_golden(goldens):
    g = group(goldens, "batched_ref_shape")
    out = _golden_batched(g, CPU, exact=False)
    np.testing.assert_allclose(out.numpy(), g["heatmap"], atol=1e-5, rtol=1e-5)


def test_exp_f32_twins_bitwise():
    """The torch exp/div equal their numpy twins (which the goldens use) and
    the JAX package's, bit for bit."""
    from accvlab_tpu.heatmap import repro_exp as jrepro

    x = -np.random.default_rng(0).uniform(0, 100, 4096).astype(np.float32)
    x[:4] = [0.0, -87.0, -87.5, -1e-8]
    assert_bitwise(trepro.exp_f32(t(x)), trepro.exp_f32_np(x))
    assert_bitwise(trepro.exp_f32(t(x)), np.asarray(jrepro.exp_f32(jnp.asarray(x))))
    a = np.random.default_rng(1).uniform(0.1, 50, 512).astype(np.float32)
    b = np.random.default_rng(2).uniform(0.1, 50, 512).astype(np.float32)
    assert_bitwise(trepro.div_f32(t(a), t(b)), jrepro.div_f32_np(a, b))


# ---------------- the CUDA wrapper's own checks, on the CPU -------------- #


def _gauss_inputs(b=2, c=3, h=8, w=12, n=4):
    rng = np.random.default_rng(4)
    return (torch.zeros(b, c, h, w), t(rng.random((b, n)) < 0.9),
            t(rng.integers(0, c, (b, n)).astype(np.int32)),
            t(np.stack([rng.integers(0, w, (b, n)), rng.integers(0, h, (b, n))], -1)
              .astype(np.int32)), t(rng.uniform(0.5, 3.0, (b, n)).astype(np.float32)))


def test_kernel_implementation_on_cpu_raises_for_every_entry_point():
    """``implementation="kernel"`` demands the card: a CPU tensor raises and
    never falls back to the plain version."""
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        draw_gaussians(*_gauss_inputs(), [1.0] * 3, 1.0 / 3.0, implementation="kernel")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        draw_heatmap(torch.zeros(2, 8, 12), t([[4, 4]]), t([1]), t([0]), implementation="kernel")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        draw_heatmap_batched(torch.zeros(1, 3, 8, 12), rb([[[4, 4]]], [1]), rb([[1]], [1]),
                             labels=rb([[2]], [1]), implementation="kernel")


def test_launch_checks_arguments_before_the_device():
    """Type, shape and contiguity are checked first; well-formed CPU tensors
    then raise because the kernel takes CUDA tensors only."""
    from accvlab_tpu_torch.heatmap import LAUNCHES, _kernel

    hm, active, ids, centers, radii = _gauss_inputs()
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        _kernel.launch_gaussians("bare", hm, active, ids, centers, radii, [1.0] * 3, 0.3, False)
    with pytest.raises(ValueError, match="radii: expected a contiguous torch.float32"):
        _kernel.launch_gaussians("bare", hm, active, ids, centers, radii.double(), [1.0] * 3,
                                 0.3, False)
    with pytest.raises(ValueError, match="active: expected"):
        _kernel.launch_gaussians("bare", hm, active.int(), ids, centers, radii, [1.0] * 3, 0.3,
                                 False)
    with pytest.raises(ValueError, match="centers: expected"):
        _kernel.launch_draw("bare", hm, centers.transpose(0, 1), ids, None, None, 6.0, 1.0,
                            False, True)
    with pytest.raises(ValueError, match="num_valid: expected"):
        _kernel.launch_draw("bare", hm, centers, ids, t([1, 2, 3]).int(), None, 6.0, 1.0,
                            False, True)
    with pytest.raises(ValueError, match="sel: expected"):
        _kernel.launch_draw("bare", hm, centers, ids, None, ids.long(), 6.0, 1.0, False, True)
    with pytest.raises(ValueError, match="heatmap must be a float32"):
        _kernel.launch_draw("bare", hm[0], centers, ids, None, None, 6.0, 1.0, False, True)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        _kernel.launch_draw("bare", hm, centers, ids, t([1, 4]).int(), ids, 6.0, 1.0, False, True)
    assert LAUNCHES == before


@pytest.mark.parametrize("tile", [(8, 16), (8, 3, 1), (16, 32, 1), (8, 16, 3), (0, 32, 1)])
def test_launch_rejects_bad_tiles(tile):
    from accvlab_tpu_torch.heatmap import _kernel

    hm, active, ids, centers, radii = _gauss_inputs()
    with pytest.raises(ValueError, match="tile"):
        _kernel.launch_gaussians("bare", hm, active, ids, centers, radii, [1.0] * 3, 0.3, False,
                                 tile)


def test_peak_table_cap_and_length():
    """The per-class peaks go to the kernel by value: at most MAX_CLASSES
    classes, at least one peak per class, extra peaks ignored."""
    from accvlab_tpu_torch.heatmap import _kernel

    k = _kernel.peak_table([1.0, 0.5, 2.0, 7.0], 3)
    assert k.dtype == np.float32 and k.tolist() == [1.0, 0.5, 2.0]
    assert _kernel.peak_table(np.float64(0.1) * np.ones(5), 5)[0] == np.float32(0.1)
    with pytest.raises(ValueError, match="2 entries for 3 classes"):
        _kernel.peak_table([1.0, 0.5], 3)
    with pytest.raises(ValueError, match="at most 256 classes"):
        _kernel.peak_table([1.0] * 300, _kernel.MAX_CLASSES + 1)


def test_plain_draw_gaussians_takes_more_classes_than_the_kernel():
    """The cap is the kernel's alone: the plain version draws 300 classes."""
    b, c, h, w, n = 1, 300, 4, 6, 3
    hm = torch.zeros(b, c, h, w)
    out = draw_gaussians(hm, t(np.ones((b, n), bool)), t(np.array([[0, 150, 299]], np.int32)),
                         t(np.array([[[1, 1], [2, 2], [5, 3]]], np.int32)),
                         t(np.full((b, n), 1.5, np.float32)), [1.0] * c, 1.0 / 3.0)
    assert [float(out[0, i].max()) for i in (0, 150, 299, 1)] == [1.0, 1.0, 1.0, 0.0]


def test_flat_plain_with_all_targets_valid_matches_explicit_counts():
    """The flat form passes no counts (every target valid); the plain
    preparation gives the same targets as with an explicit full count."""
    centers, radii = t([[[4, 4], [6, 2], [1, 7]]]).int(), t([[1, 2, 0]]).int()
    full = tdraw._prep_target_params(centers, radii, t([3]).int(), 6.0)
    none = tdraw._prep_target_params(centers, radii, None, 6.0)
    for a, b in zip(full, none):
        assert torch.equal(a, b)


def test_tile_follows_the_grid_and_the_targets():
    """Many targets per sample take 256-thread blocks (half the chunks to
    cull); a grid under two blocks per SM takes the small tile; else TILE."""
    from accvlab_tpu_torch.heatmap import _kernel

    assert _kernel.choose_tile(480, 64, 176, 32, 132) == _kernel.TILE  # the main path
    assert _kernel.choose_tile(48, 64, 176, 32, 132) == _kernel.TILE  # 576 blocks
    assert _kernel.choose_tile(48, 20, 50, 50, 132) == _kernel.TILE_SMALL_GRID  # 96 blocks
    assert _kernel.choose_tile(960, 20, 50, 50, 132) == _kernel.TILE
    assert _kernel.choose_tile(48, 64, 176, 1536, 132) == _kernel.TILE_MANY_TARGETS
    assert _kernel.choose_tile(1, 1, 1, 129, 132) == _kernel.TILE_MANY_TARGETS
    for tile in (_kernel.TILE, _kernel.TILE_SMALL_GRID, _kernel.TILE_MANY_TARGETS):
        assert tile[0] * tile[1] % 32 == 0 and tile[0] * tile[1] <= 256 and tile[2] in (1, 2, 4)
