"""Polyline, the lane trainer, the BEV step, ``apply_matrix``'s inverse and
the trace ranges on a card, each against the CPU; and the profiler's launch
count (``tools.launch_counts``) of one known kernel.

Every test here needs an NVIDIA card and skips without one. No JAX is
imported, so the file runs on a card machine without it:
    python -m pytest tests/test_torch_polyline_bev_cuda.py -q

Tolerances are ``chip_smoke``'s: polyline within ``8 * eps_f32 * max total
length``; lane losses within ``LANE_TOL`` relative; the BEV stage within
``BEV_TOL`` relative to each output's largest magnitude.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (BEV_TOL, LANE_TOL, bev_definition, bev_provider, max_abs, poly_tol,
                        polyline_ragged_case)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (polyline, lane, BEV and trace ranges on the card)")
    return torch.device("cuda")


def _sync_free(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
@pytest.mark.parametrize("relative", [False, True])
def test_polyline_card_equals_cpu_without_a_sync(cuda, relative):
    from accvlab_tpu_torch.polyline import interpolate, lengths

    rng = np.random.default_rng(0)
    pts = np.cumsum(rng.uniform(-1, 1, (64, 100, 2)), axis=1).astype(np.float32)
    d = rng.uniform(-0.2, 1.2, (64, 100)).astype(np.float32) * (1.0 if relative else 60.0)
    p, r = torch.from_numpy(pts).to(cuda), torch.from_numpy(d).to(cuda)
    got = _sync_free(lambda: interpolate(p, r, relative=relative))
    want = interpolate(torch.from_numpy(pts), torch.from_numpy(d), relative=relative)
    assert max_abs(got, want) <= poly_tol(pts)
    assert max_abs(lengths(p), lengths(torch.from_numpy(pts))) <= poly_tol(pts)


@pytest.mark.cuda
def test_polyline_var_size_card_equals_cpu(cuda):
    from accvlab_tpu_torch.polyline import interpolate_var_size_batch, lengths_var_size_batch
    from accvlab_tpu_torch.ragged import RaggedBatch

    pts, sizes, rel, dsz = polyline_ragged_case()

    def inputs(device):
        t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        return (RaggedBatch(t(pts), sample_sizes=t(sizes)),
                RaggedBatch(t(rel), sample_sizes=t(dsz)))

    def run(rp, rd):
        return interpolate_var_size_batch(rp, rd, relative=True).tensor, lengths_var_size_batch(rp)

    on_card = inputs(cuda)
    got, want = _sync_free(lambda: run(*on_card)), run(*inputs(torch.device("cpu")))
    for g, w in zip(got, want):
        assert max_abs(g, w) <= poly_tol(pts, sizes)


@pytest.mark.cuda
def test_lane_losses_card_equal_cpu(cuda):
    from accvlab_tpu_torch import lane_regression_training as L
    from accvlab_tpu_torch.models.params import jax_params_of

    params = jax_params_of(L.LaneRegressor(seed=0))
    _, card = L.train(5, 32, 0, device=cuda, params=params)
    _, cpu = L.train(5, 32, 0, device="cpu", params=params)
    np.testing.assert_allclose(card, cpu, rtol=LANE_TOL)


@pytest.mark.cuda
def test_bev_stage_card_equals_cpu_without_a_sync(cuda):
    definition = bev_definition(bev_provider(32, boxes=16, cams=3), batch=4)
    pipe = definition.get_pipeline(batch_size=4, num_threads=2, device=cuda, seed=3)
    cpu = definition.get_pipeline(batch_size=4, num_threads=2, device="cpu", seed=3)
    try:
        idx, _, _, host = pipe._produce_host_batch()
        leaves = pipe._transfer(host)
        pipe.run_device_stage(leaves, idx)
        got = _sync_free(lambda: pipe.run_device_stage(leaves, idx))
        want = cpu.run_device_stage([torch.from_numpy(a) for a in host], idx)
    finally:
        pipe.stop()
        cpu.stop()
    for g, w in zip(got, want):
        assert g.is_cuda and max_abs(g, w) <= BEV_TOL * float(w.abs().max())


@pytest.mark.cuda
def test_apply_matrix_inverse_on_the_card_is_linalg_inv_without_a_sync(cuda):
    from accvlab_tpu_torch.pipeline.operators import apply_matrix

    rng = np.random.default_rng(1)
    mats = torch.from_numpy((rng.normal(size=(8, 4, 4)) + 4 * np.eye(4)).astype(np.float32))
    pts = torch.from_numpy(rng.normal(size=(8, 4, 5)).astype(np.float32))
    m, p = mats.to(cuda), pts.to(cuda)
    got = _sync_free(lambda: apply_matrix(p, m, matrix_is_inverted=True))
    assert torch.equal(torch.linalg.inv_ex(m)[0], torch.linalg.inv(m))
    assert torch.equal(got, torch.linalg.inv(m) @ p)


@pytest.mark.cuda
def test_trace_ranges_on_the_card(cuda):
    from accvlab_tpu_torch.tools import TraceRangeWrapper, range_pop, range_push, register_string

    TraceRangeWrapper._reset_singleton()
    ranges = TraceRangeWrapper()
    ranges.enable(sync_on_push=True, sync_on_pop=True, keep_track_of_range_order=True)
    x = torch.ones(1024, device=cuda)
    ranges.range_push("outer")
    ranges.range_push("inner")
    y = x * 2
    ranges.range_pop("inner")
    ranges.range_pop("outer")
    h = register_string("free")
    range_push(h)
    range_pop()
    ranges.disable()
    TraceRangeWrapper._reset_singleton()
    assert float(y.sum()) == 2048.0


@pytest.mark.cuda
def test_kernel_counts_reads_one_kernel_per_add(cuda):
    from accvlab_tpu_torch.tools.launch_counts import kernel_counts

    a = torch.ones(1024, device=cuda)
    got = kernel_counts(lambda: a + a)
    assert got["kernels"] == 1 and got["memsets"] == 0 and got["copies"] == 0
    assert got["readings"] == [1, 1, 1] and got["busy_ms"] > 0
