"""The training path on a card: determinism, no host synchronisation, and
agreement with the CPU.

Every test here needs an NVIDIA card and skips without one. No JAX is
imported, so the file runs on a card machine without it:
    python -m pytest tests/test_torch_train_cuda.py -q

Tolerances: the ragged ops only move data and their adjoints sum in a
fixed order, so card and CPU agree bitwise; the model runs bf16 convs, held
to ``chip_smoke.TRAIN_TOL`` (relative to each tensor's largest magnitude).
"""

import numpy as np
import pytest
import torch

from accvlab_tpu_torch import ragged as R
from accvlab_tpu_torch.models.centernet import CenterNetDetector, make_example_batch
from accvlab_tpu_torch.models.centernet import make_train_step
from accvlab_tpu_torch.train_centernet_e2e import batch_to_train_inputs, build_train_pipeline
from chip_smoke import bitwise_equal, gather_adjoint, gather_adjoint_inputs, train_parity_phase


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the training path's card cases)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_adjoint_is_the_same_bits_run_to_run_and_on_the_cpu(cuda, seed):
    inputs = gather_adjoint_inputs(seed)
    first, second = gather_adjoint(inputs, cuda), gather_adjoint(inputs, cuda)
    assert bitwise_equal(first, second)
    assert bitwise_equal(first, gather_adjoint(inputs, torch.device("cpu")))


@pytest.mark.cuda
def test_ragged_ops_on_the_card_match_the_cpu_bitwise(cuda):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(6, 40, 3)).astype(np.float32)
    idx = rng.integers(-50, 50, (6, 12)).astype(np.int32)  # duplicates, out of range
    unique = np.stack([rng.permutation(40)[:12] - 40 * (r % 2) for r in range(6)])
    sizes = rng.integers(0, 13, 6).astype(np.int32)
    mask = rng.random((6, 40)) < 0.3
    res = {}
    for dev in (torch.device("cpu"), cuda):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        ind = R.RaggedBatch(t(idx), sample_sizes=t(sizes))
        uniq = R.RaggedBatch(t(unique.astype(np.int32)), sample_sizes=t(sizes))
        res[dev.type] = [
            R.batched_indexing_access(t(data), ind, -1.0).tensor,
            R.batched_inverse_indexing_access(t(data[:, :12]), uniq, 40, 0.5),
            R.ragged_scatter_new(t(data[:, :12]), t(idx), t(sizes), 40, accumulate=True),
            R.get_mask_from_indices(40, ind),
            R.batched_bool_indexing(t(data), t(mask), 40).tensor,
            R.average_over_targets(R.RaggedBatch(t(data), sample_sizes=t(sizes))),
        ]
    for a, b in zip(res["cpu"], res["cuda"]):
        a, b = a.cpu(), b.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            assert bitwise_equal(a, b) or torch.allclose(a, b, rtol=1e-6, atol=0)
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_train_step_matches_the_cpu(cuda):
    train_parity_phase(cuda)  # exits non-zero beyond chip_smoke.TRAIN_TOL


@pytest.mark.cuda
def test_one_step_makes_no_host_synchronisation(cuda):
    pipe = build_train_pipeline(batch_size=2, device=cuda, num_threads=2, hw=(96, 256),
                                num_cams=2, out_hw=(64, 176), heatmap_hw=(16, 44), num_samples=8)
    try:
        out = pipe.run()
    finally:
        pipe.stop()
    model = CenterNetDetector(10, width=16)
    init_fn, step = make_train_step(model)
    model, opt = init_fn(0, out["cameras.[0].image"])
    step(model, opt, batch_to_train_inputs(out, cam=[0, 1]))  # Adam's state exists
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, metrics = step(model, opt, batch_to_train_inputs(out, cam=[0, 1]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(metrics["loss"]).item()


@pytest.mark.cuda
def test_example_batch_steps_on_the_card(cuda):
    batch = make_example_batch(device=cuda)
    init_fn, step = make_train_step(CenterNetDetector(10, width=8))
    model, opt = init_fn(0, batch["images"])
    assert next(model.parameters()).is_cuda
    losses = [step(model, opt, batch)[2]["loss"] for _ in range(5)]
    losses = torch.stack(losses).cpu()
    assert torch.isfinite(losses).all() and losses[-1] < losses[0]
