"""The CUDA auction kernel against its plain version on a card.

Every test here needs an NVIDIA card and skips without one. No JAX is
imported, so the file runs on a card machine without it:
    python -m pytest tests/test_torch_matching_cuda.py -q

Tolerance: none. The kernel computes the JAX round with the same float32
operations (each rounding spelled out, no contraction), so ``col_of_row``,
the rounds, the bids and both compacted ``RaggedBatch``es are bitwise equal
to the plain version's.
"""

import numpy as np
import pytest
import torch

from accvlab_tpu_torch.ragged import _auction_kernel, batched_auction_matching
from accvlab_tpu_torch.ragged.matching import auction_assignment
from chip_smoke import example_matching_cost, matching_agrees, matching_edge_cases


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the auction kernel has no CPU form)")
    return torch.device("cuda")


EDGE_NAMES = ["c1", "no_valid_rows", "integer_ties", "unconverged", "r_eq_c", "cost_through_l2",
              "nan_costs", "nan_costs_default_eps", "lone_bidder", "all_rows_bid",
              "equal_bids_one_column", "r_eq_c_wide", "signed_zeros"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGE_NAMES)
def test_edge_cases_bitwise(cuda, name):
    case = {c[0]: c[1:] for c in matching_edge_cases(cuda)}[name]
    assert matching_agrees(*case)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_example_cost_bitwise(cuda, seed):
    cost, nv = example_matching_cost(cuda, seed)
    assert matching_agrees(cost, nv, 20000)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 32, 192), (5, 7, 33), (2, 64, 64), (1, 1, 40)])
def test_random_shapes_bitwise(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    cost = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    nv = torch.from_numpy(rng.integers(0, shape[1] + 1, shape[0]).astype(np.int32)).to(cuda)
    assert matching_agrees(cost, nv, 20000)[0]


@pytest.mark.cuda
def test_launch_counter_counts_kernel_launches_only(cuda):
    cost, nv = example_matching_cost(cuda)
    _auction_kernel.reset_launch_counts()
    batched_auction_matching(cost, nv)
    auction_assignment(cost, nv, implementation="torch")
    auction_assignment(cost[:0], nv[:0])  # an empty batch launches nothing
    assert _auction_kernel.LAUNCHES["batched_auction_matching"] == 1


@pytest.mark.cuda
def test_kernel_path_makes_no_host_sync(cuda):
    cost, nv = example_matching_cost(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batched_auction_matching(cost, nv, implementation="kernel")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
