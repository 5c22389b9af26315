"""Device-side bipartite assignment (auction algorithm) for set-based losses.

PyTorch port of ``accvlab_tpu/ragged/matching.py``. The reference's Matcher
workflow runs scipy's Hungarian per sample on the host, a
device->host->device round trip every training step; the JAX package runs
Bertsekas' auction as one ``lax.while_loop`` inside ``jit``. Eager PyTorch
cannot run that loop without a host synchronisation per bid round (its exit
test), so on the card the auction is a hand-written CUDA kernel
(``csrc/auction_matching.cu``, bound in :mod:`._auction_kernel`) that runs
every round of one sample inside one block. :func:`auction_plain` beside it
is the same round as batched torch ops, a Python loop whose exit reads
``.any()``: the kernel's oracle and the CPU path.

``implementation=``: ``"auto"`` runs the kernel for CUDA tensors and the
plain version for CPU tensors; ``"kernel"`` on a CPU tensor raises;
``"torch"`` runs the plain version on either device.

Near-optimality: with bid increment ``eps`` the assignment cost is within
``num_rows * eps`` of optimal. The default ``eps`` is the sample's cost span
over ``200 * R``, the span taken over the whole padded ``(R, C)`` matrix,
invalid rows included, as the JAX package takes it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._device import DeviceLike, device_of, use_kernel
from . import _auction_kernel
from .bool_indexing import stable_active_first
from .ragged_batch import RaggedBatch

Tensor = torch.Tensor


def _eps_per_sample(cost: Tensor, eps: Optional[float]) -> Tensor:
    """``(B,)`` float32 bid increments. The default divides by a device
    tensor: PyTorch divides a CUDA tensor by a Python scalar as a multiply by
    its reciprocal, which can differ from JAX's division in the last bit."""
    b, r, _ = cost.shape
    if eps is not None:
        return torch.full((b,), float(eps), dtype=torch.float32, device=cost.device)
    benefit = -cost
    span = torch.clamp(benefit.amax(dim=(1, 2)) - benefit.amin(dim=(1, 2)), min=1e-6)
    return span / torch.full((), 200.0 * max(r, 1), dtype=torch.float32, device=cost.device)


def auction_plain(cost: Tensor, num_valid: Tensor, eps: Tensor,
                  max_iters: int) -> Tuple[Tensor, Tensor, Tensor]:
    """The JAX round (``matching.py:71-108``) as batched torch ops over
    ``cost (B, R, C)``; ``num_valid (B,)`` int32, ``eps (B,)`` float32.
    Returns ``(col_of_row (B, R) int32, rounds (B,) int32, bids (B,)
    int32)``, bids counting one per bidding row per round. A sample with
    no unassigned valid row is left as it is by a round (it places no bid),
    so running the rounds for the whole batch until every sample is done
    gives each sample's own ``while_loop`` exit, as ``vmap`` does."""
    b, r, c = cost.shape
    dev = cost.device
    benefit = -cost
    rows = torch.arange(r, device=dev)
    valid = rows[None, :] < num_valid[:, None]
    prices = torch.zeros((b, c), dtype=torch.float32, device=dev)
    owner_of_col = torch.full((b, c), -1, dtype=torch.int64, device=dev)
    col_of_row = torch.full((b, r), -1, dtype=torch.int64, device=dev)
    rounds = torch.zeros((b,), dtype=torch.int32, device=dev)
    bids = torch.zeros((b,), dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        unassigned = valid & (col_of_row < 0)
        active = unassigned.any(dim=1)
        if not bool(active.any()):
            break
        rounds += active.to(torch.int32)
        bids += unassigned.sum(dim=1, dtype=torch.int32)
        values = benefit - prices[:, None, :]  # (B, R, C)
        best_col = values.argmax(dim=2)  # first maximum
        best_val = values.amax(dim=2)
        second_val = values.scatter(2, best_col[..., None], float("-inf")).amax(dim=2)
        bid = (prices.gather(1, best_col) + (best_val - second_val)) + eps[:, None]
        bid = torch.where(unassigned, bid, float("-inf"))
        col_bid = torch.full((b, c), float("-inf"), device=dev).scatter_reduce(
            1, best_col, bid, "amax")
        won = unassigned & (bid == col_bid.gather(1, best_col)) & torch.isfinite(bid)
        row_ids = torch.where(won, rows[None, :], r)
        winner_row = torch.full((b, c), r, dtype=torch.int64, device=dev).scatter_reduce(
            1, best_col, row_ids, "amin")
        col_has_winner = winner_row < r
        # evict the previous owners of won columns (matching.py:96-101's isin)
        prev_owner = torch.where(col_has_winner, owner_of_col, -1)
        evicted = (prev_owner[:, None, :] == rows[None, :, None]).any(dim=2)
        col_of_row = torch.where(evicted, -1, col_of_row)
        # install: row i wins iff it is the recorded winner of its own bid
        # column (a gather, as matching.py:104)
        row_won = unassigned & (winner_row.gather(1, best_col) == rows[None, :])
        col_of_row = torch.where(row_won, best_col, col_of_row)
        owner_of_col = torch.where(col_has_winner, winner_row.clamp(0, max(r - 1, 0)),
                                   owner_of_col)
        prices = torch.where(col_has_winner, col_bid, prices)
    return torch.where(valid, col_of_row, -1).to(torch.int32), rounds, bids


def auction_assignment(
    cost: Tensor,
    num_valid_rows: Optional[Tensor] = None,
    eps: Optional[float] = None,
    max_iters: int = 20000,
    implementation: str = "auto",
    device: DeviceLike = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Auction of every sample of ``cost (B, R, C)`` (``C >= R``) on the
    tensor's device (a host array goes to ``device``, default the card).
    ``num_valid_rows`` ``(B,)`` (None: every row is valid).
    Returns ``(col_of_row (B, R) int32, rounds (B,) int32, bids (B,)
    int32)``: ``-1`` for invalid rows and for rows still unassigned after
    ``max_iters`` rounds, the bid rounds each sample ran, and the bids it
    placed over them (one per unassigned valid row per round: the work the
    rounds did)."""
    dev = device_of(cost, device)
    cost = torch.as_tensor(cost).to(device=dev, dtype=torch.float32)
    if cost.ndim != 3:
        raise ValueError(f"cost must be (B, R, C), got shape {tuple(cost.shape)}")
    b, r, c = cost.shape
    if c < r:
        raise ValueError("auction_matching needs at least as many columns as rows")
    kernel = use_kernel(implementation, dev)
    if num_valid_rows is None:
        num_valid = torch.full((b,), r, dtype=torch.int32, device=cost.device)
    else:
        num_valid = torch.as_tensor(num_valid_rows).to(device=cost.device, dtype=torch.int32)
        num_valid = num_valid.reshape(b)
    eps_b = _eps_per_sample(cost, eps)
    if kernel:
        return _auction_kernel.launch_auction(cost, num_valid.contiguous(), eps_b.contiguous(),
                                              max_iters)
    return auction_plain(cost, num_valid, eps_b, max_iters)


def auction_matching(
    cost: Tensor,
    num_valid_rows=None,
    eps: Optional[float] = None,
    max_iters: int = 20000,
    implementation: str = "auto",
    device: DeviceLike = None,
) -> Tensor:
    """Minimum-cost row->column assignment of one ``(R, C)`` cost matrix
    (``C >= R``); rows ``>= num_valid_rows`` are ignored. Returns ``(R,)``
    int32 column per row, ``-1`` for invalid and unassigned rows."""
    dev = device_of(cost, device)
    cost = torch.as_tensor(cost).to(dev)
    if cost.ndim != 2:
        raise ValueError(f"cost must be (R, C), got shape {tuple(cost.shape)}")
    nv = None
    if num_valid_rows is not None:
        nv = (num_valid_rows.reshape(1) if isinstance(num_valid_rows, Tensor)
              else torch.full((1,), int(num_valid_rows), dtype=torch.int32, device=dev))
    return auction_assignment(cost[None], nv, eps, max_iters, implementation)[0][0]


def _compact(cols: Tensor, num_valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """``matching.py:144-159``: the assigned (row, column) pairs of each
    sample moved to its prefix in row order; zeros after it."""
    r = cols.shape[1]
    rows = torch.arange(r, device=cols.device)
    assigned = (cols >= 0) & (rows[None, :] < num_valid[:, None])
    order = stable_active_first(assigned)
    rows_c = order.to(torch.int32)
    cols_c = cols.gather(1, order)
    n_assigned = assigned.sum(dim=1, dtype=torch.int32)
    in_prefix = rows[None, :] < n_assigned[:, None]
    return (torch.where(in_prefix, rows_c, 0), torch.where(in_prefix, cols_c, 0), n_assigned)


def batched_auction_matching(
    cost: Tensor,
    num_valid_rows,
    eps: Optional[float] = None,
    max_iters: int = 20000,
    implementation: str = "auto",
    device: DeviceLike = None,
) -> Tuple[RaggedBatch, RaggedBatch]:
    """Batched matching: ``(B, R, C)`` costs and per-sample valid row
    counts -> ``(matches_gt, matches_pred)`` RaggedBatches in the layout the
    batched loss consumes (valid matches form each sample's prefix).

    On CUDA tensors it makes no host synchronisation. A row still unassigned
    after ``max_iters`` rounds drops out: the assigned pairs are compacted to
    the prefix and ``sample_sizes`` counts only them, so no two rows share a
    prediction.
    """
    cols = auction_assignment(cost, num_valid_rows, eps, max_iters, implementation, device)[0]
    num_valid = torch.as_tensor(num_valid_rows).to(device=cols.device, dtype=torch.int32)
    rows, cols_compact, sizes = _compact(cols, num_valid.reshape(cols.shape[0]))
    return RaggedBatch(rows, sample_sizes=sizes), RaggedBatch(cols_compact, sample_sizes=sizes)
