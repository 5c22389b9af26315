"""The auction kernel from several source trees, in turns, on one CUDA card;
and clock64() breakdowns of the kernel's round.

Run from the repository root, with each tree a checkout of this repository
(for example an earlier commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists):

    python3 scripts/torch_auction_ab.py build/parent . . build/parent
    python3 scripts/torch_auction_ab.py --breakdown
    python3 scripts/torch_auction_ab.py --breakdown-list [THREADS]

A/B: for each tree, in the order given, a fresh process whose working
directory is the tree builds that tree's ``ragged/csrc/auction_matching.cu``,
runs it on the batched loss example's 8 x 48 x 300 cost
(``chip_smoke.example_matching_cost``, seeds 0, 1 and 2) with the default
eps made beforehand, checks its columns and rounds bitwise against the plain
version, and times the bare launch (``_auction_kernel.launch_auction``,
median of 50, L2 flushed, CUDA events; ``chip_smoke.device_ms``), with µs per
round of the slowest sample and ns per bid. Prints one JSON line per run,
with the tree and the card's name and power limit, and exits non-zero if a
run fails or disagrees. Comparing trees within one call keeps them on one
card.

``--breakdown``: :data:`BREAKDOWN_CU`, a copy of the first kernel (commit
3f1f19b, one warp per row over every valid row, a column pass and an exit
scan per round) with ``clock64()`` reads between its phases, on seed 0's cost. It
prints thread 0's cycles per phase summed over the rounds of the slowest
sample (every thread meets at the round's barriers, so thread 0's round is
the round's latency), the bidding warps' cycles per bid by phase, the
histogram of bidders per round, the kernel's time, and the SASS of the
column-bid atomic (``cuobjdump``), to show whether it is a native 64-bit
shared-memory atomic or a compare-and-swap loop. ``--breakdown-list`` does
the same for :data:`LIST_BREAKDOWN_CU`, a copy of the current list-driven
kernel (``THREADS`` per block, 256 by default), whose thread 0 takes the
list's first bidder in every round. The copies are kept here, not in the
package.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

CODE = """
import json, torch, chip_smoke
from accvlab_tpu_torch.ragged import _auction_kernel
from accvlab_tpu_torch.ragged.matching import _eps_per_sample, auction_plain
dev = torch.device("cuda", 0)
flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
out = {}
for seed in (0, 1, 2):
    cost, nv = chip_smoke.example_matching_cost(dev, seed)
    eps = _eps_per_sample(cost, None)
    got = _auction_kernel.launch_auction(cost, nv, eps, 20000)
    want = auction_plain(cost, nv, eps, 20000)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    ms = chip_smoke.device_ms(lambda: _auction_kernel.launch_auction(cost, nv, eps, 20000),
                              chip_smoke.N_TIMED, flush)
    rounds, bids = got[1].tolist(), got[2].tolist()
    out[seed] = {"kernel_ms": ms, "bitwise": same, "rounds": rounds, "bids": bids,
                 "us_per_round": ms * 1e3 / max(rounds), "ns_per_bid": ms * 1e6 / sum(bids)}
print(json.dumps({"runs": out}))
"""

# The first kernel (accvlab_tpu_torch/ragged/csrc/auction_matching.cu at
# 3f1f19b, shared-memory form) with clock64() reads between its phases.
BREAKDOWN_CU = r"""
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// thread 0's phases: bid loop (scan, merge, atomic, skipping assigned rows),
// first barrier, column pass, second barrier, exit test with its barrier
enum { SCAN, MERGE, ATOMIC, SKIP, WAIT1, COLS, WAIT2, EXIT, TOTAL, NT };
// every bidding warp: scan, merge and atomic cycles, and its bids
enum { B_SCAN, B_MERGE, B_ATOMIC, B_BIDS, NB };

__device__ __forceinline__ uint32_t ordered_bits(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_ordered_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
struct Best { float best; int col; float second; };
__device__ __forceinline__ Best merge(Best a, Best b) {
  if (b.best > a.best || (b.best == a.best && b.col < a.col)) {
    return Best{b.best, b.col, fmaxf(b.second, a.best)};
  }
  return Best{a.best, a.col, fmaxf(a.second, b.best)};
}

__global__ void __launch_bounds__(kThreads)
auction_timed(const float* __restrict__ cost, const int* __restrict__ num_valid,
              const float* __restrict__ eps, int* __restrict__ col_of_row_out,
              int* __restrict__ rounds_out, long long* __restrict__ t0_out,
              unsigned long long* __restrict__ bid_out, int* __restrict__ bidders_per_round,
              int rows, int cols, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* prices = reinterpret_cast<float*>(keys + cols);
  int* owner = reinterpret_cast<int*>(prices + cols);
  int* col_of_row = owner + cols;
  int* round_bids = col_of_row + rows;
  float* cost_s = reinterpret_cast<float*>(round_bids + 1);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cost_b = cost + static_cast<size_t>(b) * rows * cols;
  const int n_rows = max(0, min(num_valid[b], rows));
  const float eps_b = eps[b];
  for (int c = tid; c < cols; c += kThreads) { keys[c] = 0ull; prices[c] = 0.0f; owner[c] = -1; }
  for (int r = tid; r < rows; r += kThreads) col_of_row[r] = -1;
  for (int i = tid; i < n_rows * cols; i += kThreads) cost_s[i] = cost_b[i];
  if (tid == 0) *round_bids = 0;
  __syncthreads();
  long long t[NT] = {0};
  unsigned long long wb[NB] = {0};
  unsigned long long sink = 0;
  int it = 0, active = n_rows > 0 ? 1 : 0;
  while (it < max_iters && active) {
    const long long r0 = clock64();
    long long in_bids = 0;
    for (int r = warp; r < n_rows; r += kWarps) {
      if (col_of_row[r] >= 0) continue;
      const long long a0 = clock64();
      const float* row = cost_s + static_cast<size_t>(r) * cols;
      Best m{-INFINITY, 0x7fffffff, -INFINITY};
      unsigned nan_col = 0x7fffffffu;
      for (int c = lane; c < cols; c += 32) {
        const float v = __fsub_rn(-row[c], prices[c]);
        if (v > m.best || (v == m.best && c < m.col)) {
          m.second = fmaxf(m.second, m.best); m.best = v; m.col = c;
        } else {
          m.second = fmaxf(m.second, v);
        }
        if (isnan(v)) nan_col = min(nan_col, static_cast<unsigned>(c));
      }
      const int done_scan = __reduce_add_sync(0xffffffffu, m.col & 1);  // waits for the scan
      const long long a1 = clock64();
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        Best o{__shfl_xor_sync(0xffffffffu, m.best, off), __shfl_xor_sync(0xffffffffu, m.col, off),
               __shfl_xor_sync(0xffffffffu, m.second, off)};
        m = merge(m, o);
      }
      nan_col = __reduce_min_sync(0xffffffffu, nan_col);
      if (nan_col != 0x7fffffffu) { m.best = __uint_as_float(0x7fffffffu); m.col = static_cast<int>(nan_col); }
      sink += static_cast<unsigned>(m.col + done_scan);
      const long long a2 = clock64();
      if (lane == 0) {
        const float bid = __fadd_rn(__fadd_rn(prices[m.col], __fsub_rn(m.best, m.second)), eps_b);
        const uint32_t bits = isnan(bid) ? 0xffffffffu : ordered_bits(bid);
        const unsigned long long key = (static_cast<unsigned long long>(bits) << 32) |
                                       static_cast<unsigned long long>(~static_cast<uint32_t>(r));
        sink += atomicMax(&keys[m.col], key);  // the return value waits for the atomic
      }
      __syncwarp();
      const long long a3 = clock64();
      if (lane == 0) {
        atomicAdd(round_bids, 1);
        wb[B_SCAN] += a1 - a0; wb[B_MERGE] += a2 - a1; wb[B_ATOMIC] += a3 - a2; wb[B_BIDS] += 1;
      }
      t[SCAN] += a1 - a0; t[MERGE] += a2 - a1; t[ATOMIC] += a3 - a2; in_bids += a3 - a0;
    }
    const long long r1 = clock64();
    t[SKIP] += (r1 - r0) - in_bids;
    __syncthreads();
    const long long r2 = clock64();
    t[WAIT1] += r2 - r1;
    if (b == 0 && tid == 0) bidders_per_round[it] = *round_bids;
    for (int c = tid; c < cols; c += kThreads) {
      const unsigned long long key = keys[c];
      if (key == 0ull) continue;
      keys[c] = 0ull;
      const float bid = from_ordered_bits(static_cast<uint32_t>(key >> 32));
      if (!isfinite(bid)) continue;
      const int winner = static_cast<int>(~static_cast<uint32_t>(key & 0xffffffffull));
      const int prev = owner[c];
      if (prev >= 0) col_of_row[prev] = -1;
      col_of_row[winner] = c; owner[c] = winner; prices[c] = bid;
    }
    const long long r3 = clock64();
    t[COLS] += r3 - r2;
    __syncthreads();
    if (tid == 0) *round_bids = 0;
    const long long r4 = clock64();
    t[WAIT2] += r4 - r3;
    ++it;
    int unassigned = 0;
    for (int r = tid; r < n_rows; r += kThreads) unassigned |= (col_of_row[r] < 0);
    active = __syncthreads_or(unassigned);
    const long long r5 = clock64();
    t[EXIT] += r5 - r4;
    t[TOTAL] += r5 - r0;
  }
  for (int r = tid; r < rows; r += kThreads)
    col_of_row_out[static_cast<size_t>(b) * rows + r] = r < n_rows ? col_of_row[r] : -1;
  if (tid == 0) {
    rounds_out[b] = it;
    for (int k = 0; k < NT; ++k) t0_out[b * NT + k] = t[k];
    t0_out[b * NT + NT - 1] += static_cast<long long>(sink & 1ull);  // keep sink alive
  }
  if (lane == 0) for (int k = 0; k < NB; ++k) atomicAdd(&bid_out[b * NB + k], wb[k]);
}
}  // namespace

extern "C" int auction_timed_launch(const float* cost, const int* nv, const float* eps, int* cols_out,
                                    int* rounds, long long* t0, unsigned long long* bids_out,
                                    int* per_round, int batch, int rows, int cols, int max_iters,
                                    void* stream) {
  const size_t smem = static_cast<size_t>(cols) * 16 + static_cast<size_t>(rows) * 4 + 4 +
                      static_cast<size_t>(rows) * cols * 4;
  cudaError_t e = cudaFuncSetAttribute(auction_timed, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  auction_timed<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cost, nv, eps, cols_out, rounds, t0, bids_out, per_round, rows, cols, max_iters);
  return static_cast<int>(cudaGetLastError());
}
"""


# The list-driven kernel (accvlab_tpu_torch/ragged/csrc/auction_matching.cu
# as it is now, shared-memory form) with clock64() reads between its phases.
# Thread 0 is in warp 0, which takes the list's first bidder: its round is
# a bidder's round.
LIST_BREAKDOWN_CU = r"""
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {
constexpr int kThreads = KTHREADS;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoCol = 0x7fffffffu;
enum { SCAN, MERGE, SLOT, WAIT1, COMPARE, SETTLE, WAIT2, NEXT, TOTAL, NT };

__device__ __forceinline__ uint32_t ordered_bits(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_ordered_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
struct Best { float best; int col; float second; };
__device__ __forceinline__ void fold(Best& m, float v, int c, bool in) {
  const bool take = in && (v > m.best || (m.col == INT_MAX && v == v));
  const float others = in ? fmaxf(m.second, v) : m.second;
  m.second = take ? m.best : others;
  m.best = take ? v : m.best;
  m.col = take ? c : m.col;
}
__device__ __forceinline__ Best merge(Best a, Best b) {
  const bool second_wins = b.best > a.best || (b.best == a.best && b.col < a.col);
  return second_wins ? Best{b.best, b.col, fmaxf(b.second, a.best)}
                     : Best{a.best, a.col, fmaxf(a.second, b.best)};
}

__global__ void __launch_bounds__(kThreads)
auction_timed(const float* __restrict__ cost, const int* __restrict__ num_valid,
              const float* __restrict__ eps, int* __restrict__ col_of_row_out,
              int* __restrict__ rounds_out, long long* __restrict__ t0_out,
              unsigned long long* __restrict__ unused, int* __restrict__ bidders_per_round,
              int rows, int cols, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* slot_key = reinterpret_cast<unsigned long long*>(smem);
  float* prices = reinterpret_cast<float*>(slot_key + rows);
  int* owner = reinterpret_cast<int*>(prices + cols);
  int* col_of_row = owner + cols;
  int* slot_col = col_of_row + rows;
  int* lists = slot_col + rows;
  int* counts = lists + 2 * rows;
  float* cost_s = reinterpret_cast<float*>(counts + 2);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cost_b = cost + static_cast<size_t>(b) * rows * cols;
  const int n_rows = max(0, min(num_valid[b], rows));
  const float eps_b = eps[b];
  for (int c = tid; c < cols; c += kThreads) { prices[c] = 0.0f; owner[c] = -1; }
  for (int r = tid; r < rows; r += kThreads) { col_of_row[r] = -1; lists[r] = r; }
  for (int i = tid; i < n_rows * cols; i += kThreads) cost_s[i] = cost_b[i];
  __syncthreads();
  long long t[NT] = {0};
  unsigned sink = 0;
  int it = 0, n_bidders = n_rows;
  while (it < max_iters && n_bidders > 0) {
    const long long r0 = clock64();
    long long scan = 0, mrg = 0, slot = 0;
    const int* bidders = lists + (it & 1) * rows;
    int* next = lists + ((it + 1) & 1) * rows;
    int* next_count = counts + ((it + 1) & 1);
    if (b == 0 && tid == 0) bidders_per_round[it] = n_bidders;
    for (int i = warp; i < n_bidders; i += kWarps) {
      const long long a0 = clock64();
      const int r = bidders[i];
      const float* row = cost_s + static_cast<size_t>(r) * cols;
      Best a{-INFINITY, INT_MAX, -INFINITY}, z{-INFINITY, INT_MAX, -INFINITY};
      unsigned nan_col = kNoCol;
#pragma unroll 4
      for (int c0 = 0; c0 < cols; c0 += 64) {
        const int ca = c0 + lane, cz = ca + 32;
        const bool ina = ca < cols, inz = cz < cols;
        const float va = __fsub_rn(-(ina ? row[ca] : 0.0f), ina ? prices[ca] : 0.0f);
        const float vz = __fsub_rn(-(inz ? row[cz] : 0.0f), inz ? prices[cz] : 0.0f);
        fold(a, va, ca, ina);
        fold(z, vz, cz, inz);
        const unsigned na = ina && va != va ? static_cast<unsigned>(ca) : kNoCol;
        const unsigned nz = inz && vz != vz ? static_cast<unsigned>(cz) : kNoCol;
        nan_col = min(nan_col, min(na, nz));
      }
      a = merge(a, z);
      const float best = a.best, second = a.second;
      const int col = a.col;
      sink += __reduce_add_sync(kFull, static_cast<unsigned>(col));  // waits for the scan
      const long long a1 = clock64();
      const unsigned best_key = __reduce_max_sync(kFull, ordered_bits(__fadd_rn(best, 0.0f)));
      const int best_col = __reduce_min_sync(
          kFull, ordered_bits(__fadd_rn(best, 0.0f)) == best_key ? col : INT_MAX);
      const float mine = col == best_col ? second : best;
      const unsigned second_key = __reduce_max_sync(kFull, ordered_bits(__fadd_rn(mine, 0.0f)));
      nan_col = __reduce_min_sync(kFull, nan_col);
      sink += second_key + nan_col;
      const long long a2 = clock64();
      const bool has_nan = nan_col != kNoCol;
      const int c = has_nan ? static_cast<int>(nan_col) : best_col;
      const float best_val = has_nan ? __uint_as_float(0x7fffffffu) : from_ordered_bits(best_key);
      const float bid = __fadd_rn(
          __fadd_rn(prices[c], __fsub_rn(best_val, from_ordered_bits(second_key))), eps_b);
      const uint32_t bits = isnan(bid) ? 0xffffffffu : ordered_bits(bid);
      if (lane == 0) {
        slot_col[i] = c;
        slot_key[i] = (static_cast<unsigned long long>(bits) << 32) |
                      static_cast<unsigned long long>(~static_cast<uint32_t>(r));
      }
      __syncwarp();
      const long long a3 = clock64();
      scan += a1 - a0; mrg += a2 - a1; slot += a3 - a2;
    }
    if (tid == 0) *next_count = 0;
    const long long r1 = clock64();
    __syncthreads();
    const long long r2 = clock64();
    long long cmp = 0, settle = 0;
    for (int i = warp; i < n_bidders; i += kWarps) {
      const long long s0 = clock64();
      const int c = slot_col[i];
      const unsigned long long key = slot_key[i];
      bool lost = false;
      for (int j0 = 0; j0 < n_bidders; j0 += 32) {
        const int j = j0 + lane;
        const bool in = j < n_bidders;
        lost |= in && (in ? slot_col[j] : -1) == c && (in ? slot_key[j] : 0ull) > key;
      }
      lost = __any_sync(kFull, lost);
      const long long s1 = clock64();
      const int r = static_cast<int>(~static_cast<uint32_t>(key & 0xffffffffull));
      const bool won = !lost && isfinite(from_ordered_bits(static_cast<uint32_t>(key >> 32)));
      const int prev = won ? owner[c] : -1;
      const int unassigned = won ? prev : r;
      if (lane == 0) {
        if (won) {
          if (prev >= 0) col_of_row[prev] = -1;
          col_of_row[r] = c; owner[c] = r;
          prices[c] = from_ordered_bits(static_cast<uint32_t>(key >> 32));
        }
        if (unassigned >= 0) next[atomicAdd(next_count, 1)] = unassigned;
      }
      __syncwarp();
      const long long s2 = clock64();
      cmp += s1 - s0; settle += s2 - s1;
    }
    const long long r3 = clock64();
    __syncthreads();
    const long long r4 = clock64();
    n_bidders = *next_count;
    ++it;
    sink += n_bidders;
    const long long r5 = clock64();
    t[SCAN] += scan; t[MERGE] += mrg; t[SLOT] += slot + (r1 - r0) - (scan + mrg + slot);
    t[WAIT1] += r2 - r1; t[COMPARE] += cmp; t[SETTLE] += settle + (r3 - r2) - (cmp + settle);
    t[WAIT2] += r4 - r3; t[NEXT] += r5 - r4; t[TOTAL] += r5 - r0;
  }
  for (int r = tid; r < rows; r += kThreads)
    col_of_row_out[static_cast<size_t>(b) * rows + r] = r < n_rows ? col_of_row[r] : -1;
  if (tid == 0) {
    rounds_out[b] = it;
    for (int k = 0; k < NT; ++k) t0_out[b * NT + k] = t[k];
    t0_out[b * NT + NT - 1] += static_cast<long long>(sink & 1u);
  }
}
}  // namespace

extern "C" int auction_timed_launch(const float* cost, const int* nv, const float* eps, int* cols_out,
                                    int* rounds, long long* t0, unsigned long long* unused,
                                    int* per_round, int batch, int rows, int cols, int max_iters,
                                    void* stream) {
  const size_t smem = static_cast<size_t>(rows) * 8 + static_cast<size_t>(cols) * 8 +
                      static_cast<size_t>(rows) * 16 + 8 + static_cast<size_t>(rows) * cols * 4;
  cudaError_t e = cudaFuncSetAttribute(auction_timed, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  auction_timed<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cost, nv, eps, cols_out, rounds, t0, unused, per_round, rows, cols, max_iters);
  return static_cast<int>(cudaGetLastError());
}
"""
LIST_PHASES = ["scan", "merge", "bid_and_slot", "wait_barrier_1", "compare_slots", "settle",
               "wait_barrier_2", "next_count", "round_total"]

PHASES = ["scan", "merge", "atomic", "skip_assigned", "wait_barrier_1", "column_pass",
          "wait_barrier_2", "exit_test", "round_total"]
BID_PHASES = ["scan", "merge", "atomic"]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def breakdown(kind: str = "pr5", threads: int = 256) -> int:
    """``kind`` "pr5": :data:`BREAKDOWN_CU`; "list": :data:`LIST_BREAKDOWN_CU`
    with ``threads`` threads per block."""
    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from accvlab_tpu_torch import _native_build
    from accvlab_tpu_torch.ragged import _auction_kernel
    from accvlab_tpu_torch.ragged.matching import _eps_per_sample, auction_plain

    src_dir = os.path.join("build", "auction_breakdown")
    os.makedirs(src_dir, exist_ok=True)
    src = os.path.join(src_dir, f"auction_timed_{kind}_{threads}.cu")
    phases = PHASES if kind == "pr5" else LIST_PHASES
    with open(src, "w") as f:
        f.write(BREAKDOWN_CU if kind == "pr5" else
                LIST_BREAKDOWN_CU.replace("KTHREADS", str(threads)))
    lib_path = _native_build.build_cuda_lib(src, f"libauction_timed_{kind}_{threads}",
                                            ["-fmad=false"])
    lib = ctypes.CDLL(lib_path)
    lib.auction_timed_launch.restype = ctypes.c_int
    lib.auction_timed_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]

    dev = torch.device("cuda", 0)
    cost, nv = chip_smoke.example_matching_cost(dev, 0)
    eps = _eps_per_sample(cost, None)
    b, r, c = cost.shape
    max_iters = 20000

    def run():
        cols = torch.empty((b, r), dtype=torch.int32, device=dev)
        rounds = torch.empty((b,), dtype=torch.int32, device=dev)
        t0 = torch.zeros((b, len(phases)), dtype=torch.int64, device=dev)
        bid = torch.zeros((b, len(BID_PHASES) + 1), dtype=torch.int64, device=dev)
        per_round = torch.zeros((max_iters,), dtype=torch.int32, device=dev)
        err = lib.auction_timed_launch(
            ctypes.c_void_p(cost.data_ptr()), ctypes.c_void_p(nv.data_ptr()),
            ctypes.c_void_p(eps.data_ptr()), ctypes.c_void_p(cols.data_ptr()),
            ctypes.c_void_p(rounds.data_ptr()), ctypes.c_void_p(t0.data_ptr()),
            ctypes.c_void_p(bid.data_ptr()), ctypes.c_void_p(per_round.data_ptr()), b, r, c,
            max_iters, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return cols, rounds, t0, bid, per_round

    cols, rounds, t0, bid, per_round = run()
    want = auction_plain(cost, nv, eps, max_iters)
    torch.cuda.synchronize()
    same = torch.equal(cols, want[0]) and torch.equal(rounds, want[1])
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timed_ms = chip_smoke.device_ms(run, chip_smoke.N_TIMED, flush)
    bare_ms = chip_smoke.device_ms(lambda: _auction_kernel.launch_auction(cost, nv, eps, max_iters),
                                   chip_smoke.N_TIMED, flush)
    s = int(rounds.argmax())
    n_rounds = int(rounds[s])
    t = t0[s].tolist()
    total = t[phases.index("round_total")]
    bw = bid[s].tolist() if kind == "pr5" else [0] * len(BID_PHASES) + [int(per_round.sum())]
    hist = np.bincount(per_round[:int(rounds[0])].cpu().numpy())
    cuobjdump = os.path.join(os.path.dirname(_native_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True).stdout
    atom = sorted({m.strip() for m in re.findall(r"(ATOMS?\.[A-Z0-9.]+|CAS[A-Z0-9.]*)", sass)})
    print(json.dumps({
        "kernel": kind, "threads": threads,
        "card": card(), "bitwise_vs_plain": bool(same), "sample": s, "rounds": n_rounds,
        "bids": bw[-1], "timed_kernel_ms": timed_ms, "bare_kernel_ms": bare_ms,
        "us_per_round_bare": bare_ms * 1e3 / n_rounds,
        "cycles_per_round": total / n_rounds,
        "thread0_cycles_per_round": {k: v / n_rounds for k, v in zip(phases, t)},
        "thread0_share": {k: v / total for k, v in zip(phases, t)},
        **({"cycles_per_bid": {k: v / max(bw[-1], 1) for k, v in zip(BID_PHASES, bw)}}
           if kind == "pr5" else {}),
        "bidders_per_round_hist_sample0": hist.tolist(),
        "atomic_sass": atom,
    }))
    return 0 if same else 1


def main() -> int:
    if sys.argv[1:] == ["--breakdown"]:
        return breakdown()
    if sys.argv[1:2] == ["--breakdown-list"]:
        return breakdown("list", int(sys.argv[2]) if len(sys.argv) > 2 else 256)
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = card()
    for i, tree in enumerate(trees):
        res = subprocess.run([sys.executable, "-c", CODE], cwd=os.path.abspath(tree),
                             capture_output=True, text=True)
        lines = [json.loads(s) for s in res.stdout.splitlines() if s.startswith('{"runs"')]
        if res.returncode != 0 or not lines or not all(
                v["bitwise"] for v in lines[0]["runs"].values()):
            print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        print(json.dumps({"run": i, "tree": tree, "card": smi, **lines[0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
