// Bertsekas' auction (min-cost row -> column assignment) for Hopper (sm_90a),
// plain C interface, one block per sample.
//
// Replaces accvlab_tpu/ragged/matching.py:29-160 (auction_matching under
// vmap in batched_auction_matching): a lax.while_loop of bid rounds inside
// jit, which XLA runs on the device with no host round trip. There is no
// Pallas kernel behind it. In eager PyTorch the same loop costs about 20
// small launches and one host synchronisation (the exit test) per round,
// and a sample takes hundreds to thousands of rounds; this kernel runs every
// round of one sample inside one block and never returns to the host.
//
// The round is the JAX round, computed exactly (Jacobi style, every bidder
// against the same prices):
//   1. every valid unassigned row r finds, over values[c] = -cost[r][c] -
//      prices[c], the first argmax best (lowest column on ties; a NaN ranks
//      above every number, as in jnp.argmax and torch.argmax), its value
//      best_val, and second_val, the max over every other column (-inf when
//      C == 1);
//   2. bid = (prices[best] + (best_val - second_val)) + eps, in that order
//      (NaN when best_val is);
//   3. each column keeps its highest bid, the lowest row among equal bids;
//      a NaN bid is the highest (the column max of jnp and torch propagates
//      it); a column whose highest bid is not finite has no winner this
//      round (matching.py:86: the infinite or NaN bid still holds the
//      column's maximum);
//   4. the previous owner of every won column is evicted, the winner
//      installed, the column's price set to the winning bid;
//   5. stop when no valid row is unassigned or after max_iters rounds.
// Evicted rows are assigned rows and winners unassigned ones, so the two
// sets are disjoint and the column pass writes each row at most once: no
// write order matters (matching.py:95-106 does the same with a gather).
//
// Design, a first one that only has to be right:
//   * the valid rows of the (R, C) cost are copied into dynamic shared
//     memory when the whole matrix fits
//     (the batched loss example's (48, 300) float32 is 57.6 kB, above the
//     default 48 kB, so the launch opts in), else read through L2;
//   * prices, owners, per-column bid keys and col_of_row live in shared
//     memory;
//   * bidding: one warp per bidding row, each lane scanning a strided share
//     of the columns for (best, its column, second) over the numbers and for
//     its first NaN column apart, off the scan's dependency chain; then a
//     shuffle reduction, ties to the lower column, and a warp min of the NaN
//     columns: a NaN, where there is one, is the best;
//   * column bids: a 64-bit atomicMax on (order-preserving float bits << 32
//     | ~row): the maximum is the highest bid and, among equal bids, the
//     lowest row, whatever order the warps arrive in;
//   * __syncthreads() between the bid pass and the column pass, and
//     __syncthreads_or() for the exit test;
//   * it counts the bids each sample placed (one per bidding row per
//     round), the work its rounds did.
// What bounds it: each round reads the bidders' cost rows from shared
// memory and does a few operations per entry; one
// sample is one block, so a batch of 8 fills 8 of the 132 SMs and the work
// is held by the rounds' latency (a chain of dependent shared-memory passes
// and barriers), not by the card's rates.
//
// Numerics: the bid spells each rounding out (__fadd_rn, __fsub_rn) and the
// file is built with -fmad=false; negation and max are exact, so the result
// is the JAX round's bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t ordered_bits(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// (best value, its column, second value) of one lane or of a merged group.
struct Best {
  float best;
  int col;
  float second;
};

// Merge two candidates over numbers (a NaN compares false and never enters):
// the higher value (the lower column on a tie) is the best; the second is
// the max of everything else.
__device__ __forceinline__ Best merge(Best a, Best b) {
  if (b.best > a.best || (b.best == a.best && b.col < a.col)) {
    return Best{b.best, b.col, fmaxf(b.second, a.best)};
  }
  return Best{a.best, a.col, fmaxf(a.second, b.best)};
}

template <bool COST_IN_SMEM>
__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ cost, const int* __restrict__ num_valid,
               const float* __restrict__ eps, int* __restrict__ col_of_row_out,
               int* __restrict__ rounds_out, int* __restrict__ bids_out, int rows, int cols,
               int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);  // [cols]
  float* prices = reinterpret_cast<float*>(keys + cols);                    // [cols]
  int* owner = reinterpret_cast<int*>(prices + cols);                        // [cols]
  int* col_of_row = owner + cols;                                            // [rows]
  int* bids = col_of_row + rows;                                             // [1]
  float* cost_s = reinterpret_cast<float*>(bids + 1);                        // [rows * cols]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* cost_b = cost + static_cast<size_t>(b) * rows * cols;
  const int n_valid = num_valid[b];
  const int n_rows = max(0, min(n_valid, rows));  // the rows that bid
  const float eps_b = eps[b];
  if (tid == 0) *bids = 0;

  for (int c = tid; c < cols; c += kThreads) {
    keys[c] = 0ull;
    prices[c] = 0.0f;
    owner[c] = -1;
  }
  for (int r = tid; r < rows; r += kThreads) col_of_row[r] = -1;
  if (COST_IN_SMEM) {
    for (int i = tid; i < n_rows * cols; i += kThreads) cost_s[i] = cost_b[i];
  }
  const float* cst = COST_IN_SMEM ? cost_s : cost_b;
  __syncthreads();

  int it = 0;
  int warp_bids = 0;
  int active = n_rows > 0 ? 1 : 0;  // some valid row is unassigned
  while (it < max_iters && active) {
    // bid pass: one warp per unassigned valid row
    for (int r = warp; r < n_rows; r += kWarps) {
      if (col_of_row[r] >= 0) continue;
      ++warp_bids;
      const float* row = cst + static_cast<size_t>(r) * cols;
      Best m{-INFINITY, 0x7fffffff, -INFINITY};
      unsigned nan_col = 0x7fffffffu;  // the lane's first NaN column
      for (int c = lane; c < cols; c += 32) {
        const float v = __fsub_rn(-row[c], prices[c]);
        if (v > m.best || (v == m.best && c < m.col)) {
          m.second = fmaxf(m.second, m.best);
          m.best = v;
          m.col = c;
        } else {
          m.second = fmaxf(m.second, v);  // fmaxf passes over a NaN
        }
        if (isnan(v)) nan_col = min(nan_col, static_cast<unsigned>(c));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        Best o{__shfl_xor_sync(0xffffffffu, m.best, off),
               __shfl_xor_sync(0xffffffffu, m.col, off),
               __shfl_xor_sync(0xffffffffu, m.second, off)};
        m = merge(m, o);
      }
      // argmax order puts a NaN above every number (jnp.argmax and
      // torch.argmax take the first NaN): its bid is NaN, whatever the second
      nan_col = __reduce_min_sync(0xffffffffu, nan_col);
      if (nan_col != 0x7fffffffu) {
        m.best = __uint_as_float(0x7fffffffu);
        m.col = static_cast<int>(nan_col);
      }
      if (lane == 0) {
        const float bid =
            __fadd_rn(__fadd_rn(prices[m.col], __fsub_rn(m.best, m.second)), eps_b);
        const uint32_t bits = isnan(bid) ? 0xffffffffu : ordered_bits(bid);
        const unsigned long long key =
            (static_cast<unsigned long long>(bits) << 32) |
            static_cast<unsigned long long>(~static_cast<uint32_t>(r));
        atomicMax(&keys[m.col], key);
      }
    }
    __syncthreads();

    // column pass: evict, install, price; clear the keys for the next round
    for (int c = tid; c < cols; c += kThreads) {
      const unsigned long long key = keys[c];
      if (key == 0ull) continue;
      keys[c] = 0ull;
      const float bid = from_ordered_bits(static_cast<uint32_t>(key >> 32));
      if (!isfinite(bid)) continue;
      const int winner = static_cast<int>(~static_cast<uint32_t>(key & 0xffffffffull));
      const int prev = owner[c];
      if (prev >= 0) col_of_row[prev] = -1;
      col_of_row[winner] = c;
      owner[c] = winner;
      prices[c] = bid;
    }
    __syncthreads();

    ++it;
    int unassigned = 0;
    for (int r = tid; r < n_rows; r += kThreads) {
      unassigned |= (col_of_row[r] < 0);
    }
    active = __syncthreads_or(unassigned);
  }

  if (lane == 0 && warp_bids > 0) atomicAdd(bids, warp_bids);
  for (int r = tid; r < rows; r += kThreads) {
    col_of_row_out[static_cast<size_t>(b) * rows + r] = r < n_rows ? col_of_row[r] : -1;
  }
  __syncthreads();
  if (tid == 0) {
    rounds_out[b] = it;
    bids_out[b] = *bids;
  }
}

size_t state_bytes(int rows, int cols) {
  return static_cast<size_t>(cols) * (8 + 4 + 4) + static_cast<size_t>(rows) * 4 + 4;
}

}  // namespace

extern "C" {

// Shared memory (bytes) the launch needs for (rows, cols) with the cost in
// shared memory (cost_in_smem = 1) or read through L2 (0).
size_t accvlab_auction_smem_bytes(int rows, int cols, int cost_in_smem) {
  return state_bytes(rows, cols) +
         (cost_in_smem ? static_cast<size_t>(rows) * cols * sizeof(float) : 0);
}

// Largest dynamic shared memory a block may opt in to on the current device.
int accvlab_auction_smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess) {
    return -1;
  }
  return bytes;
}

// Auction of B samples: cost (B, rows, cols) float32 (cols >= rows),
// num_valid (B,) int32 (rows >= num_valid[b] take part; the others get -1),
// eps (B,) float32 bid increments; writes col_of_row (B, rows) int32 (-1 for
// invalid and unassigned rows), rounds (B,) int32, the bid rounds each
// sample ran, and bids (B,) int32, the bids it placed over those rounds.
// Returns cudaGetLastError() after the launch (0 = success).
int accvlab_auction(const float* cost, const int* num_valid, const float* eps, int* col_of_row,
                    int* rounds, int* bids, int batch, int rows, int cols, int max_iters,
                    int cost_in_smem, void* stream) {
  if (batch <= 0) return 0;
  const size_t smem = accvlab_auction_smem_bytes(rows, cols, cost_in_smem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = cost_in_smem ? auction_kernel<true> : auction_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<batch, kThreads, smem, s>>>(cost, num_valid, eps, col_of_row, rounds, bids, rows, cols,
                                       max_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
