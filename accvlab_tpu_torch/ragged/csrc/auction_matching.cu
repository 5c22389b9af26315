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
//
// What bounds it: the rounds of one sample run one after another, and a
// round has few bidders (on the batched loss example's 8 x 48 x 300 cost,
// 6,442 bids over the 2,056 rounds of its slowest sample: about 3). So the
// time is the latency of a round, a chain of dependent shared-memory passes
// and barriers, not the card's rates; a batch of 8 fills 8 of the 132 SMs.
// The design spends each round's work on its bidders only:
//   * a list of the unassigned valid rows (double-buffered in shared memory)
//     replaces the scans of every row and every column: each warp takes the
//     bidders of the list in turn, and the exit test is the next list's
//     length;
//   * a bidder is one warp: each lane scans a strided share of the columns,
//     in two interleaved chains so that loads overlap compares, for (best,
//     its column, second) and apart, off those chains, for its first NaN
//     column; the lanes merge with three hardware warp reductions
//     (__reduce_max_sync / __reduce_min_sync on order-preserving bits, -0
//     folded into +0 so that equal floats stay equal) in place of a
//     shuffle tree;
//   * each bid goes to a slot of the round, (column, key), the key being
//     (order-preserving bid bits << 32 | ~row): the highest key of a column
//     is its highest bid and, among equal bids, its lowest row. After one
//     barrier each bidder compares its key with the round's other slots, a
//     lane per slot, and settles its own column if it won: it evicts the
//     previous owner, installs itself and sets the price. The evicted row,
//     or the bidder itself if it lost, goes to the next list. Winners hold
//     distinct columns and evicted rows are not bidders, so no two warps
//     write one place; no atomic decides a winner;
//   * two barriers per round: after the bids, and after the settling.
// The cost's valid rows live in dynamic shared memory when they fit (the
// example's (48, 300) float32 is 57.6 kB, above the default 48 kB, so the
// launch opts in), else they are read through L2. It counts the bids each
// sample placed (one per bidding row per round), the work its rounds did.
//
// Numerics: the bid spells each rounding out (__fadd_rn, __fsub_rn) and the
// file is built with -fmad=false; negation and max are exact, and the sign
// of a zero best or second value cannot change the bid, so the result is
// the JAX round's bit for bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoCol = 0x7fffffffu;

__device__ __forceinline__ uint32_t ordered_bits(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// (best value, its column, second value) of one chain, a lane or a merge.
struct Best {
  float best;
  int col;
  float second;
};

// Column c (value v; in: c < cols) into a chain that sees its columns in
// increasing order, with selects and no branch. The first number taken is
// the chain's first non-NaN value (a tie with the empty chain's -inf goes to
// the lower column, as argmax does); after it, only a higher value takes the
// best, so ties keep the lower column. A NaN compares false and never
// enters; fmaxf passes over it. best >= second holds throughout, so a taken
// value leaves the old best as the second (whose sign of zero cannot change
// the bid).
__device__ __forceinline__ void fold(Best& m, float v, int c, bool in) {
  const bool take = in && (v > m.best || (m.col == INT_MAX && v == v));
  const float others = in ? fmaxf(m.second, v) : m.second;
  m.second = take ? m.best : others;
  m.best = take ? v : m.best;
  m.col = take ? c : m.col;
}

// Two chains' candidates: the higher value (the lower column on a tie) is
// the best; the second is the max of everything else.
__device__ __forceinline__ Best merge(Best a, Best b) {
  const bool second_wins = b.best > a.best || (b.best == a.best && b.col < a.col);
  return second_wins ? Best{b.best, b.col, fmaxf(b.second, a.best)}
                     : Best{a.best, a.col, fmaxf(a.second, b.best)};
}

template <bool COST_IN_SMEM>
__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ cost, const int* __restrict__ num_valid,
               const float* __restrict__ eps, int* __restrict__ col_of_row_out,
               int* __restrict__ rounds_out, int* __restrict__ bids_out, int rows, int cols,
               int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* slot_key = reinterpret_cast<unsigned long long*>(smem);  // [rows]
  float* prices = reinterpret_cast<float*>(slot_key + rows);                   // [cols]
  int* owner = reinterpret_cast<int*>(prices + cols);                           // [cols]
  int* col_of_row = owner + cols;                                               // [rows]
  int* slot_col = col_of_row + rows;                                            // [rows]
  int* lists = slot_col + rows;                                                 // [2][rows]
  int* counts = lists + 2 * rows;                                               // [2]
  float* cost_s = reinterpret_cast<float*>(counts + 2);                         // [rows * cols]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* cost_b = cost + static_cast<size_t>(b) * rows * cols;
  const int n_rows = max(0, min(num_valid[b], rows));  // the rows that bid
  const float eps_b = eps[b];

  for (int c = tid; c < cols; c += kThreads) {
    prices[c] = 0.0f;
    owner[c] = -1;
  }
  for (int r = tid; r < rows; r += kThreads) {
    col_of_row[r] = -1;
    lists[r] = r;  // the first round's bidders: every valid row
  }
  if (COST_IN_SMEM) {
    for (int i = tid; i < n_rows * cols; i += kThreads) cost_s[i] = cost_b[i];
  }
  const float* cst = COST_IN_SMEM ? cost_s : cost_b;
  __syncthreads();

  int it = 0;
  int bids = 0;
  int n_bidders = n_rows;
  while (it < max_iters && n_bidders > 0) {
    const int* bidders = lists + (it & 1) * rows;
    int* next = lists + ((it + 1) & 1) * rows;
    int* next_count = counts + ((it + 1) & 1);

    // bid: one warp per bidder
    for (int i = warp; i < n_bidders; i += kWarps) {
      const int r = bidders[i];
      const float* row = cst + static_cast<size_t>(r) * cols;
      // two chains over alternate columns, so that the loads of one overlap
      // the compares of the other; merged at the end
      Best a{-INFINITY, INT_MAX, -INFINITY}, z{-INFINITY, INT_MAX, -INFINITY};
      unsigned nan_col = kNoCol;  // the lane's first NaN column
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
      // the row's best: the highest value, its lowest column; the second:
      // the winning lane's own second and every other lane's best
      const unsigned best_key = __reduce_max_sync(kFull, ordered_bits(__fadd_rn(best, 0.0f)));
      const int best_col = __reduce_min_sync(
          kFull, ordered_bits(__fadd_rn(best, 0.0f)) == best_key ? col : INT_MAX);
      const float mine = col == best_col ? second : best;
      const unsigned second_key = __reduce_max_sync(kFull, ordered_bits(__fadd_rn(mine, 0.0f)));
      // argmax order puts a NaN above every number (jnp.argmax and
      // torch.argmax take the first NaN): its bid is NaN, whatever the second
      nan_col = __reduce_min_sync(kFull, nan_col);
      // every lane computes the bid (no divergence); lane 0 stores it
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
    }
    if (tid == 0) *next_count = 0;
    __syncthreads();

    // settle: each bidder's warp settles its own column if its key is the
    // column's highest of the round
    for (int i = warp; i < n_bidders; i += kWarps) {
      const int c = slot_col[i];
      const unsigned long long key = slot_key[i];
      bool lost = false;
      for (int j0 = 0; j0 < n_bidders; j0 += 32) {  // a lane per slot
        const int j = j0 + lane;
        const bool in = j < n_bidders;
        lost |= in && (in ? slot_col[j] : -1) == c && (in ? slot_key[j] : 0ull) > key;
      }
      lost = __any_sync(kFull, lost);
      const int r = static_cast<int>(~static_cast<uint32_t>(key & 0xffffffffull));
      const bool won = !lost && isfinite(from_ordered_bits(static_cast<uint32_t>(key >> 32)));
      const int prev = won ? owner[c] : -1;
      const int unassigned = won ? prev : r;  // the row that joins the next round's bidders
      if (lane == 0) {
        if (won) {
          if (prev >= 0) col_of_row[prev] = -1;
          col_of_row[r] = c;
          owner[c] = r;
          prices[c] = from_ordered_bits(static_cast<uint32_t>(key >> 32));
        }
        if (unassigned >= 0) next[atomicAdd(next_count, 1)] = unassigned;
      }
    }
    bids += n_bidders;
    __syncthreads();
    n_bidders = *next_count;
    ++it;
  }

  for (int r = tid; r < rows; r += kThreads) {
    col_of_row_out[static_cast<size_t>(b) * rows + r] = r < n_rows ? col_of_row[r] : -1;
  }
  if (tid == 0) {
    rounds_out[b] = it;
    bids_out[b] = bids;
  }
}

size_t state_bytes(int rows, int cols) {
  // slot keys; prices and owners; col_of_row, slot columns, two lists; two counts
  return static_cast<size_t>(rows) * 8 + static_cast<size_t>(cols) * (4 + 4) +
         static_cast<size_t>(rows) * (4 + 4 + 2 * 4) + 2 * 4;
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
