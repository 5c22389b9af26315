// Gaussian heatmap rasterizer for Hopper (sm_90a), plain C interface.
//
// Replaces the two TPU (Pallas) kernels of accvlab_tpu/heatmap/draw.py:
//   * _batched_kernel  (draw.py:208-230, launched by _pallas_draw_batched)
//   * _tiled_kernel    (draw.py:278-314, launched by _pallas_draw_tiled)
// and carries the pipeline variant accvlab_tpu/heatmap/draw_gaussians.py
// (float radii with ceil(r) reach, sigma = r * factor, peak k per class).
//
// What it computes, for every pixel p of every (sample, class) map:
//   out[p] = max(in[p], max_t{ contrib_t(p) : |dy| <= r_t, |dx| <= r_t,
//                                              sel_t == class (if selecting) })
//   contrib_t(p) = exp(-(dy^2 + dx^2) * iv_t) * k_t
//
// What bounds it. The maps are read once and written once (B*C*H*W*4 bytes
// each way); the targets are a few KB, and only a small share of the
// (pixel, target) pairs lies inside a target's box (about 0.05 per pixel on
// the pipeline's heatmaps). So the floor is the card's memory rate. A kernel
// that tests every target at every pixel is held by instruction issue
// instead, 6.7-125x over that floor. The design keeps the per-pixel work to
// the targets that can reach the pixel and moves the bytes in 16-byte
// accesses:
//   * one block per (map, tile), map = sample * C + class; a tile is
//     ROWS * tile_y rows by 4 * tile_x columns. Each thread owns 4
//     neighbouring pixels in each of ROWS rows, tile_y rows apart (one
//     float4 load and store per row where rows are 16-byte aligned, scalar
//     accesses otherwise). The block loads its input pixels first, so their
//     latency hides behind the culling;
//   * phase 1: the targets go through the block in chunks of blockDim, one
//     per thread. Each thread prepares its target from the raw inputs
//     (validity, reach, 1/(2 sigma^2), peak: the same float operations, in
//     the same order, as the wrappers' plain versions), and keeps it only if
//     its class matches and the per-pixel box test passes at the tile's
//     pixel nearest to the centre. Centres and pixel coordinates are
//     integers and rounding is monotone, so that pixel passes if any pixel
//     of the tile passes: the cull drops no target that draws in the tile.
//     Survivors are compacted in target order (warp ballots, a prefix over
//     the warps) into shared memory;
//   * phase 2: each thread tests its pixels against the survivors only, with
//     the per-pixel test and arithmetic unchanged, keeping a running max in
//     registers across chunks. The block owns its tile, so the result is
//     deterministic without atomics;
//   * LOG_DOMAIN (k > 0, draw.py rule): max over the exponent q, one exp per
//     pixel; otherwise exp-first, exp only for in-box targets.
// The tile shape is a launch argument. The wrappers choose it from the grid
// and the targets per sample (_kernel.choose_tile), by measurement on the
// card (scripts/torch_raster_tiles.py, see PERF.md): 32 x 32 pixels with 128
// threads; 256 threads where a sample has more targets than 128 threads
// cull at once; 32 x 8 pixels where the maps give under two blocks per SM.
//
// Numerics: EXACT implements accvlab_tpu/heatmap/repro_exp.py::exp_f32 with
// explicit round-to-nearest intrinsics, and the file is built with
// -fmad=false besides, so no multiply-add is contracted into an FMA. The
// target preparation spells out each rounding (__fmul_rn, __fadd_rn,
// __fdiv_rn) in PyTorch's left-to-right order. The fast path uses expf (no
// --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // threads per block, and targets per chunk
constexpr int kPix = 4;           // pixels per thread, neighbours along x
constexpr int kMaxClasses = 256;  // entries of the peak table passed by value

enum Form { kDraw = 0, kGauss = 1 };

// float32 constants of repro_exp.py, by bit pattern
__device__ __forceinline__ float f32_bits(uint32_t u) { return __uint_as_float(u); }
#define LOG2E f32_bits(0x3fb8aa3bu)
#define LN2_HI f32_bits(0x3f317200u)
#define LN2_LO f32_bits(0x35bfbe8eu)
#define MIN_X f32_bits(0xc2ae0000u)   // -87
#define SPLIT f32_bits(0x45800800u)   // 4097

__device__ __forceinline__ void dekker_mul(float x, float y, float& p, float& err) {
  p = __fmul_rn(x, y);
  const float c = __fmul_rn(SPLIT, x);
  const float xh = __fsub_rn(c, __fsub_rn(c, x));
  const float xl = __fsub_rn(x, xh);
  const float d = __fmul_rn(SPLIT, y);
  const float yh = __fsub_rn(d, __fsub_rn(d, y));
  const float yl = __fsub_rn(y, yh);
  err = __fadd_rn(
      __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(xh, yh), p), __fmul_rn(xh, yl)),
                __fmul_rn(xl, yh)),
      __fmul_rn(xl, yl));
}

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float z = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, z)), __fsub_rn(b, z));
}

// repro_exp.py::exp_f32, bit for bit
__device__ float exp_f32(float x) {
  const float coeffs[7] = {f32_bits(0x3f800000u), f32_bits(0x3f800000u),
                           f32_bits(0x3f000000u), f32_bits(0x3e2aaaabu),
                           f32_bits(0x3d2aaaabu), f32_bits(0x3c088889u),
                           f32_bits(0x3ab60b61u)};
  const int k = static_cast<int>(rintf(__fmul_rn(x, LOG2E)));
  const float kf = static_cast<float>(k);
  const float s = __fsub_rn(x, __fmul_rn(kf, LN2_HI));
  float b, berr;
  dekker_mul(kf, LN2_LO, b, berr);
  const float t = __fsub_rn(s, b);
  float hi = coeffs[6];
  float lo = 0.0f;
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float qh, qe, lh, le, rh, re;
    dekker_mul(hi, t, qh, qe);
    dekker_mul(lo, t, lh, le);
    two_sum(qh, coeffs[i], rh, re);
    hi = rh;
    lo = __fadd_rn(__fadd_rn(qe, lh), __fadd_rn(re, le));
  }
  const int kk = min(max(k, -126), 126);
  const float scale = __int_as_float((kk + 127) << 23);
  const float r = __fadd_rn(hi, lo);
  return x < MIN_X ? 0.0f : __fmul_rn(r, scale);
}

template <bool EXACT>
__device__ __forceinline__ float gauss_exp(float q) {
  return EXACT ? exp_f32(q) : expf(q);
}

// Raw per-target inputs, each (B, T) row-major unless noted.
struct Targets {
  const int* centers;           // (B, T, 2): x, y
  const void* radii;            // int32 (kDraw) or float32 (kGauss)
  const int* num_valid;         // kDraw: (B,) valid targets per sample, or null (all)
  const unsigned char* active;  // kGauss: bool
  const int* sel;               // class per target, or null (kDraw without selection)
};

struct Geometry {
  int num_classes, height, width, num_targets;
  int tile_x, tile_y, tiles_x, tiles;  // threads along x and y; tiles per row, per map
  float factor, k_scale;
  bool vec;  // rows 16-byte aligned: float4 accesses
};

// the peak table by value (per-class k of draw_gaussians); empty for kDraw
template <int FORM> struct PeakTable { float v[1]; };
template <> struct PeakTable<kGauss> { float v[kMaxClasses]; };

struct Target {
  float x, y, r, iv, k;
  int sel;
};

// The wrappers' plain preparation (draw.py::_prep_target_params and
// _gauss_inv_var; draw_gaussians.py::gaussian_params), operation for operation.
template <int FORM>
__device__ __forceinline__ Target prepare(const Targets& tg, const Geometry& g,
                                          const PeakTable<FORM>& peaks, int sample, int t) {
  const int64_t i = static_cast<int64_t>(sample) * g.num_targets + t;
  Target p;
  p.x = static_cast<float>(tg.centers[2 * i]);
  p.y = static_cast<float>(tg.centers[2 * i + 1]);
  if constexpr (FORM == kDraw) {
    const float rf = static_cast<float>(static_cast<const int*>(tg.radii)[i]);
    const bool valid = tg.num_valid == nullptr || t < tg.num_valid[sample];
    const float diameter = __fadd_rn(__fmul_rn(2.0f, rf), 1.0f);
    const float sigma = __fdiv_rn(diameter, g.factor);
    const float var = __fmul_rn(__fmul_rn(2.0f, sigma), sigma);
    p.iv = __fdiv_rn(1.0f, var);
    p.r = valid ? rf : -1.0f;  // -1: the box test never passes
    p.k = g.k_scale;
    p.sel = tg.sel != nullptr ? tg.sel[i] : 0;  // out of range: matches no map
  } else {
    const float rad = static_cast<const float*>(tg.radii)[i];
    const int id = min(max(tg.sel[i], 0), max(g.num_classes - 1, 0));
    p.r = tg.active[i] ? ceilf(rad) : -1.0f;
    const float sigma = __fmul_rn(rad, g.factor);
    const float v = __fmul_rn(__fmul_rn(2.0f, sigma), sigma);
    const float var2 = isnan(v) ? v : fmaxf(v, 1e-12f);  // torch.maximum keeps NaN
    p.iv = __fdiv_rn(1.0f, var2);
    p.k = peaks.v[id];
    p.sel = id;
  }
  return p;
}

// The per-pixel box test at the tile pixel nearest to the centre: if it
// fails there, it fails at every pixel of the tile. NaN and negative reach
// fail; a reach of -0.0 passes only at the centre pixel, as per pixel.
__device__ __forceinline__ bool touches(const Target& p, float y0, float y1, float x0, float x1) {
  const float dy = __fsub_rn(fminf(fmaxf(p.y, y0), y1), p.y);
  const float dx = __fsub_rn(fminf(fmaxf(p.x, x0), x1), p.x);
  return fabsf(dy) <= p.r && fabsf(dx) <= p.r;
}

template <int FORM, int ROWS, bool EXACT, bool USE_SEL, bool LOG_DOMAIN>
__global__ void __launch_bounds__(kMaxThreads) draw_heatmap_kernel(
    const float* __restrict__ hm_in, float* __restrict__ hm_out, const Targets tg,
    const Geometry g, const PeakTable<FORM> peaks) {
  constexpr bool kPerTargetK = FORM == kGauss;
  __shared__ float s_x[kMaxThreads];
  __shared__ float s_y[kMaxThreads];
  __shared__ float s_r[kMaxThreads];
  __shared__ float s_iv[kMaxThreads];
  __shared__ float s_k[kPerTargetK ? kMaxThreads : 1];
  __shared__ int s_warp_count[kMaxThreads / 32];

  const int64_t block = blockIdx.x;
  const int64_t map = block / g.tiles;  // sample * num_classes + class
  const int tile = static_cast<int>(block - map * g.tiles);
  const int sample = static_cast<int>(map / g.num_classes);
  const int cls = static_cast<int>(map - static_cast<int64_t>(sample) * g.num_classes);
  const int tile_row = tile / g.tiles_x;
  const int tile_col = tile - tile_row * g.tiles_x;
  const int tile_h = g.tile_y * ROWS;
  const int tile_w = g.tile_x * kPix;

  // tile bounds, clipped to the map, as pixel coordinates
  const int ty0 = tile_row * tile_h;
  const int tx0 = tile_col * tile_w;
  const float fy0 = static_cast<float>(ty0);
  const float fy1 = static_cast<float>(min(ty0 + tile_h, g.height) - 1);
  const float fx0 = static_cast<float>(tx0);
  const float fx1 = static_cast<float>(min(tx0 + tile_w, g.width) - 1);

  const int tid = threadIdx.x;
  const int row0 = ty0 + tid / g.tile_x;  // this thread's rows: row0 + r * tile_y
  const int col = tx0 + (tid % g.tile_x) * kPix;
  const bool live = row0 < g.height && col < g.width;
  const int64_t o0 = (map * g.height + row0) * g.width + col;
  const int64_t row_step = static_cast<int64_t>(g.tile_y) * g.width;

  // the input pixels first: their latency hides behind the culling
  float in[ROWS][kPix];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (!live || row0 + r * g.tile_y >= g.height) continue;
    const float* src = hm_in + o0 + r * row_step;
    if (g.vec) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      in[r][0] = v.x; in[r][1] = v.y; in[r][2] = v.z; in[r][3] = v.w;
    } else {
#pragma unroll
      for (int u = 0; u < kPix; ++u) in[r][u] = col + u < g.width ? src[u] : 0.0f;
    }
  }

  float px[kPix];
#pragma unroll
  for (int u = 0; u < kPix; ++u) px[u] = static_cast<float>(col + u);
  float best[ROWS][kPix];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int u = 0; u < kPix; ++u) best[r][u] = -INFINITY;
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_warps = blockDim.x >> 5;
  for (int t0 = 0; t0 < g.num_targets; t0 += blockDim.x) {
    // phase 1: prepare and cull one target per thread
    Target p{};
    bool keep = false;
    if (t0 + tid < g.num_targets) {
      p = prepare<FORM>(tg, g, peaks, sample, t0 + tid);
      keep = (!USE_SEL || p.sel == cls) && touches(p, fy0, fy1, fx0, fx1);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    __syncthreads();  // the previous chunk's survivors are no longer read
    if (lane == 0) s_warp_count[warp] = __popc(ballot);
    __syncthreads();
    int slot = 0;
    int n = 0;
    for (int w = 0; w < num_warps; ++w) {
      const int c = s_warp_count[w];
      slot += w < warp ? c : 0;
      n += c;
    }
    if (keep) {  // compacted in target order
      slot += __popc(ballot & ((1u << lane) - 1u));
      s_x[slot] = p.x;
      s_y[slot] = p.y;
      s_r[slot] = p.r;
      s_iv[slot] = p.iv;
      if (kPerTargetK) s_k[slot] = p.k;
    }
    __syncthreads();

    // phase 2: this thread's pixels against the survivors
    if (live) {
      for (int j = 0; j < n; ++j) {
        const float rj = s_r[j];
        const float yj = s_y[j];
        const float xj = s_x[j];
        const float iv = s_iv[j];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float dy = __fsub_rn(static_cast<float>(row0 + r * g.tile_y), yj);
          if (!(fabsf(dy) <= rj)) continue;
#pragma unroll
          for (int u = 0; u < kPix; ++u) {
            const float dx = __fsub_rn(px[u], xj);
            if (!(fabsf(dx) <= rj)) continue;
            const float d2 = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
            const float q = __fmul_rn(-d2, iv);
            if (LOG_DOMAIN) {
              best[r][u] = fmaxf(best[r][u], q);
            } else {
              const float k = kPerTargetK ? s_k[j] : g.k_scale;
              best[r][u] = fmaxf(best[r][u], __fmul_rn(gauss_exp<EXACT>(q), k));
            }
          }
        }
      }
    }
  }
  if (!live) return;

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (row0 + r * g.tile_y >= g.height) continue;
    float out[kPix];
#pragma unroll
    for (int u = 0; u < kPix; ++u) {
      float drawn = best[r][u];
      if (LOG_DOMAIN && drawn != -INFINITY) drawn = __fmul_rn(gauss_exp<EXACT>(drawn), g.k_scale);
      out[u] = fmaxf(in[r][u], drawn);
    }
    float* dst = hm_out + o0 + r * row_step;
    if (g.vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int u = 0; u < kPix; ++u) {
        if (col + u < g.width) dst[u] = out[u];
      }
    }
  }
}

// Fills the tiling of g and launches; returns a CUDA error code.
template <int FORM, int ROWS, bool EXACT, bool USE_SEL, bool LOG_DOMAIN>
int launch_rows(const float* hm_in, float* hm_out, const Targets& tg, Geometry g,
                const PeakTable<FORM>& peaks, int num_samples, cudaStream_t stream) {
  const int threads = g.tile_x * g.tile_y;
  if (g.tile_x < 1 || g.tile_y < 1 || threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g.tiles_x = (g.width + g.tile_x * kPix - 1) / (g.tile_x * kPix);
  g.tiles = g.tiles_x * ((g.height + g.tile_y * ROWS - 1) / (g.tile_y * ROWS));
  g.vec = g.width % kPix == 0 && reinterpret_cast<uintptr_t>(hm_in) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(hm_out) % 16 == 0;
  const int64_t blocks = static_cast<int64_t>(num_samples) * g.num_classes * g.tiles;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  draw_heatmap_kernel<FORM, ROWS, EXACT, USE_SEL, LOG_DOMAIN>
      <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(hm_in, hm_out, tg, g, peaks);
  return static_cast<int>(cudaGetLastError());
}

// rows per thread: 1, 2 or 4
template <int FORM, bool EXACT, bool USE_SEL, bool LOG_DOMAIN>
int launch(const float* hm_in, float* hm_out, const Targets& tg, const Geometry& g, int rows,
           const PeakTable<FORM>& peaks, int num_samples, cudaStream_t s) {
  switch (rows) {
    case 1:
      return launch_rows<FORM, 1, EXACT, USE_SEL, LOG_DOMAIN>(hm_in, hm_out, tg, g, peaks,
                                                              num_samples, s);
    case 2:
      return launch_rows<FORM, 2, EXACT, USE_SEL, LOG_DOMAIN>(hm_in, hm_out, tg, g, peaks,
                                                              num_samples, s);
    case 4:
      return launch_rows<FORM, 4, EXACT, USE_SEL, LOG_DOMAIN>(hm_in, hm_out, tg, g, peaks,
                                                              num_samples, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool EXACT, bool USE_SEL>
int dispatch_draw(const float* hm_in, float* hm_out, const Targets& tg, const Geometry& g,
                  int rows, bool log_domain, int num_samples, cudaStream_t s) {
  const PeakTable<kDraw> none{};
  return log_domain ? launch<kDraw, EXACT, USE_SEL, true>(hm_in, hm_out, tg, g, rows, none,
                                                         num_samples, s)
                    : launch<kDraw, EXACT, USE_SEL, false>(hm_in, hm_out, tg, g, rows, none,
                                                          num_samples, s);
}

}  // namespace

extern "C" {

// draw.py form. Draw into hm_out (B, C, H, W) = max(hm_in, gaussians) for
// int32 centers (B, T, 2) and radii (B, T); num_valid (B,) int32 counts the
// valid targets of each sample (null: all are valid); sel (B, T) int32 class
// per target, or null (no class selection: C must be 1 unless every class
// gets every target). sigma = (2r + 1) / factor; peak k_scale; log_domain
// selects the one-exp-per-pixel form, valid for k_scale > 0. The tile is
// tile_x * 4 columns by tile_y * rows rows (tile_x * tile_y threads, a
// multiple of 32, at most 256; rows 1, 2 or 4 per thread). Returns
// cudaGetLastError() after the launch (0 = success).
int accvlab_draw_heatmap(const float* hm_in, float* hm_out, const int* centers,
                         const int* radii, const int* num_valid, const int* sel,
                         int num_samples, int num_classes, int height, int width,
                         int num_targets, float factor, float k_scale, int exact,
                         int log_domain, int tile_x, int tile_y, int rows, void* stream) {
  const Targets tg{centers, radii, num_valid, nullptr, sel};
  const Geometry g{num_classes, height, width, num_targets, tile_x, tile_y, 0, 0,
                   factor, k_scale, false};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exact) {
    return sel != nullptr
               ? dispatch_draw<true, true>(hm_in, hm_out, tg, g, rows, log_domain, num_samples, s)
               : dispatch_draw<true, false>(hm_in, hm_out, tg, g, rows, log_domain, num_samples, s);
  }
  return sel != nullptr
             ? dispatch_draw<false, true>(hm_in, hm_out, tg, g, rows, log_domain, num_samples, s)
             : dispatch_draw<false, false>(hm_in, hm_out, tg, g, rows, log_domain, num_samples, s);
}

// draw_gaussians form: bool active (B, T), int32 ids (B, T) clamped into
// [0, C-1], int32 centers (B, T, 2), float32 radii (B, T) with reach
// ceil(r) and sigma = r * factor; the peak of a target is k_table[id], where
// k_table is a HOST array of num_classes floats (num_classes <= 256), passed
// by value in the launch arguments. Tile and return value as above.
int accvlab_draw_gaussians(const float* hm_in, float* hm_out, const unsigned char* active,
                           const int* ids, const int* centers, const float* radii,
                           const float* k_table, int num_samples, int num_classes,
                           int height, int width, int num_targets, float factor, int exact,
                           int tile_x, int tile_y, int rows, void* stream) {
  if (num_classes > kMaxClasses) return static_cast<int>(cudaErrorInvalidValue);
  PeakTable<kGauss> peaks{};
  for (int c = 0; c < num_classes; ++c) peaks.v[c] = k_table[c];
  const Targets tg{centers, radii, nullptr, active, ids};
  const Geometry g{num_classes, height, width, num_targets, tile_x, tile_y, 0, 0,
                   factor, 1.0f, false};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return exact ? launch<kGauss, true, true, false>(hm_in, hm_out, tg, g, rows, peaks,
                                                   num_samples, s)
               : launch<kGauss, false, true, false>(hm_in, hm_out, tg, g, rows, peaks,
                                                    num_samples, s);
}

}  // extern "C"
