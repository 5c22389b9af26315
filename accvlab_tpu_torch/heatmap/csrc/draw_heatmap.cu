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
// The target parameters (centre, reach r_t, 1/(2 sigma^2) iv_t, class sel_t,
// peak k_t) are prepared by the Python wrapper; an invalid target has
// r_t = -1 and so reaches no pixel.
//
// Design (what the TPU kernels compute, not how their blocks were laid out):
//   * one thread per output pixel of one (sample, class) map; blocks of
//     kThreads consecutive pixels, block index = map * tiles + tile;
//   * the sample's targets are staged through shared memory in chunks of
//     kChunk (the TPU kernel's target-chunk grid axis becomes this loop);
//   * a running max is kept in a register and combined with the input map
//     at the end: deterministic without atomics, since max does not depend
//     on the order of the targets;
//   * LOG_DOMAIN (k > 0, draw.py rule): max over the exponent q, one exp per
//     pixel; otherwise exp-first, exp only for in-box targets.
//
// Bound: memory. It reads and writes B*C*H*W*4 bytes (the targets are a few
// KB); the arithmetic per pixel is a few dozen flops per in-box target. The
// design keeps each pixel one read and one write; faster variants are later
// work.
//
// Numerics: EXACT implements accvlab_tpu/heatmap/repro_exp.py::exp_f32 with
// explicit round-to-nearest intrinsics, and the file is built with
// -fmad=false besides, so no multiply-add is contracted into an FMA. The fast
// path uses expf (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;

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

template <bool EXACT, bool USE_SEL, bool LOG_DOMAIN, bool PER_TARGET_K>
__global__ void __launch_bounds__(kThreads) draw_heatmap_kernel(
    const float* __restrict__ hm_in, float* __restrict__ hm_out,
    const float* __restrict__ xs, const float* __restrict__ ys,
    const float* __restrict__ rr, const float* __restrict__ iv,
    const int* __restrict__ sel, const float* __restrict__ kt,
    int num_classes, int height, int width, int num_targets, int tiles,
    float k_scale) {
  __shared__ float s_x[kChunk];
  __shared__ float s_y[kChunk];
  __shared__ float s_r[kChunk];
  __shared__ float s_iv[kChunk];
  __shared__ float s_k[PER_TARGET_K ? kChunk : 1];
  __shared__ int s_sel[USE_SEL ? kChunk : 1];

  const int64_t block = blockIdx.x;
  const int64_t map = block / tiles;  // sample * num_classes + class
  const int tile = static_cast<int>(block - map * tiles);
  const int sample = static_cast<int>(map / num_classes);
  const int cls = static_cast<int>(map - static_cast<int64_t>(sample) * num_classes);
  const int hw = height * width;
  const int pix = tile * kThreads + threadIdx.x;
  const bool live = pix < hw;
  const int row = live ? pix / width : 0;
  const float py = static_cast<float>(row);
  const float px = static_cast<float>(live ? pix - row * width : 0);

  float best = -INFINITY;
  const int64_t tbase = static_cast<int64_t>(sample) * num_targets;
  for (int t0 = 0; t0 < num_targets; t0 += kChunk) {
    const int n = min(kChunk, num_targets - t0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int64_t g = tbase + t0 + i;
      s_x[i] = xs[g];
      s_y[i] = ys[g];
      s_r[i] = rr[g];
      s_iv[i] = iv[g];
      if (PER_TARGET_K) s_k[i] = kt[g];
      if (USE_SEL) s_sel[i] = sel[g];
    }
    __syncthreads();
    if (live) {
      for (int i = 0; i < n; ++i) {
        if (USE_SEL && s_sel[i] != cls) continue;
        const float dy = __fsub_rn(py, s_y[i]);
        const float dx = __fsub_rn(px, s_x[i]);
        const float r = s_r[i];
        if (!(fabsf(dy) <= r && fabsf(dx) <= r)) continue;
        const float d2 = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
        const float q = __fmul_rn(-d2, s_iv[i]);
        if (LOG_DOMAIN) {
          best = fmaxf(best, q);
        } else {
          const float k = PER_TARGET_K ? s_k[i] : k_scale;
          best = fmaxf(best, __fmul_rn(gauss_exp<EXACT>(q), k));
        }
      }
    }
  }
  if (!live) return;
  const int64_t o = map * hw + pix;
  float drawn = best;
  if (LOG_DOMAIN && best != -INFINITY) drawn = __fmul_rn(gauss_exp<EXACT>(best), k_scale);
  hm_out[o] = fmaxf(hm_in[o], drawn);
}

struct Args {
  const float* hm_in;
  float* hm_out;
  const float* xs;
  const float* ys;
  const float* rr;
  const float* iv;
  const int* sel;
  const float* kt;
  int num_classes, height, width, num_targets, tiles;
  float k_scale;
};

template <bool EXACT, bool USE_SEL, bool LOG_DOMAIN, bool PER_TARGET_K>
void launch(const Args& a, int64_t blocks, cudaStream_t stream) {
  draw_heatmap_kernel<EXACT, USE_SEL, LOG_DOMAIN, PER_TARGET_K>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          a.hm_in, a.hm_out, a.xs, a.ys, a.rr, a.iv, a.sel, a.kt,
          a.num_classes, a.height, a.width, a.num_targets, a.tiles, a.k_scale);
}

template <bool EXACT, bool USE_SEL>
void dispatch_domain(const Args& a, bool log_domain, int64_t blocks, cudaStream_t s) {
  if (a.kt != nullptr) {
    launch<EXACT, USE_SEL, false, true>(a, blocks, s);  // per-target k: exp-first
  } else if (log_domain) {
    launch<EXACT, USE_SEL, true, false>(a, blocks, s);
  } else {
    launch<EXACT, USE_SEL, false, false>(a, blocks, s);
  }
}

}  // namespace

extern "C" {

// Draw into hm_out (B, C, H, W) = max(hm_in, gaussians); hm_in may equal
// hm_out. Targets are (B, T) float arrays xs, ys, rr, iv; sel (B, T) int32 or
// null (no class selection, C must be 1 unless every class gets every target);
// kt (B, T) float32 per-target peak or null (then k_scale, and log_domain
// selects the one-exp-per-pixel form, valid for k_scale > 0).
// Returns cudaGetLastError() after the launch (0 = success).
int accvlab_draw_heatmap(const float* hm_in, float* hm_out, const float* xs,
                         const float* ys, const float* rr, const float* iv,
                         const int* sel, const float* kt, int num_samples,
                         int num_classes, int height, int width, int num_targets,
                         float k_scale, int exact, int log_domain, void* stream) {
  const int hw = height * width;
  const int tiles = (hw + kThreads - 1) / kThreads;
  const int64_t blocks = static_cast<int64_t>(num_samples) * num_classes * tiles;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  Args a{hm_in, hm_out, xs, ys, rr, iv, sel, kt,
         num_classes, height, width, num_targets, tiles, k_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool use_sel = sel != nullptr;
  if (exact) {
    if (use_sel) dispatch_domain<true, true>(a, log_domain, blocks, s);
    else dispatch_domain<true, false>(a, log_domain, blocks, s);
  } else {
    if (use_sel) dispatch_domain<false, true>(a, log_domain, blocks, s);
    else dispatch_domain<false, false>(a, log_domain, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
