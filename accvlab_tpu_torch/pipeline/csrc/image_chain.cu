// The device stage's image chain in one pass, for Hopper (sm_90a), plain C
// interface: AffineTransformer's warp, then PhotoMetricDistorter's
// distortion, then ImageMeanStdDevNormalizer's normalization, from the uint8
// frames straight to the float32 images.
//
// Replaces no Pallas kernel. The JAX package leaves the chain to XLA inside
// its device stage's jit(vmap(...)): accvlab_tpu/pipeline/operators/
// image_ops.py::warp_affine, then processing_steps/photo_metric_distorter.py
// and image_normalizers.py. Eager PyTorch (and the CUDA graph of its trace)
// runs those as dozens of full-size passes through device memory: four
// int64 index tensors and four float32 gathers for the warp, about twenty
// float32 passes for the distortion, two for the normalization.
//
// What it computes, for each output pixel (x, y) of sample b, with the
// sample's parameters (accvlab_tpu_torch/pipeline/operators/image_chain.py
// names the layout), in the steps' float32 order:
//   1. warp: source (sx, sy) = (m00*x + m01*y) + m02, (m10*x + m11*y) + m12
//      through the inverse map; outside [0, w-1] x [0, h-1] the fill 0 (the
//      affine step's), else bilinear from the floor corner, the four
//      neighbours clamped to the frame and summed in warp_affine's order;
//      round half to even, clamp to [0, 255] (the uint8 result);
//   2. distortion, the sample's active gates in the step's order: times
//      1/255; brightness then clamp to [0, 1]; contrast before, then clamp;
//      saturation about the luma; hue as the sample's 3x3 matrix (the
//      channels reversed around it for BGR); contrast after, then clamp; the
//      channel permutation; times 255, clamp to [0, 255], truncate (uint8);
//   3. normalization: (value - mean[c]) * inv_std[c].
//
// What bounds it. The memory: the frames are read once (B*H*W*3 bytes) and
// the images written once (B*oh*ow*3*4 bytes), about 70 operations per
// output pixel against 12 bytes written and, at the chain's 0.69 downscale,
// about 6 read. The design:
//   * a block per (sample, 128 pixel groups), a group being 4 neighbouring
//     output pixels of a row; the block loads its sample's parameters into
//     shared memory once, and every decision is uniform over the block.
//     Measured at the main path's shapes: 2 or 8 pixels a thread 8-15 %
//     slower, 256 or 512 threads a block 3-12 %, fewer registers (launch
//     bounds) spill and 50-130 %, stores staged through shared memory 6 %;
//   * the intermediates stay in registers; each thread stores its 12 floats
//     as three 16-byte stores where rows are 16-byte aligned (ow % 4 == 0),
//     scalar stores otherwise;
//   * the source bytes are read through the read-only path: a warp's 128
//     pixels sample two source rows over about 190 columns, so neighbours
//     and the next row's warps find them in L1/L2.
//
// Numerics: built with -fmad=false, and every rounding spelled out with
// __fmul_rn/__fadd_rn/__fsub_rn, so each operation rounds as PyTorch's
// eager kernels round it and the result is bitwise the steps' own pixel
// path, except the hue: the steps compute it with a batched float32 matrix
// product whose summation order cuBLAS does not specify. The kernel sums
// x0*m0 rounded, then two fused multiply-adds in channel order, which is
// what cuBLAS gave on every element measured on an H100 (torch 2.11); where
// a cuBLAS sums otherwise, a pixel with the hue on may land one 8-bit level
// apart at a rounding edge.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block (256 and 512: 3-12 % slower)
constexpr int kPix = 4;        // output pixels per thread, neighbours along x
constexpr int kParams = 27;    // per-sample parameters (image_chain.py: PARAMS)

// the step constants, by value
struct Consts {
  float intensity;  // float32(1/255)
  float luma[3];    // saturation's luma weights, in the image's channel order
  int bgr;          // the hue matrix acts on reversed channels
  float mean[3];
  float inv_std[3];
};

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.f), 1.f); }

__device__ __forceinline__ float pick(const float* x, int i) {
  return i == 0 ? x[0] : (i == 1 ? x[1] : x[2]);
}

// warp_affine at one output pixel: the three channel bytes as floats
__device__ __forceinline__ void warp_pixel(const uint8_t* __restrict__ img, int h, int w,
                                           const float* m, float fx, float fy, float* u) {
  const float sx = __fadd_rn(__fadd_rn(__fmul_rn(m[0], fx), __fmul_rn(m[1], fy)), m[2]);
  const float sy = __fadd_rn(__fadd_rn(__fmul_rn(m[3], fx), __fmul_rn(m[4], fy)), m[5]);
  if (!(sx >= 0.f && sx <= (float)(w - 1) && sy >= 0.f && sy <= (float)(h - 1))) {
    u[0] = u[1] = u[2] = 0.f;  // the fill value
    return;
  }
  const float x0 = floorf(sx), y0 = floorf(sy);
  const float wx = __fsub_rn(sx, x0), wy = __fsub_rn(sy, y0);
  const float ax = __fsub_rn(1.f, wx), ay = __fsub_rn(1.f, wy);
  const int xa = (int)x0, ya = (int)y0;
  const int xb = min(xa + 1, w - 1), yb = min(ya + 1, h - 1);
  const uint8_t* r0 = img + (size_t)ya * w * 3;
  const uint8_t* r1 = img + (size_t)yb * w * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v00 = __ldg(r0 + xa * 3 + c), v01 = __ldg(r0 + xb * 3 + c);
    const float v10 = __ldg(r1 + xa * 3 + c), v11 = __ldg(r1 + xb * 3 + c);
    float t = __fmul_rn(__fmul_rn(v00, ax), ay);
    t = __fadd_rn(t, __fmul_rn(__fmul_rn(v01, wx), ay));
    t = __fadd_rn(t, __fmul_rn(__fmul_rn(v10, ax), wy));
    t = __fadd_rn(t, __fmul_rn(__fmul_rn(v11, wx), wy));
    u[c] = fminf(fmaxf(rintf(t), 0.f), 255.f);
  }
}

__global__ void __launch_bounds__(kThreads)
image_chain_kernel(const uint8_t* __restrict__ src, const float* __restrict__ params,
                   float* __restrict__ out, int h, int w, int oh, int ow, int vec, Consts k) {
  __shared__ float sp[kParams];
  const int b = blockIdx.y;
  if (threadIdx.x < kParams) sp[threadIdx.x] = params[(size_t)b * kParams + threadIdx.x];
  __syncthreads();
  const int groups_per_row = (ow + kPix - 1) / kPix;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= (long long)oh * groups_per_row) return;
  const int y = (int)(g / groups_per_row);
  const int x0 = (int)(g - (long long)y * groups_per_row) * kPix;

  float m[6], hm[9];
#pragma unroll
  for (int i = 0; i < 6; ++i) m[i] = sp[i];
#pragma unroll
  for (int i = 0; i < 9; ++i) hm[i] = sp[15 + i];
  const bool bright = sp[6] != 0.f, pre = sp[7] != 0.f, sat = sp[8] != 0.f;
  const bool hue = sp[9] != 0.f, post = sp[10] != 0.f, swap = sp[11] != 0.f;
  const float delta = sp[12], alpha = sp[13], s = sp[14];
  const int p0 = (int)sp[24], p1 = (int)sp[25], p2 = (int)sp[26];

  const uint8_t* img = src + (size_t)b * h * w * 3;
  const float fy = (float)y;
  float res[kPix * 3];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    if (x0 + i >= ow) break;
    float x[3];
    warp_pixel(img, h, w, m, (float)(x0 + i), fy, x);
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = __fmul_rn(x[c], k.intensity);
    if (bright) {
#pragma unroll
      for (int c = 0; c < 3; ++c) x[c] = clamp01(__fadd_rn(x[c], delta));
    }
    if (pre) {
#pragma unroll
      for (int c = 0; c < 3; ++c) x[c] = clamp01(__fmul_rn(x[c], alpha));
    }
    if (sat) {
      const float gray = __fadd_rn(
          __fadd_rn(__fmul_rn(x[0], k.luma[0]), __fmul_rn(x[1], k.luma[1])),
          __fmul_rn(x[2], k.luma[2]));
#pragma unroll
      for (int c = 0; c < 3; ++c) x[c] = __fadd_rn(gray, __fmul_rn(s, __fsub_rn(x[c], gray)));
    }
    if (hue) {
      const float a0 = k.bgr ? x[2] : x[0], a1 = x[1], a2 = k.bgr ? x[0] : x[2];
      float yv[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        yv[c] = __fmaf_rn(a2, hm[c * 3 + 2],
                          __fmaf_rn(a1, hm[c * 3 + 1], __fmul_rn(a0, hm[c * 3])));
      x[0] = k.bgr ? yv[2] : yv[0];
      x[1] = yv[1];
      x[2] = k.bgr ? yv[0] : yv[2];
    }
    if (post) {
#pragma unroll
      for (int c = 0; c < 3; ++c) x[c] = clamp01(__fmul_rn(x[c], alpha));
    }
    if (swap) {
      const float q0 = pick(x, p0), q1 = pick(x, p1), q2 = pick(x, p2);
      x[0] = q0;
      x[1] = q1;
      x[2] = q2;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float byte = truncf(fminf(fmaxf(__fmul_rn(x[c], 255.f), 0.f), 255.f));
      res[i * 3 + c] = __fmul_rn(__fsub_rn(byte, k.mean[c]), k.inv_std[c]);
    }
  }

  float* o = out + (((size_t)b * oh + y) * ow + x0) * 3;
  if (vec && x0 + kPix <= ow) {
    float4* o4 = reinterpret_cast<float4*>(o);
    o4[0] = make_float4(res[0], res[1], res[2], res[3]);
    o4[1] = make_float4(res[4], res[5], res[6], res[7]);
    o4[2] = make_float4(res[8], res[9], res[10], res[11]);
  } else {
    for (int i = 0; i < kPix && x0 + i < ow; ++i) {
      o[i * 3] = res[i * 3];
      o[i * 3 + 1] = res[i * 3 + 1];
      o[i * 3 + 2] = res[i * 3 + 2];
    }
  }
}

}  // namespace

// src (b, h, w, 3) uint8, params (b, 27) float32, out (b, oh, ow, 3)
// float32, all contiguous on the current device; consts: 11 host floats
// [intensity, luma x3, bgr, mean x3, inv_std x3]; vec: out is 16-byte
// aligned. Returns cudaGetLastError() after the launch (0 when b, oh or ow
// is 0: nothing to launch).
extern "C" int accvlab_image_chain(const void* src, const void* params, void* out, int b, int h,
                                   int w, int oh, int ow, const float* consts, int vec,
                                   void* stream) {
  if (b == 0 || oh == 0 || ow == 0) return 0;
  Consts k;
  k.intensity = consts[0];
  for (int c = 0; c < 3; ++c) k.luma[c] = consts[1 + c];
  k.bgr = consts[4] != 0.f;
  for (int c = 0; c < 3; ++c) k.mean[c] = consts[5 + c];
  for (int c = 0; c < 3; ++c) k.inv_std[c] = consts[8 + c];
  const long long groups = (long long)oh * ((ow + kPix - 1) / kPix);
  const dim3 grid((unsigned)((groups + kThreads - 1) / kThreads), (unsigned)b);
  image_chain_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const float*)params, (float*)out, h, w, oh, ow,
      vec && (ow % kPix == 0), k);
  return (int)cudaGetLastError();
}
