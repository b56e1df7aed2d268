// Backward of the NCC window sampler for Hopper (sm_90a): the
// vector-Jacobian product of the raw bilinear samples of each window's
// wsize x wsize lattice with respect to the lattice's origin and steps.
//
// Replaces: no TPU kernel. The JAX package's gradient polish
// (mvskit_tpu/pipeline/refine.py:277-300) takes this product by XLA's
// autodiff of its gather path (sampling.sample_color_ch_packed /
// sample_luma_quad through ops/ncc.py:406-424), since its Pallas kernel
// (ops/pallas_ncc.py::_make_kernel) has no VJP. The port's forward is
// the window kernel (sample_windows.cu); this is its backward, launched
// by ops/cuda_ncc.py::SampleWindowsFn.
//
// What it computes, for window b and sample s = j * wsize + i at
// x = (tl.x + dx.x * i) + dy.x * j (same for y), with the forward's tap
// origin and fractions (bilinear_frac: truncation, saturation, clamps):
//   dv_c/dx = [dy0 * (I10 - I00) + dy1 * (I11 - I01)] * clip'(x - lx)
//   dv_c/dy = [dx0 * (I01 - I00) + dx1 * (I11 - I10)] * clip'(y - ly)
//   g = sum over the channels c of grad_out[b, c * S + s] * dv_c,
// where clip' is jnp.clip's derivative (1 inside (0, 1), 0.5 on either
// bound, 0 outside and at NaN), taken as a product so that a NaN stays
// NaN, as JAX's autodiff and the plain version (ops/sampling.clip01)
// have it; then
//   grad_tl[b] = sum_s g,  grad_dx[b] = sum_s i * g,  grad_dy[b] = sum_s j * g.
// Luma reads the quad-packed planes: one word holds I00, I10, I01, I11.
//
// What bounds it on the H100: bytes. Per window it reads 32 B of
// parameters and C * S floats of grad_out (588 B RGB, 196 B luma at
// 7 x 7) and writes 24 B; the taps are the forward's, mostly L2 hits. It
// does about 66 float32 operations a sample (RGB; 38 luma), far below
// the 67 TFLOP/s at which they would bound it. The design is the simple
// one that is right:
//   * one warp per window, eight windows a block of 256 threads; lane l
//     takes samples l, l + 32, ...: its grad_out reads are coalesced
//     across the warp, and its taps are those of neighbouring samples;
//   * each lane keeps six partial sums (tl, dx, dy; x and y) and the warp
//     reduces them with a fixed butterfly of shuffles: no atomics, so
//     every launch sums in the same order and gives the same bits;
//   * WS = 7 is compiled for its size (divisions by constants); every
//     other size runs WS = 0 with wsize read at run time.
// Its float32 sums are taken in another order than the plain version's
// autograd, so the two agree to rounding (chip_smoke.py holds each
// output within 1e-5 of the sum of its terms' magnitudes), not bit for
// bit; the forward stays bit-equal to its plain version.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sample_common.cuh"

#define MVS_GRAD_THREADS 256
#define MVS_GRAD_WARPS (MVS_GRAD_THREADS / 32)

// jnp.clip(v, 0, 1)'s derivative: 1 inside, 0.5 on a bound, 0 outside
// and at NaN
__device__ __forceinline__ float clip01_slope(float v) {
  return (v > 0.0f && v < 1.0f) ? 1.0f : ((v == 0.0f || v == 1.0f) ? 0.5f : 0.0f);
}

// the derivative of one channel's bilinear sample along x (along y with
// the roles of the taps and fractions swapped)
__device__ __forceinline__ float bilinear_slope(float i00, float i10, float i01, float i11,
                                                float f0, float f1) {
  return __fadd_rn(__fmul_rn(f0, __fsub_rn(i10, i00)), __fmul_rn(f1, __fsub_rn(i11, i01)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int C, int WS>
__global__ void __launch_bounds__(MVS_GRAD_THREADS)
window_grad_kernel(const int* __restrict__ planes, LevelMeta meta, int total, int ni,
                   int illum, const int* __restrict__ idx, const int* __restrict__ lvl,
                   const float* __restrict__ tl, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ grad_out,
                   float* __restrict__ grads, int B, int wsize) {
  const int ws = WS > 0 ? WS : wsize;
  const int S = ws * ws;
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * MVS_GRAD_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp: b is the same on its lanes
  int off, w, h;
  level_meta(meta, clamp_level(lvl[b], meta.n), off, w, h);
  const int* base = planes + (int64_t)(idx[b] * ni + illum) * total + off;
  const float tx = tl[2 * b], ty = tl[2 * b + 1];
  const float d1x = dx[2 * b], d1y = dx[2 * b + 1];
  const float d2x = dy[2 * b], d2y = dy[2 * b + 1];
  const float* go = grad_out + b * (int64_t)(C * S);
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // tl, dx, dy; x then y
  for (int s = lane; s < S; s += 32) {
    const int j = s / ws;
    const float fi = (float)(s - j * ws), fj = (float)j;
    const float x = lattice(tx, d1x, d2x, fi, fj);
    const float y = lattice(ty, d1y, d2y, fi, fj);
    const Frac f = bilinear_frac(x, y, w, h);
    const float sx = clip01_slope(__fsub_rn(x, (float)f.lx));
    const float sy = clip01_slope(__fsub_rn(y, (float)f.ly));
    const int* r = base + f.ly * w + f.lx;
    float gx = 0.0f, gy = 0.0f;
    if (C == 3) {
      const int v00 = __ldg(r), v10 = __ldg(r + 1), v01 = __ldg(r + w), v11 = __ldg(r + w + 1);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float i00 = byte_at(v00, c), i10 = byte_at(v10, c);
        const float i01 = byte_at(v01, c), i11 = byte_at(v11, c);
        const float g = __ldg(go + c * S + s);
        gx = __fadd_rn(gx, __fmul_rn(g, bilinear_slope(i00, i10, i01, i11, f.dy0, f.dy1)));
        gy = __fadd_rn(gy, __fmul_rn(g, bilinear_slope(i00, i01, i10, i11, f.dx0, f.dx1)));
      }
    } else {
      const int v = __ldg(r);
      const float i00 = byte_at(v, 0), i10 = byte_at(v, 1);
      const float i01 = byte_at(v, 2), i11 = byte_at(v, 3);
      const float g = __ldg(go + s);
      gx = __fmul_rn(g, bilinear_slope(i00, i10, i01, i11, f.dy0, f.dy1));
      gy = __fmul_rn(g, bilinear_slope(i00, i01, i10, i11, f.dx0, f.dx1));
    }
    gx = __fmul_rn(gx, sx);
    gy = __fmul_rn(gy, sy);
    acc[0] = __fadd_rn(acc[0], gx);
    acc[1] = __fadd_rn(acc[1], gy);
    acc[2] = __fadd_rn(acc[2], __fmul_rn(fi, gx));
    acc[3] = __fadd_rn(acc[3], __fmul_rn(fi, gy));
    acc[4] = __fadd_rn(acc[4], __fmul_rn(fj, gx));
    acc[5] = __fadd_rn(acc[5], __fmul_rn(fj, gy));
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) acc[k] = warp_sum(acc[k]);
  if (lane == 0) {
    // grads is [3, B, 2]: grad_tl, grad_dx, grad_dy
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      grads[(int64_t)k * 2 * B + 2 * b] = acc[2 * k];
      grads[(int64_t)k * 2 * B + 2 * b + 1] = acc[2 * k + 1];
    }
  }
}

template <int C, int WS>
static int launch_grad_ws(const int* planes, const LevelMeta& meta, int total, int ni,
                          int illum, const int* idx, const int* lvl, const float* tl,
                          const float* dx, const float* dy, const float* grad_out,
                          float* grads, int B, int wsize, cudaStream_t stream) {
  const int blocks = (int)(((int64_t)B + MVS_GRAD_WARPS - 1) / MVS_GRAD_WARPS);
  window_grad_kernel<C, WS><<<blocks, MVS_GRAD_THREADS, 0, stream>>>(
      planes, meta, total, ni, illum, idx, lvl, tl, dx, dy, grad_out, grads, B, wsize);
  return (int)cudaGetLastError();
}

// Checks the batch and launches the backward of C channels (3: packed
// RGB planes, 1: luma quads). Pointers are device pointers except the
// three level-metadata arrays (host arrays of n_levels ints); grads is
// [3, B, 2] (grad_tl, grad_dx, grad_dy). Returns cudaGetLastError()
// after the launch (0 for an empty batch).
template <int C>
static int launch_grad(const void* planes, int total, const int* lvl_off, const int* lvl_w,
                       const int* lvl_h, int n_levels, int ni, int illum, const void* idx,
                       const void* lvl, const void* tl, const void* dx, const void* dy,
                       const void* grad_out, void* grads, int B, int wsize, void* stream) {
  LevelMeta meta;
  const int err = make_meta(&meta, lvl_off, lvl_w, lvl_h, n_levels);
  if (err) return err;
  if (B <= 0) return 0;
  if (wsize < 1 || (int64_t)B * C * wsize * wsize > INT_MAX)
    return (int)cudaErrorInvalidValue;
  auto fn = wsize == 7 ? launch_grad_ws<C, 7> : launch_grad_ws<C, 0>;
  return fn((const int*)planes, meta, total, ni, illum, (const int*)idx, (const int*)lvl,
            (const float*)tl, (const float*)dx, (const float*)dy, (const float*)grad_out,
            (float*)grads, B, wsize, (cudaStream_t)stream);
}

#define MVS_GRAD_PARAMS                                                        \
  const void *planes, int total, const int *lvl_off, const int *lvl_w,         \
      const int *lvl_h, int n_levels, int ni, int illum, const void *idx,      \
      const void *lvl, const void *tl, const void *dx, const void *dy,         \
      const void *grad_out, void *grads, int B, int wsize, void *stream
#define MVS_GRAD_ARGS                                                          \
  planes, total, lvl_off, lvl_w, lvl_h, n_levels, ni, illum, idx, lvl, tl, dx, \
      dy, grad_out, grads, B, wsize, stream

// RGB backward: planes is the packed-RGB [n * ni, total] buffer, grad_out
// [B, 3 * wsize^2].
extern "C" int mvs_sample_windows_grad(MVS_GRAD_PARAMS) {
  return launch_grad<3>(MVS_GRAD_ARGS);
}

// Luma backward: planes is the luma-quad buffer, grad_out [B, wsize^2].
extern "C" int mvs_sample_windows_luma_grad(MVS_GRAD_PARAMS) {
  return launch_grad<1>(MVS_GRAD_ARGS);
}
