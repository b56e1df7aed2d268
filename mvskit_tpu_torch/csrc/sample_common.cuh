// Shared by the window sampler (sample_windows.cu) and its backward
// (sample_windows_grad.cu): the level table of a launch, the lattice and
// the gather path's tap origin and fractions, each with the exact
// rounding of the plain PyTorch versions (ops/sampling.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MVS_MAX_LEVELS 8

struct LevelMeta {
  int off[MVS_MAX_LEVELS];
  int w[MVS_MAX_LEVELS];
  int h[MVS_MAX_LEVELS];
  int n;
};

__device__ __forceinline__ int clamp_level(int l, int n) {
  return l < 0 ? 0 : (l >= n ? n - 1 : l);
}

// level l's offset and size, read with constant indices only (a dynamic
// index into the parameter struct would copy it to local memory)
__device__ __forceinline__ void level_meta(const LevelMeta& m, int l, int& off,
                                           int& w, int& h) {
  off = 0; w = 2; h = 2;
#pragma unroll
  for (int k = 0; k < MVS_MAX_LEVELS; ++k) {
    if (k == l) { off = m.off[k]; w = m.w[k]; h = m.h[k]; }
  }
}

// lattice coordinate tl + d1 * i + d2 * j, evaluated as (tl + d1*i) + d2*j
__device__ __forceinline__ float lattice(float t, float d1, float d2,
                                         float i, float j) {
  return __fadd_rn(__fadd_rn(t, __fmul_rn(d1, i)), __fmul_rn(d2, j));
}

struct Frac {
  int lx, ly;
  float dx0, dx1, dy0, dy1;
};

// clamp to [0, 1] that propagates NaN, as torch.clamp and jnp.clip do
__device__ __forceinline__ float clamp01(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// the gather path's tap origin and fractions
__device__ __forceinline__ Frac bilinear_frac(float x, float y, int w, int h) {
  Frac f;
  int lx = __float2int_rz(x);  // saturating, NaN -> 0
  int ly = __float2int_rz(y);
  lx = min(max(lx, 0), w - 2);
  ly = min(max(ly, 0), h - 2);
  f.lx = lx;
  f.ly = ly;
  f.dx1 = clamp01(__fsub_rn(x, (float)lx));
  f.dy1 = clamp01(__fsub_rn(y, (float)ly));
  f.dx0 = __fsub_rn(1.0f, f.dx1);
  f.dy0 = __fsub_rn(1.0f, f.dy1);
  return f;
}

__device__ __forceinline__ float byte_at(int v, int k) {
  return (float)((v >> (8 * k)) & 0xFF);
}

// the launch's level table from the host's arrays of n_levels ints
static int make_meta(LevelMeta* meta, const int* off, const int* w,
                     const int* h, int n_levels) {
  if (n_levels < 1 || n_levels > MVS_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < MVS_MAX_LEVELS; ++l) {
    meta->off[l] = l < n_levels ? off[l] : 0;
    meta->w[l] = l < n_levels ? w[l] : 0;
    meta->h[l] = l < n_levels ? h[l] : 0;
  }
  meta->n = n_levels;
  return 0;
}
