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
// by ops/cuda_ncc.py::SampleWindowsFn for the polish (refine_grad_steps).
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
// What bounds it on the H100. Per window it must read 32 B of parameters
// and C * S floats of grad_out (588 B RGB, 196 B luma at 7 x 7) and write
// 24 B, besides the taps (the forward's, mostly L2 hits): 0.00476 ms for
// K1's 24,576 RGB windows and 0.05924 ms for K3u's 786,432 luma windows
// at the card's memory rate. It does not reach that bound: it is held by
// instruction issue and load latency. The first design (one warp a
// window, lane l on samples l, l + 32, six partial sums reduced by 5-step
// butterflies, lane 0 storing) took 0.0206 ms RGB and 0.333 ms luma, 23 %
// and 18 % of the bound, issuing 155 (RGB) and 96 (luma) instructions a
// sample (tools/sass_mix.py): each sample divided s by wsize, rebuilt its
// lattice point, turned every tap byte into a float by shift, mask and
// I2F and loaded its cotangent from global memory, and a 7 x 7 window's
// second pass ran 17 of 32 lanes. This design walks a sample in 104 (RGB)
// and 58 (luma) instructions and takes about 0.0157 and 0.164 ms, 30 %
// and 36 % of the bound (PERF.md §6). It takes K2's and K4's
// pieces:
//   * threads over lattice columns, as in K4: a window's columns lie on
//     P lanes, P the power of two at or above wsize (8 at 7 x 7: four
//     windows a warp on 28 lanes; 16 at 9 to 15, two a warp); a lane forms
//     its column's partial sum a = tl + d1 * i once and walks j with
//     x = a + d2 * j, rounded as the plain version (cuda_ncc.lattice) and
//     the forward round (tl + d1 * i) + d2 * j, no FMA contraction, no division. WS = 7
//     is compiled for its size, one pass of 7 samples; WS = 0 serves
//     every other size, in passes of MVS_GRAD_PASS samples (half that for
//     RGB), and a window wider than a warp loops over its columns;
//   * two windows a thread at 7 x 7 (MVS_GRAD_COLS), with every tap load
//     of both columns (14 luma words, 56 RGB) issued before any tap
//     arithmetic, in blocks of 128 threads: more loads in flight a
//     thread counted for more than resident warps. Against one window a
//     thread in blocks of 256 it measured 0.89x the time (luma) and 0.95x
//     (RGB), against blocks of 64 0.96x and 1.00x (PERF.md §6);
//   * exact conversions (sample_common.cuh): tap_origin for the origin,
//     with the tap word from the sums' bits, and one PRMT a tap byte into
//     the mantissa of 2^23 (byte_f32 without its subtraction): two such
//     floats differ by exactly the bytes' difference, so a tap difference
//     is one PRMT a byte and one subtraction;
//   * four sums a lane: sum_j gx, sum_j gy, sum_j j gx, sum_j j gy; the
//     lane multiplies its column index into grad_dx's terms once, after
//     the walk, then a window's P lanes reduce the six outputs in log2 P
//     fixed xor-shuffle steps (18 shuffles per 4 windows at 7 x 7, where
//     the first design took 120; grad_dx's i-weighted sums cannot share
//     a shuffle with grad_tl's, and the idle eighth lane adds zeros): no
//     atomics, so every launch sums in the same order;
//   * persistent blocks walking tiles of G windows (32 at 7 x 7), as K2
//     does: a tile's cotangent is one contiguous run of G * C * S floats
//     and its parameters five contiguous slices, which one thread brings
//     into shared memory with six TMA 1-D bulk copies on one mbarrier,
//     double-buffered against the tile being computed; where a tile is
//     ragged (the batch's last) or an array does not start on 16 bytes (a
//     grad_out view at an odd float offset), every thread copies it with
//     4-byte cp.async instead (copy_params's word path), decided per tile:
//     no launch is refused for its alignment and none falls back to the
//     plain version;
//   * a member table per tile: each window's plane base, level width and
//     last tap origins resolved once in shared memory (the 8-way level
//     select once per window, not per lane);
//   * coalesced stores: each lane of a window stores one of its six
//     outputs, so a warp writes grads[k, b0 : b0 + 4, :] of four
//     consecutive windows as three 32-byte runs, and a tile the three
//     runs grads[k, tile, :].
// Its float32 sums are taken in another order than the plain version's
// autograd, so the two agree to rounding (chip_smoke.py holds each
// output within 1e-5 of the sum of its terms' magnitudes), not bit for
// bit; the forward stays bit-equal to its plain version.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "sample_common.cuh"

#define MVS_GRAD_THREADS 128
#define MVS_GRAD_COLS 2  // WS = 7: windows a thread (one column of each); WS = 0: one
#define MVS_GRAD_PASS 8  // run-time size: luma samples of a column per pass (RGB half)

// jnp.clip(v, 0, 1)'s derivative: 1 inside, 0.5 on a bound, 0 outside
// and at NaN
__device__ __forceinline__ float clip01_slope(float v) {
  return (v > 0.0f && v < 1.0f) ? 1.0f : ((v == 0.0f || v == 1.0f) ? 0.5f : 0.0f);
}

// byte k of v plus 2^23 (bits 0x4B0000bb): byte_f32 without its
// subtraction. Both operands of a tap difference lie in [2^23, 2^24),
// where the ulp is 1, so their difference is the bytes' difference exactly.
__device__ __forceinline__ float byte_biased(int v, int k) {
  return __int_as_float(__byte_perm(v, 0x4B000000, 0x7440 + k));
}

// log2 of the lanes a window takes: the power of two at or above wsize,
// at most a warp
__host__ __device__ constexpr int grad_lanes_log2(int ws) {
  return ws <= 1 ? 0 : ws <= 2 ? 1 : ws <= 4 ? 2 : ws <= 8 ? 3 : ws <= 16 ? 4 : 5;
}

// windows a thread takes at a time
template <int WS>
__host__ __device__ constexpr int grad_cols() {
  return WS > 0 ? MVS_GRAD_COLS : 1;
}

// A tile's member table in shared memory: per window its plane base (in
// ints), its last tap origins (w - 2, h - 2) as floats and its level width
struct GradMembers {
  int64_t* base;  // [G]
  float2* lim;    // [G]
  int* w;         // [G]
};

// the member table of the tile's n windows from its raw parameters (laid
// out for G, as copy_params lays them); window m reads plane row
// idx[m] * ni + illum
__device__ __forceinline__ void resolve_grad(const int* raw, int G, const GradMembers& t,
                                             const LevelMeta& meta, int total, int ni,
                                             int illum, int n) {
  for (int m = threadIdx.x; m < n; m += blockDim.x) {
    int off, w, h;
    level_meta(meta, clamp_level(raw[G + m], meta.n), off, w, h);
    t.base[m] = (int64_t)(raw[m] * ni + illum) * total + off;
    t.lim[m] = make_float2((float)(w - 2), (float)(h - 2));
    t.w[m] = w;
  }
}

// One window's lattice column, as a lane walks it: the window's plane,
// level width, tap-word bias and last tap origins, its step d2 and its
// cotangent in shared memory (channel c, sample s at g[c * S + s]), and
// the column's partial sums (ax, ay)
struct GradCol {
  const int* pm;
  const float* g;
  float2 lim, d2;
  float ax, ay;
  unsigned bias;
  int w;
};

// Samples j0 .. j0 + R - 1 (those below ws) of column i of the NCOL
// windows `col` (those `on`) into each column's sums acc: sum_j gx,
// sum_j gy, sum_j j gx, sum_j j gy. Every tap load of the pass is issued
// before any tap arithmetic.
template <int C, int WS, int R, int NCOL>
__device__ __forceinline__ void grad_columns(const GradCol (&col)[NCOL], const bool (&on)[NCOL],
                                             int i, int j0, int ws, int S,
                                             float (&acc)[NCOL][4]) {
  int v[NCOL][R][4];         // RGB: taps 00, 10, 01, 11; luma: the quad in [0]
  float ex[NCOL][R], ey[NCOL][R];  // x - lx, y - ly
  const float fj0 = (float)j0;  // a constant 0 where WS > 0
#pragma unroll
  for (int q = 0; q < NCOL; ++q) {
    if (on[q]) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (WS > 0 || j0 + k < ws) {
          const float fj = WS > 0 ? (float)k : __fadd_rn(fj0, (float)k);
          const float x = __fadd_rn(col[q].ax, __fmul_rn(col[q].d2.x, fj));
          const float y = __fadd_rn(col[q].ay, __fmul_rn(col[q].d2.y, fj));
          unsigned bx, by;
          ex[q][k] = __fsub_rn(x, tap_origin(x, col[q].lim.x, bx));
          ey[q][k] = __fsub_rn(y, tap_origin(y, col[q].lim.y, by));
          const int w = col[q].w;
          const int* p = col[q].pm + (int)(by * (unsigned)w + bx - col[q].bias);
          v[q][k][0] = __ldg(p);
          if (C == 3) {
            v[q][k][1] = __ldg(p + 1);
            v[q][k][2] = __ldg(p + w);
            v[q][k][3] = __ldg(p + w + 1);
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NCOL; ++q) {
    if (on[q]) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (WS > 0 || j0 + k < ws) {
          const float fj = WS > 0 ? (float)k : __fadd_rn(fj0, (float)k);
          const float dx1 = clamp01(ex[q][k]), dy1 = clamp01(ey[q][k]);
          const float dx0 = __fsub_rn(1.0f, dx1), dy0 = __fsub_rn(1.0f, dy1);
          const float* g = col[q].g + (j0 + k) * ws + i;
          float gx = 0.0f, gy = 0.0f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            // RGB: byte c of each tap word; luma: bytes 0-3 of the quad
            const int* t = v[q][k];
            const float e00 = C == 3 ? byte_biased(t[0], c) : byte_biased(t[0], 0);
            const float e10 = C == 3 ? byte_biased(t[1], c) : byte_biased(t[0], 1);
            const float e01 = C == 3 ? byte_biased(t[2], c) : byte_biased(t[0], 2);
            const float e11 = C == 3 ? byte_biased(t[3], c) : byte_biased(t[0], 3);
            // the sample's derivative in dx1 and in dy1
            const float sx =
                __fmaf_rn(dy0, __fsub_rn(e10, e00), __fmul_rn(dy1, __fsub_rn(e11, e01)));
            const float sy =
                __fmaf_rn(dx0, __fsub_rn(e01, e00), __fmul_rn(dx1, __fsub_rn(e11, e10)));
            const float gc = g[c * S];
            gx = c == 0 ? __fmul_rn(gc, sx) : __fmaf_rn(gc, sx, gx);
            gy = c == 0 ? __fmul_rn(gc, sy) : __fmaf_rn(gc, sy, gy);
          }
          gx = __fmul_rn(gx, clip01_slope(ex[q][k]));
          gy = __fmul_rn(gy, clip01_slope(ey[q][k]));
          acc[q][0] = __fadd_rn(acc[q][0], gx);
          acc[q][1] = __fadd_rn(acc[q][1], gy);
          acc[q][2] = __fmaf_rn(fj, gx, acc[q][2]);  // j = 0 too: a NaN term stays NaN
          acc[q][3] = __fmaf_rn(fj, gy, acc[q][3]);
        }
      }
    }
  }
}

// One tile of n windows: the block's threads in groups of P = 2^lg
// lanes, each group taking NCOL windows (m, m + G / NCOL, ...); each lane
// walks its columns i = lane % P, i + P, ... (one at 7 x 7) of each, the
// window's lanes reduce its six outputs by xor shuffles, and lane i of
// the window stores outputs i, i + P, ... (grads is [3, B, 2]: grad_tl,
// grad_dx, grad_dy).
template <int C, int WS>
__device__ __forceinline__ void grad_tile(const int* __restrict__ planes, const int* raw, int G,
                                          const GradMembers& t, const float* cot, int n, int ws,
                                          int lg, float* __restrict__ grads, int64_t b0, int B) {
  constexpr int R = WS > 0 ? WS : (C == 3 ? MVS_GRAD_PASS / 2 : MVS_GRAD_PASS);
  constexpr int NCOL = grad_cols<WS>();
  const int P = 1 << lg;
  const int S = ws * ws;
  const int lane = threadIdx.x & 31;
  const int m0 = ((threadIdx.x >> 5) << (5 - lg)) + (lane >> lg);
  const int i0 = lane & (P - 1);
  const float* f = reinterpret_cast<const float*>(raw);
  float acc[NCOL][6];  // per window: tl, dx, dy; x then y
  float2 tl[NCOL], d1[NCOL];
  GradCol col[NCOL];
  bool on[NCOL];
#pragma unroll
  for (int q = 0; q < NCOL; ++q) {
    const int m = m0 + q * (G / NCOL);
#pragma unroll
    for (int k = 0; k < 6; ++k) acc[q][k] = 0.0f;
    on[q] = m < n;
    if (on[q]) {
      tl[q] = reinterpret_cast<const float2*>(f + 2 * G)[m];
      d1[q] = reinterpret_cast<const float2*>(f + 4 * G)[m];
      col[q].d2 = reinterpret_cast<const float2*>(f + 6 * G)[m];
      col[q].pm = planes + t.base[m];
      col[q].w = t.w[m];
      col[q].bias = 0x4B400000u * (unsigned)(col[q].w + 1);
      col[q].lim = t.lim[m];
      col[q].g = cot + m * C * S;
    }
  }
  for (int i = i0; i < ws; i += P) {
    const float fi = (float)i;
    float cs[NCOL][4];
#pragma unroll
    for (int q = 0; q < NCOL; ++q) {
      cs[q][0] = cs[q][1] = cs[q][2] = cs[q][3] = 0.0f;
      col[q].ax = __fadd_rn(tl[q].x, __fmul_rn(d1[q].x, fi));
      col[q].ay = __fadd_rn(tl[q].y, __fmul_rn(d1[q].y, fi));
    }
    for (int j0 = 0; j0 < ws; j0 += R)  // one pass where WS > 0
      grad_columns<C, WS, R, NCOL>(col, on, i, j0, ws, S, cs);
#pragma unroll
    for (int q = 0; q < NCOL; ++q) {
      acc[q][0] = __fadd_rn(acc[q][0], cs[q][0]);
      acc[q][1] = __fadd_rn(acc[q][1], cs[q][1]);
      acc[q][2] = __fmaf_rn(fi, cs[q][0], acc[q][2]);  // i = 0 too: a NaN term stays NaN
      acc[q][3] = __fmaf_rn(fi, cs[q][1], acc[q][3]);
      acc[q][4] = __fadd_rn(acc[q][4], cs[q][2]);
      acc[q][5] = __fadd_rn(acc[q][5], cs[q][3]);
    }
  }
  for (int o = P >> 1; o > 0; o >>= 1) {  // every lane, idle ones adding zeros
#pragma unroll
    for (int q = 0; q < NCOL; ++q) {
#pragma unroll
      for (int k = 0; k < 6; ++k)
        acc[q][k] = __fadd_rn(acc[q][k], __shfl_xor_sync(0xffffffffu, acc[q][k], o));
    }
  }
#pragma unroll
  for (int q = 0; q < NCOL; ++q) {
    if (on[q]) {
      const int64_t b = b0 + m0 + q * (G / NCOL);
      for (int o = i0; o < 6; o += P) {
        float r = acc[q][0];
#pragma unroll
        for (int k = 1; k < 6; ++k) r = o == k ? acc[q][k] : r;  // no dynamic register index
        grads[(int64_t)(o >> 1) * 2 * B + 2 * b + (o & 1)] = r;
      }
    }
  }
}

// Start bringing tile `tile`'s parameters (into `rdst`, laid out for G)
// and cotangent (into `cdst`) into shared memory: six TMA bulk copies on
// `bar` issued by thread 0 where the tile is whole and every array
// 16-byte aligned (`bulk`), else 4-byte cp.async by every thread, word
// by word of the tile's n windows (nothing past the batch is read).
__device__ __forceinline__ void stage_tile(int tile, int G, int B, int run, bool bulk,
                                           float* cdst, int* rdst, uint64_t* bar,
                                           const int* __restrict__ idx,
                                           const int* __restrict__ lvl,
                                           const float* __restrict__ tl,
                                           const float* __restrict__ dx,
                                           const float* __restrict__ dy,
                                           const float* __restrict__ grad_out) {
  const int64_t b0 = (int64_t)tile * G;
  const int n = tile_members(tile, G, B);
  const float* src = grad_out + b0 * run;
  if (bulk && n == G) {  // G % 4 == 0: every slice a multiple of 16 bytes
    if (threadIdx.x == 0) {
      const int cb = G * run * (int)sizeof(float);
      mbar_expect_tx(bar, 32 * G + cb);
      bulk_load(rdst, idx + b0, 4 * G, bar);
      bulk_load(rdst + G, lvl + b0, 4 * G, bar);
      bulk_load(rdst + 2 * G, tl + 2 * b0, 8 * G, bar);
      bulk_load(rdst + 4 * G, dx + 2 * b0, 8 * G, bar);
      bulk_load(rdst + 6 * G, dy + 2 * b0, 8 * G, bar);
      bulk_load(cdst, src, cb, bar);
    }
  } else {
    copy_params(rdst, G, b0, n, false, idx, lvl, tl, dx, dy);
    const int nf = n * run;
    for (int k = threadIdx.x; k < nf; k += blockDim.x) cp_async4(cdst + k, src + k);
    cp_async_commit();
  }
}

// wait for a tile started by stage_tile (all threads), then a barrier
__device__ __forceinline__ void land_tile(bool bulk_tile, uint64_t* bar, uint32_t& phase) {
  cp_async_wait_all();
  if (bulk_tile) {
    mbar_wait(bar, phase);
    phase ^= 1;
  }
  __syncthreads();
}

// The backward: persistent blocks, each walking the tiles of G windows
// with stride gridDim.x. Dynamic shared memory (grad_smem): two
// cotangent buffers of cot_floats floats, the mbarrier (16 B), two raw
// parameter buffers (8 * G words each), then the member table. Per tile:
// the next tile is staged into the other buffers while this one is
// computed; the member table is rewritten for the next tile only after
// the barrier that ends this tile's work.
template <int C, int WS>
__global__ void __launch_bounds__(MVS_GRAD_THREADS)
window_grad_kernel(const int* __restrict__ planes, LevelMeta meta, int total, int ni,
                   int illum, const int* __restrict__ idx, const int* __restrict__ lvl,
                   const float* __restrict__ tl, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ grad_out,
                   float* __restrict__ grads, int B, int wsize, int G, int cot_floats,
                   int bulk) {
  const int ws = WS > 0 ? WS : wsize;
  const int lg = grad_lanes_log2(ws);  // a constant where WS > 0
  const int run = C * ws * ws;         // cotangent floats a window
  const int ntiles = (B - 1) / G + 1;
  extern __shared__ float4 smem4[];
  float* cot = reinterpret_cast<float*>(smem4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(cot + 2 * cot_floats);
  int* raw = reinterpret_cast<int*>(bar + 2);
  GradMembers t;
  t.base = reinterpret_cast<int64_t*>(raw + 16 * G);
  t.lim = reinterpret_cast<float2*>(t.base + G);
  t.w = reinterpret_cast<int*>(t.lim + G);

  if (threadIdx.x == 0) mbar_init(bar, 1);
  __syncthreads();
  uint32_t phase = 0;
  int g = blockIdx.x;
  stage_tile(g, G, B, run, bulk, cot, raw, bar, idx, lvl, tl, dx, dy, grad_out);
  land_tile(bulk && tile_members(g, G, B) == G, bar, phase);
  resolve_grad(raw, G, t, meta, total, ni, illum, tile_members(g, G, B));
  for (int it = 0; g < ntiles; g += gridDim.x, ++it) {
    const int cur = it & 1;
    const int next = g + gridDim.x;
    if (next < ntiles)
      stage_tile(next, G, B, run, bulk, cot + (cur ^ 1) * cot_floats, raw + (cur ^ 1) * 8 * G,
                 bar, idx, lvl, tl, dx, dy, grad_out);
    __syncthreads();  // members resolved
    grad_tile<C, WS>(planes, raw + cur * 8 * G, G, t, cot + cur * cot_floats,
                     tile_members(g, G, B), ws, lg, grads, (int64_t)g * G, B);
    if (next < ntiles) {
      const int n_next = tile_members(next, G, B);
      land_tile(bulk && n_next == G, bar, phase);  // also: this tile's work done
      resolve_grad(raw + (cur ^ 1) * 8 * G, G, t, meta, total, ni, illum, n_next);
    }
  }
}

struct GradPlan {
  int tile, grid, threads, lanes, smem, cot_floats, bulk, blocks_per_sm, sms;
};

// dynamic shared memory of tiles of G windows: two cotangent buffers of
// (G * C * wsize^2 rounded up to 4) floats, the mbarrier (16 B), two raw
// parameter buffers (32 B a window each) and the member table (20 B a
// window)
static int64_t grad_smem(int C, int G, int wsize, int* cot_floats) {
  const int64_t floats = ((int64_t)G * C * wsize * wsize + 3) & ~(int64_t)3;
  *cot_floats = floats > INT_MAX ? INT_MAX : (int)floats;
  return 2 * floats * (int64_t)sizeof(float) + 16 + 84 * (int64_t)G;
}

// The launch of window_grad_kernel<C, WS> for B windows of wsize: a tile
// is grad_cols<WS>() windows per P lanes of the block (P =
// 2^grad_lanes_log2(wsize): 32 windows at 7 x 7), MVS_GRAD_THREADS threads, or fewer (a warp less at a time) where the
// card's shared memory cannot hold two tiles' cotangents (never at the
// sizes the wrapper takes, 1 to 15; a size whose one-warp tile does not
// fit returns cudaErrorInvalidValue); bulk copies where the tile is a
// multiple of 4 windows and every array 16-byte aligned (`aligned`); the
// persistent grid min(tiles, SMs x resident blocks per SM).
template <int C, int WS>
static int plan_grad(int B, int wsize, bool aligned, GradPlan* p) {
  if (B < 1 || wsize < 1) return (int)cudaErrorInvalidValue;
  DeviceInfo d;
  int err = device_info(&d);
  if (err) return err;
  const int lg = grad_lanes_log2(wsize);
  for (p->threads = MVS_GRAD_THREADS;; p->threads -= 32) {
    p->tile = grad_cols<WS>() * ((p->threads / 32) << (5 - lg));
    const int64_t smem = grad_smem(C, p->tile, wsize, &p->cot_floats);
    if (smem <= d.optin) {
      p->smem = (int)smem;
      break;
    }
    if (p->threads == 32) return (int)cudaErrorInvalidValue;
  }
  p->lanes = 1 << lg;
  p->bulk = aligned && p->tile % 4 == 0;
  p->sms = d.sms;
  const void* fn = (const void*)window_grad_kernel<C, WS>;
  err = opt_in_smem(fn, d);
  if (err) return err;
  err = resident_blocks(fn, d.dev, p->threads, p->smem, &p->blocks_per_sm);
  if (err) return err;
  p->grid = (int)std::min(((int64_t)B + p->tile - 1) / p->tile,
                          (int64_t)d.sms * p->blocks_per_sm);
  return 0;
}

template <int C, int WS>
static int launch_grad_ws(const int* planes, const LevelMeta& meta, int total, int ni,
                          int illum, const int* idx, const int* lvl, const float* tl,
                          const float* dx, const float* dy, const float* grad_out,
                          float* grads, int B, int wsize, cudaStream_t stream) {
  GradPlan p;
  const bool aligned = aligned16(idx) && aligned16(lvl) && aligned16(tl) && aligned16(dx) &&
                       aligned16(dy) && aligned16(grad_out);
  const int err = plan_grad<C, WS>(B, wsize, aligned, &p);
  if (err) return err;
  window_grad_kernel<C, WS><<<p.grid, p.threads, p.smem, stream>>>(
      planes, meta, total, ni, illum, idx, lvl, tl, dx, dy, grad_out, grads, B, wsize, p.tile,
      p.cot_floats, p.bulk);
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

// The backward's plan for B windows of wsize (luma: C = 1, else 3) on
// the current device, with the wrapper's 16-byte aligned arrays: writes
// tile, grid, threads, lanes a window, dynamic shared memory bytes,
// cotangent floats a buffer, bulk copies (0/1), resident blocks per SM
// and SM count into plan[0..8]. Returns the error the launch would
// return, else 0.
extern "C" int mvs_sample_windows_grad_plan(int luma, int B, int wsize, int* plan) {
  GradPlan p;
  const bool ws7 = wsize == 7;
  const int err = luma ? (ws7 ? plan_grad<1, 7>(B, wsize, true, &p)
                              : plan_grad<1, 0>(B, wsize, true, &p))
                       : (ws7 ? plan_grad<3, 7>(B, wsize, true, &p)
                              : plan_grad<3, 0>(B, wsize, true, &p));
  if (err) return err;
  const int v[9] = {p.tile, p.grid, p.threads, p.lanes, p.smem, p.cot_floats, p.bulk,
                    p.blocks_per_sm, p.sms};
  for (int k = 0; k < 9; ++k) plan[k] = v[k];
  return 0;
}
