// NCC window sampler for Hopper (sm_90a): raw bilinear RGB (or luma)
// samples of a wsize x wsize lattice per window, on the window's own
// pyramid level.
//
// Replaces: mvskit_tpu/ops/pallas_ncc.py::_make_kernel, launched by
// sample_windows (rgb=True; group=1 and group=refine_cands). The TPU
// kernel DMAs a bounding tile per window (or per candidate group) into
// VMEM and gathers with one-hot MXU matmuls, because random gathers are
// slow on the TPU. Hopper gathers well, so this kernel reads every tap
// exactly and has no tile a window can overflow: no `fit` failure, and
// no grouped member loses its view.
//
// What it computes, for window b and sample s = j * wsize + i:
//   x = tl.x + dx.x * i + dy.x * j         (same for y)
//   lx = clamp(trunc(x), 0, w - 2), fx = clamp(x - lx, 0, 1)  (same for y)
//   out[b, c * S + s] = sum over the 4 taps of channel c * weight,
// with exactly the arithmetic of the gather path
// (mvskit_tpu_torch/ops/sampling.py::sample_color_ch_packed): every
// multiply and add is rounded on its own (__fmul_rn / __fadd_rn, no FMA
// contraction) and the taps accumulate in the order f00, f10, f01, f11,
// so the kernel equals its plain PyTorch version bit for bit.
//
// What bounds it on the H100: four dependent 4-byte loads per sample
// from L2 or HBM (latency, not bandwidth). The planes of one scene
// (16 views x 640x480 x 4 levels, packed RGB, about 26 MB) fit in the
// 50 MB L2. Design answers:
//   * ungrouped: one thread per (window, sample); neighbouring threads
//     sample neighbouring lattice points of one window, so their taps
//     share cache lines, and the three channel stores are coalesced.
//   * grouped: one block per group of `group` consecutive windows (the
//     jittered refinement candidates of one (patch, view)). The block
//     loads the bounding box of the members that share member 0's image
//     and level into shared memory once (a plain cooperative load, at
//     most 44 KB), then every (member, sample) reads its taps there.
//     Members on another level, or taps outside the box, read global
//     memory. Both forms run the same sample routine on the same values,
//     so grouped output equals ungrouped output bit for bit.
//
// Luma form (K3): replaces the same kernel with rgb=False
// (mvskit_tpu/ops/pallas_ncc.py:190, f32 luma planes, group=1 and
// group=refine_cands). It reads the quad-packed luma planes
// (Scene.planes_luma_quad: y00 | y10<<8 | y01<<16 | y11<<24 per pixel),
// so one 4-byte load carries all four taps of a sample, and writes
// out[b, s] = y00*dx0*dy0 + y10*dx1*dy0 + y01*dx0*dy1 + y11*dx1*dy1,
// evaluated left to right with every operation rounded alone, as its
// plain version (ops/sampling.py::sample_luma_quad) does. Bound on the
// H100: the stores, 49 * 4 = 196 B out per window against 32 B of
// window parameters in and one 4-byte tap load per sample (mostly L2
// hits), so it is store-bound. Design answers:
//   * ungrouped: one thread per (window, sample), as the RGB form;
//   * grouped: one block per candidate group. A shared-memory box buys
//     nothing here (one load per sample already, from L2; the RGB box
//     lost to plain L2 reads), so the block instead stages the group's
//     window parameters and level metadata in shared memory once and
//     then writes the group's group * S outputs as one contiguous,
//     coalesced run. Same sample routine, so it equals the ungrouped
//     launch bit for bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define MVS_MAX_LEVELS 8
#define MVS_MAX_GROUP 128
#define MVS_TILE_PIX 11264  // 44 KB of int32 pixels (+ 2 KB of box
                            // bookkeeping: under the 48 KB static limit)
#define MVS_THREADS 256

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

struct Taps {
  int lx, ly;
  float f00, f10, f01, f11;
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

// the gather path's tap origin and weights
__device__ __forceinline__ Taps bilinear_taps(float x, float y, int w, int h) {
  const Frac f = bilinear_frac(x, y, w, h);
  Taps t;
  t.lx = f.lx;
  t.ly = f.ly;
  t.f00 = __fmul_rn(f.dx0, f.dy0);
  t.f10 = __fmul_rn(f.dx1, f.dy0);
  t.f01 = __fmul_rn(f.dx0, f.dy1);
  t.f11 = __fmul_rn(f.dx1, f.dy1);
  return t;
}

__device__ __forceinline__ void accumulate(int v, float wgt, float& r,
                                           float& g, float& b) {
  r = __fadd_rn(r, __fmul_rn((float)(v & 0xFF), wgt));
  g = __fadd_rn(g, __fmul_rn((float)((v >> 8) & 0xFF), wgt));
  b = __fadd_rn(b, __fmul_rn((float)((v >> 16) & 0xFF), wgt));
}

// the shared sample routine: v00, v10, v01, v11 are the packed taps
__device__ __forceinline__ void store_sample(float* __restrict__ out, int b,
                                             int s, int S, const Taps& t,
                                             int v00, int v10, int v01,
                                             int v11) {
  float r = 0.0f, g = 0.0f, bl = 0.0f;
  accumulate(v00, t.f00, r, g, bl);
  accumulate(v10, t.f10, r, g, bl);
  accumulate(v01, t.f01, r, g, bl);
  accumulate(v11, t.f11, r, g, bl);
  float* row = out + (int64_t)b * 3 * S;
  row[s] = r;
  row[S + s] = g;
  row[2 * S + s] = bl;
}

__global__ void __launch_bounds__(MVS_THREADS)
sample_windows_ungrouped_kernel(const int* __restrict__ planes, LevelMeta meta,
                                int total, const int* __restrict__ img,
                                const int* __restrict__ lvl,
                                const float* __restrict__ tl,
                                const float* __restrict__ dx,
                                const float* __restrict__ dy,
                                float* __restrict__ out, int B, int wsize) {
  const int S = wsize * wsize;
  int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (int64_t)B * S) return;
  const int b = (int)(gid / S);
  const int s = (int)(gid - (int64_t)b * S);
  const float fi = (float)(s % wsize);
  const float fj = (float)(s / wsize);
  const int l = clamp_level(lvl[b], meta.n);
  int off, w, h;
  level_meta(meta, l, off, w, h);
  const float x = lattice(tl[2 * b], dx[2 * b], dy[2 * b], fi, fj);
  const float y = lattice(tl[2 * b + 1], dx[2 * b + 1], dy[2 * b + 1], fi, fj);
  const Taps t = bilinear_taps(x, y, w, h);
  const int* base = planes + (int64_t)img[b] * total + off;
  const int i00 = t.ly * w + t.lx;
  store_sample(out, b, s, S, t, __ldg(base + i00), __ldg(base + i00 + 1),
               __ldg(base + i00 + w), __ldg(base + i00 + w + 1));
}

__global__ void __launch_bounds__(MVS_THREADS)
sample_windows_grouped_kernel(const int* __restrict__ planes, LevelMeta meta,
                              int total, const int* __restrict__ img,
                              const int* __restrict__ lvl,
                              const float* __restrict__ tl,
                              const float* __restrict__ dx,
                              const float* __restrict__ dy,
                              float* __restrict__ out, int wsize, int group) {
  __shared__ int tile[MVS_TILE_PIX];
  __shared__ int s_box[4][MVS_MAX_GROUP];
  __shared__ int box[5];  // x0, y0, x1, y1 (inclusive), use

  const int S = wsize * wsize;
  const int b0 = blockIdx.x * group;
  const int img0 = img[b0];
  const int l0 = clamp_level(lvl[b0], meta.n);
  int off0, w0, h0;
  level_meta(meta, l0, off0, w0, h0);
  const int* base0 = planes + (int64_t)img0 * total + off0;

  // 1. per-member bounding box of its lattice corners (+1 px for the
  //    second tap), for members on member 0's image and level
  if (threadIdx.x < group) {
    const int b = b0 + threadIdx.x;
    int mnx = INT_MAX, mny = INT_MAX, mxx = INT_MIN, mxy = INT_MIN;
    if (img[b] == img0 && clamp_level(lvl[b], meta.n) == l0) {
      const float m = (float)(wsize - 1);
      float lo_x = INFINITY, hi_x = -INFINITY, lo_y = INFINITY, hi_y = -INFINITY;
      for (int c = 0; c < 4; ++c) {
        const float fi = (c & 1) ? m : 0.0f;
        const float fj = (c & 2) ? m : 0.0f;
        const float x = lattice(tl[2 * b], dx[2 * b], dy[2 * b], fi, fj);
        const float y = lattice(tl[2 * b + 1], dx[2 * b + 1], dy[2 * b + 1], fi, fj);
        lo_x = fminf(lo_x, x); hi_x = fmaxf(hi_x, x);
        lo_y = fminf(lo_y, y); hi_y = fmaxf(hi_y, y);
      }
      mnx = __float2int_rd(lo_x);
      mny = __float2int_rd(lo_y);
      mxx = __float2int_rd(hi_x);
      mxy = __float2int_rd(hi_y);
      mxx = mxx < INT_MAX ? mxx + 1 : mxx;
      mxy = mxy < INT_MAX ? mxy + 1 : mxy;
    }
    s_box[0][threadIdx.x] = mnx;
    s_box[1][threadIdx.x] = mny;
    s_box[2][threadIdx.x] = mxx;
    s_box[3][threadIdx.x] = mxy;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int mnx = INT_MAX, mny = INT_MAX, mxx = INT_MIN, mxy = INT_MIN;
    for (int k = 0; k < group; ++k) {
      mnx = min(mnx, s_box[0][k]);
      mny = min(mny, s_box[1][k]);
      mxx = max(mxx, s_box[2][k]);
      mxy = max(mxy, s_box[3][k]);
    }
    mnx = max(mnx, 0);
    mny = max(mny, 0);
    mxx = min(mxx, w0 - 1);
    mxy = min(mxy, h0 - 1);
    const int64_t bw = (int64_t)mxx - mnx + 1;
    const int64_t bh = (int64_t)mxy - mny + 1;
    box[0] = mnx;
    box[1] = mny;
    box[2] = mxx;
    box[3] = mxy;
    box[4] = (bw > 0 && bh > 0 && bw * bh <= MVS_TILE_PIX) ? 1 : 0;
  }
  __syncthreads();
  const int bx0 = box[0], by0 = box[1], bx1 = box[2], by1 = box[3];
  const bool use = box[4] != 0;
  const int bw = bx1 - bx0 + 1;

  // 2. cooperative load of the box into shared memory
  if (use) {
    const int npix = bw * (by1 - by0 + 1);
    for (int k = threadIdx.x; k < npix; k += blockDim.x) {
      const int r = k / bw;
      const int c = k - r * bw;
      tile[k] = __ldg(base0 + (by0 + r) * w0 + bx0 + c);
    }
  }
  __syncthreads();

  // 3. every (member, sample) through the shared sample routine
  for (int p = threadIdx.x; p < group * S; p += blockDim.x) {
    const int mbr = p / S;
    const int s = p - mbr * S;
    const int b = b0 + mbr;
    const float fi = (float)(s % wsize);
    const float fj = (float)(s / wsize);
    const int l = clamp_level(lvl[b], meta.n);
    int off, w, h;
    level_meta(meta, l, off, w, h);
    const float x = lattice(tl[2 * b], dx[2 * b], dy[2 * b], fi, fj);
    const float y = lattice(tl[2 * b + 1], dx[2 * b + 1], dy[2 * b + 1], fi, fj);
    const Taps t = bilinear_taps(x, y, w, h);
    int v00, v10, v01, v11;
    if (use && img[b] == img0 && l == l0 && t.lx >= bx0 && t.lx + 1 <= bx1 &&
        t.ly >= by0 && t.ly + 1 <= by1) {
      const int k = (t.ly - by0) * bw + (t.lx - bx0);
      v00 = tile[k];
      v10 = tile[k + 1];
      v01 = tile[k + bw];
      v11 = tile[k + bw + 1];
    } else {
      const int* base = planes + (int64_t)img[b] * total + off;
      const int i00 = t.ly * w + t.lx;
      v00 = __ldg(base + i00);
      v10 = __ldg(base + i00 + 1);
      v01 = __ldg(base + i00 + w);
      v11 = __ldg(base + i00 + w + 1);
    }
    store_sample(out, b, s, S, t, v00, v10, v01, v11);
  }
}

// ---------------------------------------------------------------------
// luma form (K3)
// ---------------------------------------------------------------------

// one luma sample from its packed quad, in the plain version's order
__device__ __forceinline__ float luma_sample(int v, const Frac& f) {
  const float y00 = (float)(v & 0xFF);
  const float y10 = (float)((v >> 8) & 0xFF);
  const float y01 = (float)((v >> 16) & 0xFF);
  const float y11 = (float)((v >> 24) & 0xFF);
  float r = __fmul_rn(__fmul_rn(y00, f.dx0), f.dy0);
  r = __fadd_rn(r, __fmul_rn(__fmul_rn(y10, f.dx1), f.dy0));
  r = __fadd_rn(r, __fmul_rn(__fmul_rn(y01, f.dx0), f.dy1));
  r = __fadd_rn(r, __fmul_rn(__fmul_rn(y11, f.dx1), f.dy1));
  return r;
}

// sample s of a window whose plane base, level size and lattice are given
__device__ __forceinline__ float luma_at(const int* __restrict__ base, int w,
                                         int h, float tx, float ty, float dxx,
                                         float dxy, float dyx, float dyy,
                                         int s, int wsize) {
  const float fi = (float)(s % wsize);
  const float fj = (float)(s / wsize);
  const float x = lattice(tx, dxx, dyx, fi, fj);
  const float y = lattice(ty, dxy, dyy, fi, fj);
  const Frac f = bilinear_frac(x, y, w, h);
  return luma_sample(__ldg(base + f.ly * w + f.lx), f);
}

__global__ void __launch_bounds__(MVS_THREADS)
sample_windows_luma_ungrouped_kernel(const int* __restrict__ planes,
                                     LevelMeta meta, int total,
                                     const int* __restrict__ img,
                                     const int* __restrict__ lvl,
                                     const float* __restrict__ tl,
                                     const float* __restrict__ dx,
                                     const float* __restrict__ dy,
                                     float* __restrict__ out, int B,
                                     int wsize) {
  const int S = wsize * wsize;
  int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (int64_t)B * S) return;
  const int b = (int)(gid / S);
  const int s = (int)(gid - (int64_t)b * S);
  int off, w, h;
  level_meta(meta, clamp_level(lvl[b], meta.n), off, w, h);
  const int* base = planes + (int64_t)img[b] * total + off;
  out[gid] = luma_at(base, w, h, tl[2 * b], tl[2 * b + 1], dx[2 * b],
                     dx[2 * b + 1], dy[2 * b], dy[2 * b + 1], s, wsize);
}

__global__ void __launch_bounds__(MVS_THREADS)
sample_windows_luma_grouped_kernel(const int* __restrict__ planes,
                                   LevelMeta meta, int total,
                                   const int* __restrict__ img,
                                   const int* __restrict__ lvl,
                                   const float* __restrict__ tl,
                                   const float* __restrict__ dx,
                                   const float* __restrict__ dy,
                                   float* __restrict__ out, int wsize,
                                   int group) {
  // per member: plane base offset (in ints), level width and height,
  // and the six lattice floats
  __shared__ int64_t s_base[MVS_MAX_GROUP];
  __shared__ int s_w[MVS_MAX_GROUP], s_h[MVS_MAX_GROUP];
  __shared__ float s_lat[6][MVS_MAX_GROUP];

  const int S = wsize * wsize;
  const int b0 = blockIdx.x * group;
  if (threadIdx.x < group) {
    const int b = b0 + threadIdx.x;
    int off, w, h;
    level_meta(meta, clamp_level(lvl[b], meta.n), off, w, h);
    s_base[threadIdx.x] = (int64_t)img[b] * total + off;
    s_w[threadIdx.x] = w;
    s_h[threadIdx.x] = h;
    s_lat[0][threadIdx.x] = tl[2 * b];
    s_lat[1][threadIdx.x] = tl[2 * b + 1];
    s_lat[2][threadIdx.x] = dx[2 * b];
    s_lat[3][threadIdx.x] = dx[2 * b + 1];
    s_lat[4][threadIdx.x] = dy[2 * b];
    s_lat[5][threadIdx.x] = dy[2 * b + 1];
  }
  __syncthreads();
  float* gout = out + (int64_t)b0 * S;
  for (int p = threadIdx.x; p < group * S; p += blockDim.x) {
    const int m = p / S;
    gout[p] = luma_at(planes + s_base[m], s_w[m], s_h[m], s_lat[0][m],
                      s_lat[1][m], s_lat[2][m], s_lat[3][m], s_lat[4][m],
                      s_lat[5][m], p - m * S, wsize);
  }
}

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

// Ungrouped launch (the TPU kernel's group=1 form). Pointers are device
// pointers except the three level-metadata arrays, which are host
// arrays of n_levels ints. Returns cudaGetLastError() after the launch.
extern "C" int mvs_sample_windows_ungrouped(
    const void* planes, int total, const int* lvl_off, const int* lvl_w,
    const int* lvl_h, int n_levels, const void* img, const void* lvl,
    const void* tl, const void* dx, const void* dy, void* out, int B,
    int wsize, void* stream) {
  LevelMeta meta;
  int err = make_meta(&meta, lvl_off, lvl_w, lvl_h, n_levels);
  if (err) return err;
  if (B <= 0) return 0;
  const int64_t n = (int64_t)B * wsize * wsize;
  const int64_t blocks = (n + MVS_THREADS - 1) / MVS_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sample_windows_ungrouped_kernel<<<(unsigned)blocks, MVS_THREADS, 0,
                                    (cudaStream_t)stream>>>(
      (const int*)planes, meta, total, (const int*)img, (const int*)lvl,
      (const float*)tl, (const float*)dx, (const float*)dy, (float*)out, B,
      wsize);
  return (int)cudaGetLastError();
}

// Grouped launch (the TPU kernel's group=refine_cands form): B must be a
// multiple of group, and group at most MVS_MAX_GROUP.
extern "C" int mvs_sample_windows_grouped(
    const void* planes, int total, const int* lvl_off, const int* lvl_w,
    const int* lvl_h, int n_levels, const void* img, const void* lvl,
    const void* tl, const void* dx, const void* dy, void* out, int B,
    int wsize, int group, void* stream) {
  LevelMeta meta;
  int err = make_meta(&meta, lvl_off, lvl_w, lvl_h, n_levels);
  if (err) return err;
  if (group < 2 || group > MVS_MAX_GROUP || B % group != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  sample_windows_grouped_kernel<<<B / group, MVS_THREADS, 0,
                                  (cudaStream_t)stream>>>(
      (const int*)planes, meta, total, (const int*)img, (const int*)lvl,
      (const float*)tl, (const float*)dx, (const float*)dy, (float*)out,
      wsize, group);
  return (int)cudaGetLastError();
}

// Ungrouped luma launch (K3, group=1): planes is the [n * I, total]
// luma-quad buffer; out is [B, wsize^2]. Returns cudaGetLastError().
extern "C" int mvs_sample_windows_luma_ungrouped(
    const void* planes, int total, const int* lvl_off, const int* lvl_w,
    const int* lvl_h, int n_levels, const void* img, const void* lvl,
    const void* tl, const void* dx, const void* dy, void* out, int B,
    int wsize, void* stream) {
  LevelMeta meta;
  int err = make_meta(&meta, lvl_off, lvl_w, lvl_h, n_levels);
  if (err) return err;
  if (B <= 0) return 0;
  const int64_t n = (int64_t)B * wsize * wsize;
  const int64_t blocks = (n + MVS_THREADS - 1) / MVS_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sample_windows_luma_ungrouped_kernel<<<(unsigned)blocks, MVS_THREADS, 0,
                                         (cudaStream_t)stream>>>(
      (const int*)planes, meta, total, (const int*)img, (const int*)lvl,
      (const float*)tl, (const float*)dx, (const float*)dy, (float*)out, B,
      wsize);
  return (int)cudaGetLastError();
}

// Grouped luma launch (K3, group=refine_cands): B must be a multiple of
// group, and group at most MVS_MAX_GROUP. The block size is the
// multiple of 32 in [128, MVS_THREADS] that leaves the fewest idle
// threads in the last pass over group * wsize^2 samples.
extern "C" int mvs_sample_windows_luma_grouped(
    const void* planes, int total, const int* lvl_off, const int* lvl_w,
    const int* lvl_h, int n_levels, const void* img, const void* lvl,
    const void* tl, const void* dx, const void* dy, void* out, int B,
    int wsize, int group, void* stream) {
  LevelMeta meta;
  int err = make_meta(&meta, lvl_off, lvl_w, lvl_h, n_levels);
  if (err) return err;
  if (group < 2 || group > MVS_MAX_GROUP || B % group != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int n = group * wsize * wsize;
  int threads = MVS_THREADS, idle = INT_MAX;
  for (int t = MVS_THREADS; t >= 128; t -= 32) {
    const int w = (n + t - 1) / t * t - n;
    if (w < idle) { idle = w; threads = t; }
  }
  sample_windows_luma_grouped_kernel<<<B / group, threads, 0,
                                       (cudaStream_t)stream>>>(
      (const int*)planes, meta, total, (const int*)img, (const int*)lvl,
      (const float*)tl, (const float*)dx, (const float*)dy, (float*)out,
      wsize, group);
  return (int)cudaGetLastError();
}
