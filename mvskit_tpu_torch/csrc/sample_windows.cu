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
//
// Fused form (K4): replaces _make_kernel with fused=True, group > 1
// (pallas_ncc.py:323-370), in both channel modes. It computes the same
// function as the grouped forms; on the TPU it evaluates a whole group
// with one matmul over concatenated tent weights and one K-row store.
// Here it is one block per group, C = 3 (RGB) or C = 1 (luma)
// channels: the group's window parameters and level metadata are staged
// in shared memory as in the grouped luma form, every tap is read from
// L2 with __ldg (no shared-memory box: the RGB box lost to plain L2
// reads), and the group's group * C * S outputs are assembled in dynamic
// shared memory (18,816 B for 32 RGB windows of 7 x 7, 75,264 B at
// group 128) and written as one contiguous run of 16-byte float4
// stores, Hopper's counterpart of the TPU's one store per group. It
// uses the same sample routines, so it equals the plain version and the
// unfused grouped launch bit for bit; a tensor-core tent-weight product
// would lose that (and lost to the unfused form on the TPU). Bound on
// the H100: the stores, about 462 MB for 786,432 RGB windows (0.14 ms at
// 3.35 TB/s), or a third of that for luma.
//
// Ablation switches (K5): replace _make_kernel's `ablate` settings
// (pallas_ncc.py:194-200, 233, 254, 271, 289, 384, 397), measurement
// variants that each drop one stage of the work. Each is a template
// parameter of every launch form, so the normal path pays nothing, and
// each gives a defined output that its plain version
// (ops/cuda_ncc.py::sample_windows_plain / _luma_plain, `ablate`)
// repeats bit for bit:
//   * nodma: no plane reads and no box load; every tap reads as 0 (the
//     weighted sums of zeros: 0, or NaN where a weight is NaN);
//   * nocompute: the tap origin is computed and tap 00 loaded; its
//     channel bytes are stored as floats, with no weights (the other
//     three taps are then dead loads, which the compiler drops);
//   * norot: the TPU's tile-alignment step has its counterpart in the
//     grouped RGB form's shared-memory box; norot runs that form with
//     every tap read from global memory. The output equals the normal
//     output; on the other forms it changes nothing;
//   * nowx: every sample of a window at its lattice origin (i = j = 0);
//   * nomm: the four taps loaded and their channel bytes summed without
//     weights (integers below 2^10: exact in any order).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define MVS_MAX_LEVELS 8
#define MVS_MAX_GROUP 128
#define MVS_TILE_PIX 11264  // 44 KB of int32 pixels (+ 2 KB of box
                            // bookkeeping: under the 48 KB static limit)
#define MVS_THREADS 256
#define MVS_STATIC_SMEM_LIMIT 49152

// ablation switches, in the order of ops/cuda_ncc.py::ABLATIONS
enum Ablate {
  ABL_NONE = 0,
  ABL_NODMA = 1,
  ABL_NOCOMPUTE = 2,
  ABL_NOROT = 3,
  ABL_NOWX = 4,
  ABL_NOMM = 5,
};

// launch forms
enum Form {
  FORM_UNGROUPED = 0,
  FORM_GROUPED = 1,
  FORM_LUMA_UNGROUPED = 2,
  FORM_LUMA_GROUPED = 3,
  FORM_FUSED = 4,
  FORM_LUMA_FUSED = 5,
};

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

// sample s's position: its lattice point, or the origin under nowx
template <int ABL>
__device__ __forceinline__ void sample_xy(float tx, float ty, float dxx,
                                          float dxy, float dyx, float dyy,
                                          int s, int wsize, float& x,
                                          float& y) {
  const float fi = ABL == ABL_NOWX ? 0.0f : (float)(s % wsize);
  const float fj = ABL == ABL_NOWX ? 0.0f : (float)(s / wsize);
  x = lattice(tx, dxx, dyx, fi, fj);
  y = lattice(ty, dxy, dyy, fi, fj);
}

// one plane word; nodma reads none
template <int ABL>
__device__ __forceinline__ int tap(const int* p) {
  return ABL == ABL_NODMA ? 0 : __ldg(p);
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

__device__ __forceinline__ float byte_at(int v, int k) {
  return (float)((v >> (8 * k)) & 0xFF);
}

__device__ __forceinline__ void accumulate(int v, float wgt, float& r,
                                           float& g, float& b) {
  r = __fadd_rn(r, __fmul_rn(byte_at(v, 0), wgt));
  g = __fadd_rn(g, __fmul_rn(byte_at(v, 1), wgt));
  b = __fadd_rn(b, __fmul_rn(byte_at(v, 2), wgt));
}

// the shared RGB sample routine: v00, v10, v01, v11 are the packed taps
template <int ABL>
__device__ __forceinline__ void rgb_sample(const Taps& t, int v00, int v10,
                                           int v01, int v11, float& r,
                                           float& g, float& b) {
  if (ABL == ABL_NOCOMPUTE) {
    r = byte_at(v00, 0);
    g = byte_at(v00, 1);
    b = byte_at(v00, 2);
    return;
  }
  r = 0.0f; g = 0.0f; b = 0.0f;
  if (ABL == ABL_NOMM) {
    const int v[4] = {v00, v10, v01, v11};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r = __fadd_rn(r, byte_at(v[k], 0));
      g = __fadd_rn(g, byte_at(v[k], 1));
      b = __fadd_rn(b, byte_at(v[k], 2));
    }
    return;
  }
  accumulate(v00, t.f00, r, g, b);
  accumulate(v10, t.f10, r, g, b);
  accumulate(v01, t.f01, r, g, b);
  accumulate(v11, t.f11, r, g, b);
}

__device__ __forceinline__ void store_rgb(float* __restrict__ row, int s,
                                          int S, float r, float g, float b) {
  row[s] = r;
  row[S + s] = g;
  row[2 * S + s] = b;
}

// RGB sample s of a window, every tap from global memory
template <int ABL>
__device__ __forceinline__ void rgb_at(const int* __restrict__ base, int w,
                                       int h, float tx, float ty, float dxx,
                                       float dxy, float dyx, float dyy, int s,
                                       int wsize, float& r, float& g,
                                       float& b) {
  float x, y;
  sample_xy<ABL>(tx, ty, dxx, dxy, dyx, dyy, s, wsize, x, y);
  const Taps t = bilinear_taps(x, y, w, h);
  const int* p = base + t.ly * w + t.lx;
  rgb_sample<ABL>(t, tap<ABL>(p), tap<ABL>(p + 1), tap<ABL>(p + w),
                  tap<ABL>(p + w + 1), r, g, b);
}

// one luma sample from its packed quad, in the plain version's order
template <int ABL>
__device__ __forceinline__ float luma_sample(int v, const Frac& f) {
  const float y00 = byte_at(v, 0);
  if (ABL == ABL_NOCOMPUTE) return y00;
  const float y10 = byte_at(v, 1);
  const float y01 = byte_at(v, 2);
  const float y11 = byte_at(v, 3);
  if (ABL == ABL_NOMM) return __fadd_rn(__fadd_rn(__fadd_rn(y00, y10), y01), y11);
  float r = __fmul_rn(__fmul_rn(y00, f.dx0), f.dy0);
  r = __fadd_rn(r, __fmul_rn(__fmul_rn(y10, f.dx1), f.dy0));
  r = __fadd_rn(r, __fmul_rn(__fmul_rn(y01, f.dx0), f.dy1));
  r = __fadd_rn(r, __fmul_rn(__fmul_rn(y11, f.dx1), f.dy1));
  return r;
}

// luma sample s of a window whose plane base, level size and lattice
// are given
template <int ABL>
__device__ __forceinline__ float luma_at(const int* __restrict__ base, int w,
                                         int h, float tx, float ty, float dxx,
                                         float dxy, float dyx, float dyy,
                                         int s, int wsize) {
  float x, y;
  sample_xy<ABL>(tx, ty, dxx, dxy, dyx, dyy, s, wsize, x, y);
  const Frac f = bilinear_frac(x, y, w, h);
  return luma_sample<ABL>(tap<ABL>(base + f.ly * w + f.lx), f);
}

// a group's window parameters and level metadata in shared memory:
// per member its plane base offset (in ints), level width and height,
// and the six lattice floats
struct GroupParams {
  int64_t base[MVS_MAX_GROUP];
  int w[MVS_MAX_GROUP], h[MVS_MAX_GROUP];
  float lat[6][MVS_MAX_GROUP];
};

__device__ __forceinline__ void stage_group(GroupParams& g, const LevelMeta& meta,
                                            int total, const int* __restrict__ img,
                                            const int* __restrict__ lvl,
                                            const float* __restrict__ tl,
                                            const float* __restrict__ dx,
                                            const float* __restrict__ dy,
                                            int b0, int group) {
  if (threadIdx.x < group) {
    const int m = threadIdx.x;
    const int b = b0 + m;
    int off, w, h;
    level_meta(meta, clamp_level(lvl[b], meta.n), off, w, h);
    g.base[m] = (int64_t)img[b] * total + off;
    g.w[m] = w;
    g.h[m] = h;
    g.lat[0][m] = tl[2 * b];
    g.lat[1][m] = tl[2 * b + 1];
    g.lat[2][m] = dx[2 * b];
    g.lat[3][m] = dx[2 * b + 1];
    g.lat[4][m] = dy[2 * b];
    g.lat[5][m] = dy[2 * b + 1];
  }
  __syncthreads();
}

template <int ABL>
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
  int off, w, h;
  level_meta(meta, clamp_level(lvl[b], meta.n), off, w, h);
  float r, g, bl;
  rgb_at<ABL>(planes + (int64_t)img[b] * total + off, w, h, tl[2 * b],
              tl[2 * b + 1], dx[2 * b], dx[2 * b + 1], dy[2 * b],
              dy[2 * b + 1], s, wsize, r, g, bl);
  store_rgb(out + (int64_t)b * 3 * S, s, S, r, g, bl);
}

template <int ABL>
__global__ void __launch_bounds__(MVS_THREADS)
sample_windows_grouped_kernel(const int* __restrict__ planes, LevelMeta meta,
                              int total, const int* __restrict__ img,
                              const int* __restrict__ lvl,
                              const float* __restrict__ tl,
                              const float* __restrict__ dx,
                              const float* __restrict__ dy,
                              float* __restrict__ out, int wsize, int group) {
  // the box: shared-memory tile of the group's taps; norot reads every
  // tap from global memory instead, and nodma reads no plane at all
  constexpr bool kBox = ABL != ABL_NOROT && ABL != ABL_NODMA;
  __shared__ int tile[kBox ? MVS_TILE_PIX : 1];
  __shared__ int s_box[4][MVS_MAX_GROUP];
  __shared__ int box[5];  // x0, y0, x1, y1 (inclusive), use

  const int S = wsize * wsize;
  const int b0 = blockIdx.x * group;
  const int img0 = img[b0];
  const int l0 = clamp_level(lvl[b0], meta.n);
  int off0, w0, h0;
  level_meta(meta, l0, off0, w0, h0);
  const int* base0 = planes + (int64_t)img0 * total + off0;

  bool use = false;
  int bx0 = 0, by0 = 0, bx1 = -1, by1 = -1;
  if (kBox) {
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
    bx0 = box[0]; by0 = box[1]; bx1 = box[2]; by1 = box[3];
    use = box[4] != 0;

    // 2. cooperative load of the box into shared memory
    if (use) {
      const int bw = bx1 - bx0 + 1;
      const int npix = bw * (by1 - by0 + 1);
      for (int k = threadIdx.x; k < npix; k += blockDim.x) {
        const int r = k / bw;
        const int c = k - r * bw;
        tile[k] = __ldg(base0 + (by0 + r) * w0 + bx0 + c);
      }
    }
    __syncthreads();
  }
  const int bw = bx1 - bx0 + 1;

  // 3. every (member, sample) through the shared sample routine
  for (int p = threadIdx.x; p < group * S; p += blockDim.x) {
    const int mbr = p / S;
    const int s = p - mbr * S;
    const int b = b0 + mbr;
    const int l = clamp_level(lvl[b], meta.n);
    int off, w, h;
    level_meta(meta, l, off, w, h);
    float x, y;
    sample_xy<ABL>(tl[2 * b], tl[2 * b + 1], dx[2 * b], dx[2 * b + 1],
                   dy[2 * b], dy[2 * b + 1], s, wsize, x, y);
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
      const int* q = planes + (int64_t)img[b] * total + off + t.ly * w + t.lx;
      v00 = tap<ABL>(q);
      v10 = tap<ABL>(q + 1);
      v01 = tap<ABL>(q + w);
      v11 = tap<ABL>(q + w + 1);
    }
    float r, g, bl;
    rgb_sample<ABL>(t, v00, v10, v01, v11, r, g, bl);
    store_rgb(out + (int64_t)b * 3 * S, s, S, r, g, bl);
  }
}

template <int ABL>
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
  out[gid] = luma_at<ABL>(base, w, h, tl[2 * b], tl[2 * b + 1], dx[2 * b],
                          dx[2 * b + 1], dy[2 * b], dy[2 * b + 1], s, wsize);
}

template <int ABL>
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
  __shared__ GroupParams g;
  const int S = wsize * wsize;
  const int b0 = blockIdx.x * group;
  stage_group(g, meta, total, img, lvl, tl, dx, dy, b0, group);
  float* gout = out + (int64_t)b0 * S;
  for (int p = threadIdx.x; p < group * S; p += blockDim.x) {
    const int m = p / S;
    gout[p] = luma_at<ABL>(planes + g.base[m], g.w[m], g.h[m], g.lat[0][m],
                           g.lat[1][m], g.lat[2][m], g.lat[3][m], g.lat[4][m],
                           g.lat[5][m], p - m * S, wsize);
  }
}

// K4: C = 3 (RGB, rows [C * S] channel-major) or C = 1 (luma). The
// group's outputs are assembled in dynamic shared memory and stored as
// one contiguous run of float4s.
template <int C, int ABL>
__global__ void __launch_bounds__(MVS_THREADS)
sample_windows_fused_kernel(const int* __restrict__ planes, LevelMeta meta,
                            int total, const int* __restrict__ img,
                            const int* __restrict__ lvl,
                            const float* __restrict__ tl,
                            const float* __restrict__ dx,
                            const float* __restrict__ dy,
                            float* __restrict__ out, int wsize, int group) {
  extern __shared__ float4 s_out4[];  // group * C * S floats
  float* s_out = reinterpret_cast<float*>(s_out4);
  __shared__ GroupParams g;
  const int S = wsize * wsize;
  const int b0 = blockIdx.x * group;
  stage_group(g, meta, total, img, lvl, tl, dx, dy, b0, group);

  for (int p = threadIdx.x; p < group * S; p += blockDim.x) {
    const int m = p / S;
    const int s = p - m * S;
    const int* base = planes + g.base[m];
    if (C == 1) {
      s_out[p] = luma_at<ABL>(base, g.w[m], g.h[m], g.lat[0][m], g.lat[1][m],
                              g.lat[2][m], g.lat[3][m], g.lat[4][m],
                              g.lat[5][m], s, wsize);
    } else {
      float r, gg, bl;
      rgb_at<ABL>(base, g.w[m], g.h[m], g.lat[0][m], g.lat[1][m], g.lat[2][m],
                  g.lat[3][m], g.lat[4][m], g.lat[5][m], s, wsize, r, gg, bl);
      store_rgb(s_out + m * C * S, s, S, r, gg, bl);
    }
  }
  __syncthreads();

  const int n = group * C * S;
  float* gout = out + (int64_t)b0 * C * S;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(gout) & 15) == 0) {
    float4* g4 = reinterpret_cast<float4*>(gout);
    for (int k = threadIdx.x; k < n / 4; k += blockDim.x) g4[k] = s_out4[k];
  } else {  // a group of 2 (or an unaligned output) stores floats
    for (int k = threadIdx.x; k < n; k += blockDim.x) gout[k] = s_out[k];
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

// the multiple of 32 in [128, MVS_THREADS] that leaves the fewest idle
// threads in the last pass over n samples
static int group_threads(int n) {
  int threads = MVS_THREADS, idle = INT_MAX;
  for (int t = MVS_THREADS; t >= 128; t -= 32) {
    const int w = (n + t - 1) / t * t - n;
    if (w < idle) { idle = w; threads = t; }
  }
  return threads;
}

struct Launch {
  const int* planes;
  LevelMeta meta;
  int total;
  const int* img;
  const int* lvl;
  const float* tl;
  const float* dx;
  const float* dy;
  float* out;
  int B, wsize, group;
  cudaStream_t stream;
};

template <int C, int ABL>
static int launch_fused(const Launch& a) {
  const size_t smem = (size_t)a.group * C * a.wsize * a.wsize * sizeof(float);
  auto kernel = sample_windows_fused_kernel<C, ABL>;
  if (smem > MVS_STATIC_SMEM_LIMIT) {
    // above 48 KB only as opted-in dynamic shared memory; a size beyond
    // the block's limit (227 KB on the H100) fails here or at launch
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // consume it: the next launch's check reads it
      return (int)err;
    }
  }
  kernel<<<a.B / a.group, group_threads(a.group * a.wsize * a.wsize), smem,
           a.stream>>>(a.planes, a.meta, a.total, a.img, a.lvl, a.tl, a.dx,
                       a.dy, a.out, a.wsize, a.group);
  return (int)cudaGetLastError();
}

template <int ABL>
static int launch_form(int form, const Launch& a) {
  if (form == FORM_UNGROUPED || form == FORM_LUMA_UNGROUPED) {
    const int64_t n = (int64_t)a.B * a.wsize * a.wsize;
    const int64_t blocks = (n + MVS_THREADS - 1) / MVS_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (form == FORM_UNGROUPED)
      sample_windows_ungrouped_kernel<ABL><<<(unsigned)blocks, MVS_THREADS, 0,
                                             a.stream>>>(
          a.planes, a.meta, a.total, a.img, a.lvl, a.tl, a.dx, a.dy, a.out,
          a.B, a.wsize);
    else
      sample_windows_luma_ungrouped_kernel<ABL><<<(unsigned)blocks,
                                                  MVS_THREADS, 0, a.stream>>>(
          a.planes, a.meta, a.total, a.img, a.lvl, a.tl, a.dx, a.dy, a.out,
          a.B, a.wsize);
    return (int)cudaGetLastError();
  }
  if (a.group < 2 || a.group > MVS_MAX_GROUP || a.B % a.group != 0)
    return (int)cudaErrorInvalidValue;
  switch (form) {
    case FORM_GROUPED:
      sample_windows_grouped_kernel<ABL><<<a.B / a.group, MVS_THREADS, 0,
                                           a.stream>>>(
          a.planes, a.meta, a.total, a.img, a.lvl, a.tl, a.dx, a.dy, a.out,
          a.wsize, a.group);
      return (int)cudaGetLastError();
    case FORM_LUMA_GROUPED:
      sample_windows_luma_grouped_kernel<ABL><<<
          a.B / a.group, group_threads(a.group * a.wsize * a.wsize), 0,
          a.stream>>>(a.planes, a.meta, a.total, a.img, a.lvl, a.tl, a.dx,
                      a.dy, a.out, a.wsize, a.group);
      return (int)cudaGetLastError();
    case FORM_FUSED:
      return launch_fused<3, ABL>(a);
    case FORM_LUMA_FUSED:
      return launch_fused<1, ABL>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Checks the batch and dispatches the launch form to its ablation's
// kernel. Pointers are device pointers except the three level-metadata
// arrays, which are host arrays of n_levels ints. Returns
// cudaGetLastError() after the launch (0 for an empty batch).
static int launch(int form, const void* planes, int total, const int* lvl_off,
                  const int* lvl_w, const int* lvl_h, int n_levels,
                  const void* img, const void* lvl, const void* tl,
                  const void* dx, const void* dy, void* out, int B, int wsize,
                  int group, int ablate, void* stream) {
  Launch a;
  int err = make_meta(&a.meta, lvl_off, lvl_w, lvl_h, n_levels);
  if (err) return err;
  if (B <= 0) return 0;
  a.planes = (const int*)planes;
  a.total = total;
  a.img = (const int*)img;
  a.lvl = (const int*)lvl;
  a.tl = (const float*)tl;
  a.dx = (const float*)dx;
  a.dy = (const float*)dy;
  a.out = (float*)out;
  a.B = B;
  a.wsize = wsize;
  a.group = group;
  a.stream = (cudaStream_t)stream;
  switch (ablate) {
    case ABL_NONE: return launch_form<ABL_NONE>(form, a);
    case ABL_NODMA: return launch_form<ABL_NODMA>(form, a);
    case ABL_NOCOMPUTE: return launch_form<ABL_NOCOMPUTE>(form, a);
    case ABL_NOROT: return launch_form<ABL_NOROT>(form, a);
    case ABL_NOWX: return launch_form<ABL_NOWX>(form, a);
    case ABL_NOMM: return launch_form<ABL_NOMM>(form, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

#define MVS_COMMON_PARAMS                                                   \
  const void *planes, int total, const int *lvl_off, const int *lvl_w,      \
      const int *lvl_h, int n_levels, const void *img, const void *lvl,     \
      const void *tl, const void *dx, const void *dy, void *out, int B,     \
      int wsize
#define MVS_COMMON_ARGS                                                     \
  planes, total, lvl_off, lvl_w, lvl_h, n_levels, img, lvl, tl, dx, dy,     \
      out, B, wsize

// Ungrouped launch (the TPU kernel's group=1 form), RGB rows [B, 3 * S].
extern "C" int mvs_sample_windows_ungrouped(MVS_COMMON_PARAMS, int ablate,
                                            void* stream) {
  return launch(FORM_UNGROUPED, MVS_COMMON_ARGS, 1, ablate, stream);
}

// Grouped launch (the TPU kernel's group=refine_cands form): B must be a
// multiple of group, and group in [2, MVS_MAX_GROUP].
extern "C" int mvs_sample_windows_grouped(MVS_COMMON_PARAMS, int group,
                                          int ablate, void* stream) {
  return launch(FORM_GROUPED, MVS_COMMON_ARGS, group, ablate, stream);
}

// Ungrouped luma launch (K3, group=1): planes is the [n * I, total]
// luma-quad buffer; out is [B, wsize^2].
extern "C" int mvs_sample_windows_luma_ungrouped(MVS_COMMON_PARAMS, int ablate,
                                                 void* stream) {
  return launch(FORM_LUMA_UNGROUPED, MVS_COMMON_ARGS, 1, ablate, stream);
}

// Grouped luma launch (K3, group=refine_cands); the same rules on group.
extern "C" int mvs_sample_windows_luma_grouped(MVS_COMMON_PARAMS, int group,
                                               int ablate, void* stream) {
  return launch(FORM_LUMA_GROUPED, MVS_COMMON_ARGS, group, ablate, stream);
}

// Fused RGB launch (K4, fused=True): the grouped form's output, one
// float4 run per group; the same rules on group.
extern "C" int mvs_sample_windows_fused(MVS_COMMON_PARAMS, int group,
                                        int ablate, void* stream) {
  return launch(FORM_FUSED, MVS_COMMON_ARGS, group, ablate, stream);
}

// Fused luma launch (K4 with rgb=False); the same rules on group.
extern "C" int mvs_sample_windows_luma_fused(MVS_COMMON_PARAMS, int group,
                                             int ablate, void* stream) {
  return launch(FORM_LUMA_FUSED, MVS_COMMON_ARGS, group, ablate, stream);
}
