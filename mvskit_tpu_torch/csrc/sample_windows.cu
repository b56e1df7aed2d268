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
// Luma forms (K3, rgb=False): the same kernel's f32 luma mode
// (pallas_ncc.py:190). They read the quad-packed luma planes
// (Scene.planes_luma_quad: y00 | y10<<8 | y01<<16 | y11<<24 per pixel),
// so one 4-byte load carries all four taps of a sample, and write
// out[b, s] = y00*dx0*dy0 + y10*dx1*dy0 + y01*dx0*dy1 + y11*dx1*dy1,
// evaluated left to right with every operation rounded alone, as its
// plain version (ops/sampling.py::sample_luma_quad) does.
//
// Every launch takes the view index of each window and the scene's
// illumination count ni and illumination illum; the plane row it reads
// is idx * ni + illum, computed where the window's member entry is
// resolved (no index tensor is built per call).
//
// Ungrouped and grouped forms (K1 and K2 RGB, K3u and K3g luma): one
// template, window_kernel<C, WS, ABL> (C = 3 or 1 channels, WS the
// window size, ABL the K5 switch), over tiles of G consecutive windows.
// The grouped forms replace _make_kernel with group=refine_cands
// (pallas_ncc.py:190; 32 on the main path): a tile is one candidate
// group. The ungrouped forms (group=1) cut the batch into tiles of
// independent windows: nothing in the kernel needs a tile's members to
// share a patch, and the output rows [B, C * S] of consecutive windows
// are one contiguous run either way. On the H100 the work is bound by
// issued instructions and stores, not by tap bytes: 786,432 refinement
// windows write 462 MB of RGB rows (154 MB luma) against about 25 MB of
// window parameters, and the taps (planes of about 26 MB for 16 views
// x 640x480 x 4 levels) are mostly hits in the 50 MB L2. The design:
//   * persistent blocks: min(tiles, SMs x resident blocks per SM)
//     blocks (queried once per device and instance, cached) walk the
//     tiles with stride gridDim.x;
//   * staged parameters: a tile's slices of idx, lvl, tl, dx and dy are
//     contiguous (1 KB at 32 windows); the next tile's are copied into
//     a double buffer in shared memory with cp.async while the current
//     tile samples; a block's first tile is copied the same way (reading
//     it straight from global memory into the member table measured
//     level with the copy, PERF.md §6);
//   * a member table, resolved once per tile: each member's plane base,
//     level width and height (the 8-way level select once per member,
//     not per sample) and the lattice's partial sums tl + dx * i and
//     dy * j, so a sample's position costs one add per coordinate with
//     the plain lattice's rounding, (tl + dx * i) + dy * j;
//   * no shared-memory box (the first K2 loaded one and lost to plain L2
//     reads): every tap is read from L2 with __ldg;
//   * loads ahead of arithmetic: each thread takes MVS_KC samples of the
//     tile per pass and issues all their tap loads (4 per RGB sample, 1
//     per luma sample) before any of their arithmetic, in an unrolled
//     loop of constant trip count. Resident warps count for more than
//     loads per thread: more samples a pass hold more registers, leave
//     fewer blocks per SM and measured slower (PERF.md §6);
//   * WS = 7 (MVSConfig.wsize's default) is compiled for its size, so
//     the divisions by S and by wsize are by constants; every other size
//     runs the same code with wsize read at run time (WS = 0);
//   * the output through shared memory and TMA: the tile's rows go into
//     one of two output stages (18,816 B RGB, 6,272 B luma at 32 x 7x7;
//     one stage where two exceed the card's shared memory, and in the
//     ungrouped plan), then one thread stores the stage with
//     one 1-D bulk copy (cp.async.bulk.global.shared::cta) after
//     fence.proxy.async; the store of tile t overlaps the loads and
//     arithmetic of tile t+1, and a stage is rewritten only after
//     cp.async.bulk.wait_group.read (at most the other stage's store
//     still reading it out). A run that is not a multiple of 16 bytes
//     (group 2, luma, 7x7: 392 B; a ragged last tile of 1-3 windows) or
//     an output that is not 16-byte aligned is stored with coalesced
//     float stores from the stage, decided per tile;
//   * the ragged last tile: B is any positive count; the last tile holds
//     B - t * G windows, and its parameter copy, member table, sampling
//     and store cover those alone (no read past B);
//   * the tile plan: the grouped forms take G = group and two stages
//     where they fit; a shared-memory request the card refuses (RGB
//     group 128 at 15x15) returns its error, and the wrapper raises. The
//     ungrouped forms (plan_ungrouped) take 256 threads, one stage and
//     a tile of a fixed sample count, 1,960 RGB samples (40 windows of
//     7x7) or 3,136 luma samples (64 windows), at most 64 windows and
//     rounded down to a multiple of 4 (16-byte parameter copies, TMA
//     stores of 7x7 runs); no window size or batch it takes is refused.
//     These tiles measured fastest, or within 3 % of the fastest, at the
//     batches the paths give the two forms (PERF.md §6). Small batches
//     stay far from their bound whatever the tile: a launch's fixed
//     costs (block start, the parameter fetch, the closing store) set
//     much of their time.
// The sample routines keep the gather path's rounding, so every form
// equals the plain version, and the grouped launch equals the ungrouped
// one, bit for bit. Tensor cores do not apply: a bilinear gather has no
// matrix-product form that keeps this rounding (and the TPU's one-hot
// product, K4, lost to its gather).
//
// Fused form (K4): replaces _make_kernel with fused=True, group > 1
// (pallas_ncc.py:323-370), in both channel modes. It computes the same
// function as the grouped forms; on the TPU it evaluates a whole group
// with one matmul over concatenated tent weights and one K-row store.
// Here it is fused_kernel<C, WS, ABL>, a template of its own (K2 and K3g
// are not changed by it). Like the other forms it is held back by issued
// instructions and load latency rather than bytes, so its design cuts
// instructions per sample and keeps more loads in flight per thread:
//   * persistent blocks over groups: min(groups, SMs x resident blocks)
//     blocks walk the groups with stride gridDim.x; the next group's
//     parameters are copied with cp.async into a double buffer while this
//     group samples, and each group's group * C * S outputs are assembled
//     in one of two shared-memory stages and leave as one TMA bulk store
//     (Hopper's counterpart of the TPU's one store per group), which
//     overlaps the next group's work; float stores where a group's run
//     is not 16-byte sized (group 2 luma at 7 x 7: 392 B); one stage where
//     two pass the card's shared memory, and a size whose one stage passes
//     it (RGB group 128 at 15 x 15) is refused with the launch's error;
//   * threads over lattice columns (member m, column i), two columns a
//     thread: a column's member base, level size and six lattice floats
//     are read once, and so is its partial sum tl + d1 * i, and j is the
//     index of an unrolled loop (WS = 7 compiled for its size, WS = 0 for
//     every other size, one column at a time in passes of 8 luma or 4 RGB
//     samples), so no sample does an integer division or re-reads its
//     member; all tap loads of a thread's two columns (14 luma, 56 RGB)
//     are issued before any of their arithmetic. (One thread per lattice
//     row, the first design, measured the same for luma and 4 % slower
//     for RGB; a column's lanes read neighbouring pixels; PERF.md §6.)
//   * exact conversions on the FP32 pipe: a tap byte becomes a float by
//     one PRMT into the mantissa of 2^23 and one subtraction (byte_f32),
//     and the tap origin is clamped in float and truncated by an add of
//     1.5 * 2^23 rounded toward zero (tap_origin), in place of byte_at's
//     shift, mask and I2F and bilinear_frac's F2I and I2F. Both give the
//     same values as the window kernel's routines for every input, so K4
//     equals the plain version and the grouped launch bit for bit.
//
// Ablation switches (K5): replace _make_kernel's `ablate` settings
// (pallas_ncc.py:194-200, 233, 254, 271, 289, 384, 397), measurement
// variants that each drop one stage of the work. Each is a template
// parameter of every launch form, so the normal path pays nothing, and
// each gives a defined output that its plain version
// (ops/cuda_ncc.py::sample_windows_plain / _luma_plain, `ablate`)
// repeats bit for bit:
//   * nodma: no plane reads; every tap reads as 0 (the weighted sums of
//     zeros: 0, or NaN where a weight is NaN);
//   * nocompute: the tap origin is computed and tap 00 loaded; its
//     channel bytes are stored as floats, with no weights (the other
//     three taps are then dead loads, which the compiler drops);
//   * norot: the TPU's tile-alignment step. Its counterpart was the
//     first K2's shared-memory box; no form has a box now, so norot
//     changes nothing on any form: its output and its work are the
//     normal ones;
//   * nowx: every sample of a window at its lattice origin (i = j = 0);
//   * nomm: the four taps loaded and their channel bytes summed without
//     weights (integers below 2^10: exact in any order).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sample_common.cuh"

#include <algorithm>

#define MVS_MAX_GROUP 128
#define MVS_THREADS 256
#define MVS_KC 2  // window kernel: samples per thread per pass

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

// one plane word; nodma reads none
template <int ABL>
__device__ __forceinline__ int tap(const int* p) {
  return ABL == ABL_NODMA ? 0 : __ldg(p);
}

struct Taps {
  int lx, ly;
  float f00, f10, f01, f11;
};

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

// ---- K1, K2, K3u, K3g: the persistent window kernel ----

// A tile's member table in shared memory, resolved once per tile from
// its raw parameters: per member m its plane base (in ints) and level
// width and height, and the lattice's partial sums
//   a[m * ws + i] = (tl.x + dx.x * i, tl.y + dx.y * i),
//   c[m * ws + j] = (dy.x * j, dy.y * j),
// so sample (i, j) lies at a + c, rounded exactly as the plain version
// (cuda_ncc.lattice) rounds (tl + d1 * i) + d2 * j. Under nowx every i
// and j is 0.
struct Members {
  int64_t* base;  // [G]
  int2* wh;       // [G]
  float2* a;      // [G * ws]
  float2* c;      // [G * ws]
};

// the member table of the tile's n windows from its raw parameter
// buffer in shared memory (laid out for G); member m reads plane row
// idx[m] * ni + illum
template <int ABL>
__device__ __forceinline__ void resolve_members(const int* raw, int G, const Members& t,
                                                const LevelMeta& meta, int total, int ni,
                                                int illum, int n, int ws) {
  const int* idx = raw;
  const int* lvl = raw + G;
  const float* f = reinterpret_cast<const float*>(raw);
  const float *tl = f + 2 * G, *dx = f + 4 * G, *dy = f + 6 * G;
  for (int m = threadIdx.x; m < n; m += blockDim.x) {
    int off, w, h;
    level_meta(meta, clamp_level(lvl[m], meta.n), off, w, h);
    t.base[m] = (int64_t)(idx[m] * ni + illum) * total + off;
    t.wh[m] = make_int2(w, h);
  }
  for (int e = threadIdx.x; e < n * ws; e += blockDim.x) {
    const int m = e / ws;
    const float k = ABL == ABL_NOWX ? 0.0f : (float)(e - m * ws);
    t.a[e] = make_float2(__fadd_rn(tl[2 * m], __fmul_rn(dx[2 * m], k)),
                         __fadd_rn(tl[2 * m + 1], __fmul_rn(dx[2 * m + 1], k)));
    t.c[e] = make_float2(__fmul_rn(dy[2 * m], k), __fmul_rn(dy[2 * m + 1], k));
  }
}

// one tile's n * S samples into its stage (rows [C * S], channel-major),
// MVS_KC samples per thread per pass: every tap load of the pass is
// issued before any of its arithmetic
template <int C, int WS, int ABL>
__device__ __forceinline__ void sample_tile(const int* __restrict__ planes,
                                            const Members& t, int n_members, int wsize,
                                            float* st) {
  const int ws = WS > 0 ? WS : wsize;  // a constant in the WS > 0 instance
  const int S = ws * ws;
  const int n = n_members * S;
  const int T = blockDim.x;
  for (int p0 = threadIdx.x; p0 < n; p0 += T * MVS_KC) {
    int v[MVS_KC][4];  // RGB: taps 00, 10, 01, 11; luma: the quad in [0]
    Taps tp[MVS_KC];   // RGB
    Frac fr[MVS_KC];   // luma
#pragma unroll
    for (int k = 0; k < MVS_KC; ++k) {
      const int p = p0 + k * T;
      if (p < n) {
        const int q = p / ws;        // m * ws + j
        const int m = q / ws;
        const int i = p - q * ws;
        const float2 a = t.a[m * ws + i];
        const float2 c = t.c[q];
        const float x = __fadd_rn(a.x, c.x), y = __fadd_rn(a.y, c.y);
        const int2 wh = t.wh[m];
        if (C == 3) {
          tp[k] = bilinear_taps(x, y, wh.x, wh.y);
          const int* r = planes + t.base[m] + tp[k].ly * wh.x + tp[k].lx;
          v[k][0] = tap<ABL>(r);
          v[k][1] = tap<ABL>(r + 1);
          v[k][2] = tap<ABL>(r + wh.x);
          v[k][3] = tap<ABL>(r + wh.x + 1);
        } else {
          fr[k] = bilinear_frac(x, y, wh.x, wh.y);
          v[k][0] = tap<ABL>(planes + t.base[m] + fr[k].ly * wh.x + fr[k].lx);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < MVS_KC; ++k) {
      const int p = p0 + k * T;
      if (p < n) {
        if (C == 3) {
          float r, g, b;
          rgb_sample<ABL>(tp[k], v[k][0], v[k][1], v[k][2], v[k][3], r, g, b);
          // member m's row starts at 3 * m * S, and p = m * S + lane
          store_rgb(st + 2 * (p / S) * S, p, S, r, g, b);
        } else {
          st[p] = luma_sample<ABL>(v[k][0], fr[k]);
        }
      }
    }
  }
}

// The window kernel: persistent blocks, each walking the tiles of G
// consecutive windows with stride gridDim.x. Dynamic shared memory
// (plan_tiles): `nstages` output stages of stage_floats floats, two raw
// parameter buffers (8 * G words each), then the member table. A block
// resolves its first tile's members from a staged copy. Per tile: the next tile's parameters are
// copied in with cp.async while this tile samples; the stage goes out as
// one TMA bulk store (tma) that overlaps the next tile's work, or as
// coalesced float stores where the tile's run is not 16-byte sized (a
// ragged last tile) or aligned. The member table is rewritten for the
// next tile only after the barrier that ends this tile's sampling.
template <int C, int WS, int ABL>
__global__ void __launch_bounds__(MVS_THREADS)
window_kernel(const int* __restrict__ planes, LevelMeta meta, int total, int ni,
              int illum, const int* __restrict__ idx, const int* __restrict__ lvl,
              const float* __restrict__ tl, const float* __restrict__ dx,
              const float* __restrict__ dy, float* __restrict__ out, int B, int wsize,
              int G, int stage_floats, int nstages, int tma, int vec16) {
  const int ws = WS > 0 ? WS : wsize;
  const int S = ws * ws;
  const int ntiles = (B - 1) / G + 1;
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  int* raw = reinterpret_cast<int*>(stage + nstages * stage_floats);
  Members t;
  t.base = reinterpret_cast<int64_t*>(raw + 16 * G);
  t.wh = reinterpret_cast<int2*>(t.base + G);
  t.a = reinterpret_cast<float2*>(t.wh + G);
  t.c = t.a + G * ws;
  const int64_t run = (int64_t)G * C * S;  // floats per whole tile

  int g = blockIdx.x;
  int n = tile_members(g, G, B);
  copy_params(raw, G, (int64_t)g * G, n, vec16, idx, lvl, tl, dx, dy);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  resolve_members<ABL>(raw, G, t, meta, total, ni, illum, n, ws);
  for (int it = 0; g < ntiles; g += gridDim.x, ++it) {
    const int nxt = (it & 1) ^ 1;
    const int next = g + gridDim.x;
    const int n_next = next < ntiles ? tile_members(next, G, B) : 0;
    if (n_next)
      copy_params(raw + nxt * 8 * G, G, (int64_t)next * G, n_next, vec16, idx, lvl, tl,
                  dx, dy);
    cp_async_commit();
    float* st = stage + (nstages == 2 ? it & 1 : 0) * stage_floats;
    if (tma && threadIdx.x == 0) {  // the store that last read `st` is done
      if (nstages == 2) bulk_wait_read<1>(); else bulk_wait_read<0>();
    }
    __syncthreads();  // members resolved, `st` free
    sample_tile<C, WS, ABL>(planes, t, n, wsize, st);
    if (tma) fence_proxy_async();
    cp_async_wait_all();
    __syncthreads();  // stage complete, next parameters arrived
    float* gout = out + (int64_t)g * run;
    const int n_out = n * C * S;
    if (tma && n_out % 4 == 0) {
      if (threadIdx.x == 0) bulk_store(gout, st, n_out * (int)sizeof(float));
    } else {
      for (int k = threadIdx.x; k < n_out; k += blockDim.x) gout[k] = st[k];
    }
    if (n_next)
      resolve_members<ABL>(raw + nxt * 8 * G, G, t, meta, total, ni, illum, n_next, ws);
    n = n_next;
  }
  if (tma && threadIdx.x == 0) bulk_wait_all();
}

// ---- K4: the fused form, persistent groups, threads over lattice columns ----

#define MVS_COL_PASS 8          // K4, run-time size: samples of a column per pass

// A group's member table for K4 in shared memory: per member its plane
// base (in ints), its last tap origins (w - 2, h - 2) as floats and its
// level width.
struct FusedMembers {
  int64_t* base;  // [G]
  float2* lim;    // [G]
  int* w;         // [G]
};

// the member table of the G windows whose raw parameters (laid out as
// copy_params lays them) are in `raw`; member m reads plane row
// idx[m] * ni + illum
__device__ __forceinline__ void resolve_fused(const int* raw, int G, const FusedMembers& t,
                                              const LevelMeta& meta, int total, int ni,
                                              int illum) {
  const int* idx = raw;
  const int* lvl = raw + G;
  for (int m = threadIdx.x; m < G; m += blockDim.x) {
    int off, w, h;
    level_meta(meta, clamp_level(lvl[m], meta.n), off, w, h);
    t.base[m] = (int64_t)(idx[m] * ni + illum) * total + off;
    t.lim[m] = make_float2((float)(w - 2), (float)(h - 2));
    t.w[m] = w;
  }
}

// K4's lattice columns: column c of a group is member m = c / ws,
// lattice column i = c - m * ws (samples s = j * ws + i, j = 0 .. ws - 1).
// A thread takes fused_cols columns at a time (MVS_FUSED_COLS at WS = 7;
// one at the run-time size, in passes of MVS_COL_PASS samples) and issues
// the tap loads of all of them before any of their tap arithmetic: two
// columns of 7 measured 0.93x (luma) and 0.96x (RGB) the time of one on
// an H100, three and four no better (PERF.md §6). The lanes of a warp hold
// neighbouring columns, so a load instruction of a warp reads neighbouring
// pixels of a few image rows.
#define MVS_FUSED_COLS 2

template <int WS>
__host__ __device__ constexpr int fused_cols() {
  return WS > 0 ? MVS_FUSED_COLS : 1;
}

// Samples j0 .. j0 + R - 1 (those below ws) of the columns c0 + q * T,
// q < ncol (ncol <= NCOL, T threads), into the stage. Per column the
// member's base, level size and six lattice floats are read once, and so
// is the column's partial sum a = tl + d1 * i; sample j lies at a + d2 *
// j, rounded as cuda_ncc.lattice rounds (tl + d1 * i) + d2 * j; no sample
// does an integer division. The tap word ly * w + lx comes from the origins'
// bits bx = 0x4B400000 + lx and by as by * w + bx - 0x4B400000 * (w +
// 1), in 32-bit arithmetic that wraps (exact, as the word fits an int).
// Every tap load of the columns is issued before any tap arithmetic,
// which is rgb_sample's and luma_sample's, in their order, with byte_f32
// for byte_at and without the RGB sums' leading 0 + (the first term is a
// product of nonnegative factors, or NaN, so adding it to 0 changes no
// bit).
template <int C, int WS, int ABL, int NCOL, int R>
__device__ __forceinline__ void sample_columns(const int* __restrict__ planes, const int* raw,
                                               int G, const FusedMembers& t, int c0, int ncol,
                                               int j0, int ws, float* st) {
  const int S = ws * ws;
  const float* f = reinterpret_cast<const float*>(raw);
  int v[NCOL][R][C == 3 ? 4 : 1];  // RGB: taps 00, 10, 01, 11; luma: the quad
  float ex[NCOL][R], ey[NCOL][R];  // dx1, dy1
  float* col[NCOL];
#pragma unroll
  for (int q = 0; q < NCOL; ++q) {
    if (q < ncol) {
      const int c = c0 + q * (int)blockDim.x;
      const int m = c / ws;  // once per column (a constant divisor where WS > 0)
      const int i = c - m * ws;
      const float2 tl = reinterpret_cast<const float2*>(f + 2 * G)[m];
      const float2 d1 = reinterpret_cast<const float2*>(f + 4 * G)[m];
      const float2 d2 = reinterpret_cast<const float2*>(f + 6 * G)[m];
      const int* pm = planes + t.base[m];
      const int w = t.w[m];
      const unsigned bias = 0x4B400000u * (unsigned)(w + 1);
      const float2 lim = t.lim[m];
      const float fi = ABL == ABL_NOWX ? 0.0f : (float)i;
      const float ax = __fadd_rn(tl.x, __fmul_rn(d1.x, fi));
      const float ay = __fadd_rn(tl.y, __fmul_rn(d1.y, fi));
      const float fj0 = (float)j0;  // a constant 0 where WS > 0
      col[q] = st + m * C * S + j0 * ws + i;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (WS > 0 || j0 + k < ws) {
          const float fj = ABL == ABL_NOWX ? 0.0f
                           : WS > 0       ? (float)k
                                          : __fadd_rn(fj0, (float)k);
          const float x = __fadd_rn(ax, __fmul_rn(d2.x, fj));
          const float y = __fadd_rn(ay, __fmul_rn(d2.y, fj));
          unsigned bx, by;
          ex[q][k] = clamp01(__fsub_rn(x, tap_origin(x, lim.x, bx)));
          ey[q][k] = clamp01(__fsub_rn(y, tap_origin(y, lim.y, by)));
          const int* p = pm + (int)(by * (unsigned)w + bx - bias);
          v[q][k][0] = tap<ABL>(p);
          if (C == 3) {
            v[q][k][1] = tap<ABL>(p + 1);
            v[q][k][2] = tap<ABL>(p + w);
            v[q][k][3] = tap<ABL>(p + w + 1);
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NCOL; ++q) {
    if (q < ncol) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (WS > 0 || j0 + k < ws) {
          float* o = col[q] + k * ws;
          const float dx1 = ex[q][k], dy1 = ey[q][k];
          const float dx0 = __fsub_rn(1.0f, dx1), dy0 = __fsub_rn(1.0f, dy1);
          if (C == 3) {
            if (ABL == ABL_NOCOMPUTE) {
#pragma unroll
              for (int c = 0; c < 3; ++c) o[c * S] = byte_f32(v[q][k][0], c);
            } else if (ABL == ABL_NOMM) {
#pragma unroll
              for (int c = 0; c < 3; ++c) {
                float a = byte_f32(v[q][k][0], c);
                a = __fadd_rn(a, byte_f32(v[q][k][1], c));
                a = __fadd_rn(a, byte_f32(v[q][k][2], c));
                o[c * S] = __fadd_rn(a, byte_f32(v[q][k][3], c));
              }
            } else {
              const float f00 = __fmul_rn(dx0, dy0), f10 = __fmul_rn(dx1, dy0);
              const float f01 = __fmul_rn(dx0, dy1), f11 = __fmul_rn(dx1, dy1);
#pragma unroll
              for (int c = 0; c < 3; ++c) {
                float a = __fmul_rn(byte_f32(v[q][k][0], c), f00);
                a = __fadd_rn(a, __fmul_rn(byte_f32(v[q][k][1], c), f10));
                a = __fadd_rn(a, __fmul_rn(byte_f32(v[q][k][2], c), f01));
                o[c * S] = __fadd_rn(a, __fmul_rn(byte_f32(v[q][k][3], c), f11));
              }
            }
          } else {
            const float y00 = byte_f32(v[q][k][0], 0);
            if (ABL == ABL_NOCOMPUTE) {
              *o = y00;
            } else {
              const float y10 = byte_f32(v[q][k][0], 1);
              const float y01 = byte_f32(v[q][k][0], 2);
              const float y11 = byte_f32(v[q][k][0], 3);
              if (ABL == ABL_NOMM) {
                *o = __fadd_rn(__fadd_rn(__fadd_rn(y00, y10), y01), y11);
              } else {
                float a = __fmul_rn(__fmul_rn(y00, dx0), dy0);
                a = __fadd_rn(a, __fmul_rn(__fmul_rn(y10, dx1), dy0));
                a = __fadd_rn(a, __fmul_rn(__fmul_rn(y01, dx0), dy1));
                *o = __fadd_rn(a, __fmul_rn(__fmul_rn(y11, dx1), dy1));
              }
            }
          }
        }
      }
    }
  }
}

// A group's G * ws columns into the stage, NCOL columns a thread at a
// time (columns c, c + T, ... for T threads), in passes of R samples
template <int C, int WS, int ABL>
__device__ __forceinline__ void sample_group(const int* __restrict__ planes, const int* raw,
                                             int G, const FusedMembers& t, int ws,
                                             float* st) {
  constexpr int NCOL = fused_cols<WS>();
  // RGB holds 4 tap words a sample, so its passes at the run-time size are
  // half as long
  constexpr int R = WS > 0 ? WS : (C == 3 ? MVS_COL_PASS / 2 : MVS_COL_PASS);
  const int cols = G * ws;
  const int T = blockDim.x;
  for (int c0 = threadIdx.x; c0 < cols; c0 += NCOL * T) {
    int ncol = 1;  // the columns c0 + q * T below cols
#pragma unroll
    for (int q = 1; q < NCOL; ++q) ncol += c0 + q * T < cols;
    for (int j0 = 0; j0 < ws; j0 += R)  // one pass where WS > 0
      sample_columns<C, WS, ABL, NCOL, R>(planes, raw, G, t, c0, ncol, j0, ws, st);
  }
}

// K4: persistent blocks, each walking the groups of G windows (B a
// multiple of G) with stride gridDim.x. Dynamic shared memory
// (plan_fused): `nstages` output stages of stage_floats floats, two raw
// parameter buffers (8 * G words each), then the member table. Per group:
// the next group's parameters are copied in with cp.async while this
// group samples (G * ws lattice columns, fused_cols<WS> a thread at a
// time; columns past the block's threads loop); the stage goes out as
// one TMA bulk store (tma) that overlaps the next group's work, or as
// coalesced float stores where a group's run is not 16-byte sized or
// aligned. The member table is rewritten for the next group only after
// the barrier that ends this group's sampling.
template <int C, int WS, int ABL>
__global__ void __launch_bounds__(MVS_THREADS)
fused_kernel(const int* __restrict__ planes, LevelMeta meta, int total, int ni, int illum,
             const int* __restrict__ idx, const int* __restrict__ lvl,
             const float* __restrict__ tl, const float* __restrict__ dx,
             const float* __restrict__ dy, float* __restrict__ out, int B, int wsize,
             int G, int stage_floats, int nstages, int tma, int vec16) {
  const int ws = WS > 0 ? WS : wsize;
  const int ngroups = B / G;
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  int* raw = reinterpret_cast<int*>(stage + nstages * stage_floats);
  FusedMembers t;
  t.base = reinterpret_cast<int64_t*>(raw + 16 * G);
  t.lim = reinterpret_cast<float2*>(t.base + G);
  t.w = reinterpret_cast<int*>(t.lim + G);
  const int run = G * C * ws * ws;  // floats per group

  int g = blockIdx.x;
  copy_params(raw, G, (int64_t)g * G, G, vec16, idx, lvl, tl, dx, dy);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  resolve_fused(raw, G, t, meta, total, ni, illum);
  for (int it = 0; g < ngroups; g += gridDim.x, ++it) {
    const int* cur = raw + (it & 1) * 8 * G;
    int* nxt = raw + ((it & 1) ^ 1) * 8 * G;
    const int next = g + gridDim.x;
    if (next < ngroups)
      copy_params(nxt, G, (int64_t)next * G, G, vec16, idx, lvl, tl, dx, dy);
    cp_async_commit();
    float* st = stage + (nstages == 2 ? it & 1 : 0) * stage_floats;
    if (tma && threadIdx.x == 0) {  // the store that last read `st` is done
      if (nstages == 2) bulk_wait_read<1>(); else bulk_wait_read<0>();
    }
    __syncthreads();  // members resolved, `st` free
    sample_group<C, WS, ABL>(planes, cur, G, t, ws, st);
    if (tma) fence_proxy_async();
    cp_async_wait_all();
    __syncthreads();  // stage complete, next parameters arrived
    float* gout = out + (int64_t)g * run;
    if (tma) {
      if (threadIdx.x == 0) bulk_store(gout, st, run * (int)sizeof(float));
    } else {
      for (int k = threadIdx.x; k < run; k += blockDim.x) gout[k] = st[k];
    }
    if (next < ngroups) resolve_fused(nxt, G, t, meta, total, ni, illum);
  }
  if (tma && threadIdx.x == 0) bulk_wait_all();
}

// the multiple of 32 in [lo, MVS_THREADS] that leaves the fewest idle
// threads in the last pass over n items (samples of the window kernel's
// tile, K4's lattice column sets), the largest of those that tie
static int group_threads(int n, int lo = 128) {
  int threads = MVS_THREADS, idle = INT_MAX;
  for (int t = MVS_THREADS; t >= lo; t -= 32) {
    const int w = (n + t - 1) / t * t - n;
    if (w < idle) { idle = w; threads = t; }
  }
  return threads;
}

struct Launch {
  const int* planes;
  LevelMeta meta;
  int total, ni, illum;
  const int* idx;
  const int* lvl;
  const float* tl;
  const float* dx;
  const float* dy;
  float* out;
  int B, wsize, group;
  cudaStream_t stream;
};

// ---- the window kernel's launch plan ----

struct Plan {
  int tile, grid, threads, smem, stages, tma, vec16, blocks_per_sm, sms, stage_floats;
};

// dynamic shared memory of a tile of G windows: `stages` output stages
// of (G * C * wsize^2 rounded up to 4) floats, two raw parameter buffers
// (32 B a member each) and the member table (base, width and height:
// 16 B a member; lattice sums: 16 B a member and lattice step)
static int tile_smem(int C, int G, int wsize, int stages) {
  const int stage_floats = (G * C * wsize * wsize + 3) & ~3;
  return stages * stage_floats * (int)sizeof(float) + 80 * G + 16 * G * wsize;
}

// The launch of window_kernel<C, WS, ABL> for B windows in tiles of G
// with `stages` output stages and `threads` per block (0: the multiple
// of 32 that leaves the fewest idle in a tile's last pass): the TMA
// store where a whole tile's run is a multiple of 16 bytes and the
// output 16-byte aligned; 16-byte parameter copies where G is a multiple
// of 4 and the parameter arrays 16-byte aligned; the persistent grid
// min(tiles, SMs x resident blocks per SM).
template <int C, int WS, int ABL>
static int plan_tiles(const DeviceInfo& d, int B, int wsize, int G, int stages,
                      int threads, bool out16, bool params16, Plan* p) {
  const int run = G * C * wsize * wsize;
  p->tile = G;
  p->stages = stages;
  p->stage_floats = (run + 3) & ~3;
  p->smem = tile_smem(C, G, wsize, stages);
  if (p->smem > d.optin) return (int)cudaErrorInvalidValue;
  p->threads = threads > 0 ? threads : group_threads(G * wsize * wsize);
  p->tma = run % 4 == 0 && out16;
  p->vec16 = G % 4 == 0 && params16;
  p->sms = d.sms;
  const void* fn = (const void*)window_kernel<C, WS, ABL>;
  int err = opt_in_smem(fn, d);
  if (err) return err;
  err = resident_blocks(fn, d.dev, p->threads, p->smem, &p->blocks_per_sm);
  if (err) return err;
  p->grid = (int)std::min(((int64_t)B + G - 1) / G, (int64_t)d.sms * p->blocks_per_sm);
  return 0;
}

// The grouped forms: tiles of `group` windows (B a multiple of it, group
// in [2, MVS_MAX_GROUP]), two output stages where they fit the card's
// shared memory, else one (a size the card refuses returns its error).
template <int C, int WS, int ABL>
static int plan_grouped(int B, int wsize, int group, bool out16, bool params16, Plan* p) {
  if (group < 2 || group > MVS_MAX_GROUP || B % group != 0 || wsize < 1)
    return (int)cudaErrorInvalidValue;
  DeviceInfo d;
  const int err = device_info(&d);
  if (err) return err;
  const int stages = tile_smem(C, group, wsize, 2) <= d.optin ? 2 : 1;
  return plan_tiles<C, WS, ABL>(d, B, wsize, group, stages, 0, out16, params16, p);
}

// The ungrouped forms (tiles of independent consecutive windows):
// MVS_THREADS per block, one output stage (a second one only cost
// resident blocks) and a tile of a fixed sample count, MVS_TILE_RGB or
// MVS_TILE_LUMA samples (40 RGB or 64 luma windows of 7 x 7), at most
// MVS_MAX_TILE windows and rounded down to a multiple of 4. Measured on
// an H100 (PERF.md §6): at the batches the paths give K1 (24,576 to
// 131,072 windows) the 40-window RGB tile is the fastest or within 3 %
// of it, and at K3u's (436,032 to 786,432) the 64-window luma tile is
// the fastest. Never refuses a window size: a tile of 4 fits the card
// at every size up to 15 x 15.
#define MVS_MAX_TILE 64
#define MVS_TILE_RGB 1960
#define MVS_TILE_LUMA 3136

template <int C, int WS, int ABL>
static int plan_ungrouped(int B, int wsize, bool out16, bool params16, Plan* p) {
  if (B < 1 || wsize < 1) return (int)cudaErrorInvalidValue;
  DeviceInfo d;
  const int err = device_info(&d);
  if (err) return err;
  const int samples = C == 3 ? MVS_TILE_RGB : MVS_TILE_LUMA;
  const int G = std::max(4, std::min(MVS_MAX_TILE, samples / (wsize * wsize)) & ~3);
  return plan_tiles<C, WS, ABL>(d, B, wsize, G, 1, MVS_THREADS, out16, params16, p);
}

// ---- K4's launch plan ----

// dynamic shared memory of K4 for groups of G windows: `stages` output
// stages of (G * C * wsize^2 rounded up to 4) floats, two raw parameter
// buffers (32 B a member each) and the member table (20 B a member)
static int fused_smem(int C, int G, int wsize, int stages) {
  const int stage_floats = (G * C * wsize * wsize + 3) & ~3;
  return stages * stage_floats * (int)sizeof(float) + 84 * G;
}

// The launch of fused_kernel<C, WS, ABL> for B windows in groups of
// `group` (B a multiple of it, group in [2, MVS_MAX_GROUP]): two output
// stages where they fit the card's shared memory, else one (a size the
// card refuses returns its error); the multiple of 32 in [32,
// MVS_THREADS] threads that leaves the fewest idle in a group's last pass
// over its group * wsize lattice columns, fused_cols<WS> a thread; the
// TMA store where
// a group's run is a multiple of 16 bytes and the output 16-byte aligned;
// 16-byte parameter copies where group is a multiple of 4 and the
// parameter arrays 16-byte aligned; the persistent grid min(groups, SMs
// x resident blocks per SM).
template <int C, int WS, int ABL>
static int plan_fused(int B, int wsize, int group, bool out16, bool params16, Plan* p) {
  if (group < 2 || group > MVS_MAX_GROUP || B % group != 0 || wsize < 1)
    return (int)cudaErrorInvalidValue;
  DeviceInfo d;
  int err = device_info(&d);
  if (err) return err;
  const int run = group * C * wsize * wsize;
  p->tile = group;
  p->stages = fused_smem(C, group, wsize, 2) <= d.optin ? 2 : 1;
  p->stage_floats = (run + 3) & ~3;
  p->smem = fused_smem(C, group, wsize, p->stages);
  if (p->smem > d.optin) return (int)cudaErrorInvalidValue;
  const int ncol = fused_cols<WS>();
  p->threads = group_threads((group * wsize + ncol - 1) / ncol, 32);
  p->tma = run % 4 == 0 && out16;
  p->vec16 = group % 4 == 0 && params16;
  p->sms = d.sms;
  const void* fn = (const void*)fused_kernel<C, WS, ABL>;
  err = opt_in_smem(fn, d);
  if (err) return err;
  err = resident_blocks(fn, d.dev, p->threads, p->smem, &p->blocks_per_sm);
  if (err) return err;
  p->grid = (int)std::min((int64_t)(B / group), (int64_t)d.sms * p->blocks_per_sm);
  return 0;
}

template <int C, int WS, int ABL>
static int launch_fused_ws(const Launch& a) {
  Plan p;
  const bool params16 = aligned16(a.idx) && aligned16(a.lvl) && aligned16(a.tl) &&
                        aligned16(a.dx) && aligned16(a.dy);
  const int err =
      plan_fused<C, WS, ABL>(a.B, a.wsize, a.group, aligned16(a.out), params16, &p);
  if (err) return err;
  fused_kernel<C, WS, ABL><<<p.grid, p.threads, p.smem, a.stream>>>(
      a.planes, a.meta, a.total, a.ni, a.illum, a.idx, a.lvl, a.tl, a.dx, a.dy, a.out,
      a.B, a.wsize, p.tile, p.stage_floats, p.stages, p.tma, p.vec16);
  return (int)cudaGetLastError();
}

// K4 at WS = 7 is compiled for its size; every other size runs WS = 0
template <int C, int ABL>
static int launch_fused(const Launch& a) {
  return a.wsize == 7 ? launch_fused_ws<C, 7, ABL>(a) : launch_fused_ws<C, 0, ABL>(a);
}

template <int C, int WS, int ABL>
static int launch_windows_ws(const Launch& a, bool grouped) {
  Plan p;
  const bool params16 = aligned16(a.idx) && aligned16(a.lvl) && aligned16(a.tl) &&
                        aligned16(a.dx) && aligned16(a.dy);
  const bool out16 = aligned16(a.out);
  const int err =
      grouped ? plan_grouped<C, WS, ABL>(a.B, a.wsize, a.group, out16, params16, &p)
              : plan_ungrouped<C, WS, ABL>(a.B, a.wsize, out16, params16, &p);
  if (err) return err;
  window_kernel<C, WS, ABL><<<p.grid, p.threads, p.smem, a.stream>>>(
      a.planes, a.meta, a.total, a.ni, a.illum, a.idx, a.lvl, a.tl, a.dx, a.dy, a.out,
      a.B, a.wsize, p.tile, p.stage_floats, p.stages, p.tma, p.vec16);
  return (int)cudaGetLastError();
}

// WS = 7 (MVSConfig.wsize's default) is compiled for its size; every
// other size runs the same code with wsize read at run time
template <int C, int ABL>
static int launch_windows(const Launch& a, bool grouped) {
  return a.wsize == 7 ? launch_windows_ws<C, 7, ABL>(a, grouped)
                      : launch_windows_ws<C, 0, ABL>(a, grouped);
}

static bool is_luma(int form) {
  return form == FORM_LUMA_UNGROUPED || form == FORM_LUMA_GROUPED ||
         form == FORM_LUMA_FUSED;
}

template <int ABL>
static int launch_form(int form, const Launch& a) {
  switch (form) {
    case FORM_UNGROUPED:
      return launch_windows<3, ABL>(a, false);
    case FORM_GROUPED:
      return launch_windows<3, ABL>(a, true);
    case FORM_LUMA_UNGROUPED:
      return launch_windows<1, ABL>(a, false);
    case FORM_LUMA_GROUPED:
      return launch_windows<1, ABL>(a, true);
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
// arrays, which are host arrays of n_levels ints. Window b reads plane
// row idx[b] * ni + illum. A batch whose output passes INT_MAX floats is
// refused. Returns cudaGetLastError() after the launch (0 for an empty
// batch).
static int launch(int form, const void* planes, int total, const int* lvl_off,
                  const int* lvl_w, const int* lvl_h, int n_levels, int ni, int illum,
                  const void* idx, const void* lvl, const void* tl, const void* dx,
                  const void* dy, void* out, int B, int wsize, int group, int ablate,
                  void* stream) {
  Launch a;
  int err = make_meta(&a.meta, lvl_off, lvl_w, lvl_h, n_levels);
  if (err) return err;
  if (B <= 0) return 0;
  if (wsize < 1 || (int64_t)B * (is_luma(form) ? 1 : 3) * wsize * wsize > INT_MAX)
    return (int)cudaErrorInvalidValue;
  a.planes = (const int*)planes;
  a.total = total;
  a.ni = ni;
  a.illum = illum;
  a.idx = (const int*)idx;
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

#define MVS_COMMON_PARAMS                                                      \
  const void *planes, int total, const int *lvl_off, const int *lvl_w,         \
      const int *lvl_h, int n_levels, int ni, int illum, const void *idx,      \
      const void *lvl, const void *tl, const void *dx, const void *dy,         \
      void *out, int B, int wsize
#define MVS_COMMON_ARGS                                                        \
  planes, total, lvl_off, lvl_w, lvl_h, n_levels, ni, illum, idx, lvl, tl, dx, \
      dy, out, B, wsize

// Every entry point: planes is the [n * ni, total] plane buffer (packed
// RGB, or luma quads); window b samples row idx[b] * ni + illum.

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

// Ungrouped luma launch (K3, group=1): planes is the luma-quad buffer;
// out is [B, wsize^2].
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
// store per group; the same rules on group.
extern "C" int mvs_sample_windows_fused(MVS_COMMON_PARAMS, int group,
                                        int ablate, void* stream) {
  return launch(FORM_FUSED, MVS_COMMON_ARGS, group, ablate, stream);
}

// Fused luma launch (K4 with rgb=False); the same rules on group.
extern "C" int mvs_sample_windows_luma_fused(MVS_COMMON_PARAMS, int group,
                                             int ablate, void* stream) {
  return launch(FORM_LUMA_FUSED, MVS_COMMON_ARGS, group, ablate, stream);
}

// The plan of the window kernel (FORM_UNGROUPED, FORM_GROUPED,
// FORM_LUMA_UNGROUPED, FORM_LUMA_GROUPED) or of K4 (FORM_FUSED,
// FORM_LUMA_FUSED) for B windows of wsize on the current device, with the
// wrapper's 16-byte aligned arrays (`group` for the grouped and fused
// forms): writes tile, grid, threads, dynamic shared memory bytes, output
// stages, TMA store (0/1), 16-byte parameter copies (0/1), resident
// blocks per SM, SM count and floats per stage into plan[0..9]. Returns
// the error the launch would return, else 0.
extern "C" int mvs_sample_windows_plan(int form, int B, int wsize, int group, int* plan) {
  Plan p;
  int err;
  const bool ws7 = wsize == 7;
  switch (form) {
    case FORM_UNGROUPED:
      err = ws7 ? plan_ungrouped<3, 7, ABL_NONE>(B, wsize, true, true, &p)
                : plan_ungrouped<3, 0, ABL_NONE>(B, wsize, true, true, &p);
      break;
    case FORM_GROUPED:
      err = ws7 ? plan_grouped<3, 7, ABL_NONE>(B, wsize, group, true, true, &p)
                : plan_grouped<3, 0, ABL_NONE>(B, wsize, group, true, true, &p);
      break;
    case FORM_LUMA_UNGROUPED:
      err = ws7 ? plan_ungrouped<1, 7, ABL_NONE>(B, wsize, true, true, &p)
                : plan_ungrouped<1, 0, ABL_NONE>(B, wsize, true, true, &p);
      break;
    case FORM_LUMA_GROUPED:
      err = ws7 ? plan_grouped<1, 7, ABL_NONE>(B, wsize, group, true, true, &p)
                : plan_grouped<1, 0, ABL_NONE>(B, wsize, group, true, true, &p);
      break;
    case FORM_FUSED:
      err = ws7 ? plan_fused<3, 7, ABL_NONE>(B, wsize, group, true, true, &p)
                : plan_fused<3, 0, ABL_NONE>(B, wsize, group, true, true, &p);
      break;
    case FORM_LUMA_FUSED:
      err = ws7 ? plan_fused<1, 7, ABL_NONE>(B, wsize, group, true, true, &p)
                : plan_fused<1, 0, ABL_NONE>(B, wsize, group, true, true, &p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  const int v[10] = {p.tile, p.grid, p.threads, p.smem, p.stages, p.tma, p.vec16,
                     p.blocks_per_sm, p.sms, p.stage_floats};
  for (int k = 0; k < 10; ++k) plan[k] = v[k];
  return 0;
}
