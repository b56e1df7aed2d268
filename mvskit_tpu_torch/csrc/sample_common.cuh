// Shared by the window sampler (sample_windows.cu) and its backward
// (sample_windows_grad.cu): the level table of a launch and the gather
// path's tap origin and fractions, each with the exact
// rounding of the plain PyTorch versions (ops/sampling.py); the exact
// conversions on the FP32 pipe (byte_f32, tap_origin); the asynchronous
// copies (cp.async, the TMA's 1-D bulk copies and their mbarrier) and a
// tile's parameter staging; and, on the host, the per-device and
// per-instance launch queries, cached.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <utility>

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

// Exact conversions on the FP32 pipe (K4 and the backward). A float in
// [2^23, 2^24) has an ulp of 1, so its low mantissa bits hold an integer.
#define MVS_TWO23 8388608.0f    // 2^23, bits 0x4B000000
#define MVS_MAGIC 12582912.0f   // 1.5 * 2^23, bits 0x4B400000

// byte k of v as a float: one PRMT puts the byte into the mantissa of
// 2^23 (bits 0x4B0000bb), and subtracting 2^23 leaves the byte exactly:
// byte_at's value without its shift, mask and I2F
__device__ __forceinline__ float byte_f32(int v, int k) {
  return __fsub_rn(__int_as_float(__byte_perm(v, 0x4B000000, 0x7440 + k)), MVS_TWO23);
}

// The tap origin of coordinate x on a level whose last origin is `lim`
// (w - 2 as a float): l = min(max(trunc(x), 0), w - 2), equal to
// bilinear_frac's for every float x (NaN and -inf give 0, +inf gives
// w - 2). The clamp runs in float first (fmaxf(NaN, 0) is 0, as
// __float2int_rz(NaN) is), so xc lies in [0, w - 2] and trunc(xc) =
// floor(xc); then t = xc + 1.5 * 2^23 rounded toward zero is 1.5 * 2^23 +
// floor(xc) for any xc in [-2^22, 2^22): t less 1.5 * 2^23 is l as a
// float (returned), and t's bits (`tb`) are 0x4B400000 + l. (1.5 * 2^23
// rather than 2^23 keeps a level narrower than 2 pixels exact too: there
// w - 2 < 0, and so is the plain version's origin.)
__device__ __forceinline__ float tap_origin(float x, float lim, unsigned& tb) {
  const float t = __fadd_rz(fminf(fmaxf(x, 0.0f), lim), MVS_MAGIC);
  tb = __float_as_uint(t);
  return __fsub_rn(t, MVS_MAGIC);
}

// ---- asynchronous copies ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// make this thread's shared-memory writes visible to the TMA (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA 1-D bulk store of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from shared to global memory, as one bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

// wait until at most N of this thread's bulk stores still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- the TMA's 1-D bulk copies into shared memory, on one mbarrier ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's arrival on `bar`, announcing `bytes` of bulk copies to it
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `phase` of `bar` has completed: its
// arrivals made and its bulk copies' bytes landed (and visible here)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  } while (!done);
}

// TMA 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- a tile's parameters ----

// windows of tile `tile`: G, or what is left of the batch
__device__ __forceinline__ int tile_members(int tile, int G, int B) {
  const int64_t left = (int64_t)B - (int64_t)tile * G;
  return left < G ? (int)left : G;
}

// A tile's raw parameters in shared memory, 8 * G words: idx [0, G),
// lvl [G, 2G), tl [2G, 4G), dx [4G, 6G), dy [6G, 8G). Word w of the
// tile that starts at window b0, in global memory:
__device__ __forceinline__ const int* param_word(
    int w, int G, int64_t b0, const int* __restrict__ idx, const int* __restrict__ lvl,
    const float* __restrict__ tl, const float* __restrict__ dx,
    const float* __restrict__ dy) {
  if (w < G) return idx + b0 + w;
  if (w < 2 * G) return lvl + b0 + (w - G);
  const int seg = (w - 2 * G) / (2 * G);
  const float* src = seg == 0 ? tl : (seg == 1 ? dx : dy);
  return reinterpret_cast<const int*>(src) + 2 * b0 + (w - 2 * G - seg * 2 * G);
}

// start the asynchronous copy of the parameters of the n windows from b0
// into `dst` (laid out for G): 16-byte cp.async where the tile is whole
// and every slice 16-byte aligned (vec16), else 4-byte, word by word of
// the n members only, so a ragged last tile reads nothing past the batch
__device__ __forceinline__ void copy_params(
    int* dst, int G, int64_t b0, int n, bool vec16, const int* __restrict__ idx,
    const int* __restrict__ lvl, const float* __restrict__ tl,
    const float* __restrict__ dx, const float* __restrict__ dy) {
  if (vec16 && n == G) {  // G % 4 == 0: no 4-word chunk straddles two slices
    for (int k = threadIdx.x; k < 2 * G; k += blockDim.x)
      cp_async16(dst + 4 * k, param_word(4 * k, G, b0, idx, lvl, tl, dx, dy));
  } else {
    // the n members' words: idx [0, n), lvl [n, 2n), then 2n each of
    // tl, dx and dy; w is the word's place in the G layout
    for (int k = threadIdx.x; k < 8 * n; k += blockDim.x) {
      int w = k;
      if (k >= 2 * n) {
        const int seg = (k - 2 * n) / (2 * n);
        w = 2 * G + seg * 2 * G + (k - 2 * n - seg * 2 * n);
      } else if (k >= n) {
        w = G + (k - n);
      }
      cp_async4(dst + w, param_word(w, G, b0, idx, lvl, tl, dx, dy));
    }
  }
}

// ---- host: launch queries ----

// the device's SM count and opt-in shared-memory limit per block, and
// per kernel instance its opt-in and its resident blocks per SM for a
// block size and shared memory, each queried once and cached
struct DeviceInfo { int dev, sms, optin; };

static std::mutex g_cache_lock;
static std::map<int, DeviceInfo> g_devices;
static std::set<std::pair<const void*, int>> g_optins;
static std::map<std::tuple<const void*, int, int, int>, int> g_occupancy;

static inline int device_info(DeviceInfo* out) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> hold(g_cache_lock);
  auto it = g_devices.find(dev);
  if (it != g_devices.end()) { *out = it->second; return 0; }
  DeviceInfo d{dev, 0, 0};
  err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  g_devices[dev] = d;
  *out = d;
  return 0;
}

// allow `fn` the card's whole dynamic shared memory per block (above
// 48 KB only by opt-in), once per instance and device
static inline int opt_in_smem(const void* fn, const DeviceInfo& d) {
  std::lock_guard<std::mutex> hold(g_cache_lock);
  if (g_optins.count({fn, d.dev})) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, d.optin);
  if (err != cudaSuccess) {
    cudaGetLastError();  // consume it: the next launch's check reads it
    return (int)err;
  }
  g_optins.insert({fn, d.dev});
  return 0;
}

static inline int resident_blocks(const void* fn, int dev, int threads, int smem, int* blocks) {
  std::lock_guard<std::mutex> hold(g_cache_lock);
  const auto key = std::make_tuple(fn, dev, threads, smem);
  auto it = g_occupancy.find(key);
  if (it != g_occupancy.end()) { *blocks = it->second; return 0; }
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (*blocks < 1) return (int)cudaErrorLaunchOutOfResources;
  g_occupancy[key] = *blocks;
  return 0;
}

static inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }
