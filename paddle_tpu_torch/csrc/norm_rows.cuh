// Parts shared by the RMSNorm and LayerNorm kernels (rms_norm.cu,
// layer_norm.cu): element conversions, 16-byte vectors, the register-row
// design of the forwards and that of the backwards (at the end).
//
// The register-row design. A row of h elements is nvec = h / V vectors of
// 16 bytes (V = 4 for f32, 8 for bf16 and f16). It is spread over the TPR =
// 32 * WPR lanes of WPR warps: lane t holds vectors t, t + TPR, t + 2 TPR,
// ... (NV slots, the ones past nvec masked), so neighbouring lanes read
// neighbouring addresses and no lane holds more than one vector more than
// another. Each lane loads its vectors once into registers, raw; every
// statistic and the output come from those registers, so device memory is
// read once and written once. w (and b) are loaded the same way by each
// row's lanes (from L2, or L1 for the block's other rows). A row's sums go
// through warp shuffles; with WPR > 1 each warp then leaves its sum in
// shared memory and the row's warps alone meet at a named barrier (no
// __syncthreads): the sum over the warps is taken in warp order, so it is
// the same on every run. (WPR, NV) come from the caller
// (`ops.norm_kernels.row_class`); the entries refuse a pair that does not
// cover the row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// VEC elements of T make one 16-byte access
template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

// the f32 values of a raw 16-byte vector of T
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* f) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) f[i] = to_f(e[i]);
}

// f32 values rounded to T, as one raw 16-byte vector
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) e[i] = from_f<T>(f[i]);
  return raw;
}

// one 16-byte load into a register copy (unpacking through a reference
// to memory would load the elements one by one)
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  unpack<T>(raw, f);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = pack<T>(f);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// -- the register-row design --------------------------------------------------

// threads a block launches at most: four warps' worth of rows (a row a warp
// at WPR 1, two rows at WPR 2, one at WPR 4, the widest class); the shared
// scratch of the row sums holds one float a warp
constexpr int kRowBlock = 128;

// lane t's NV vectors of a row that starts at p; a masked slot holds zeros
template <int NV, int TPR>
__device__ __forceinline__ void load_row(uint4 (&v)[NV],
                                         const uint4* __restrict__ p, int t,
                                         int nvec) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = j * TPR + t;
    v[j] = i < nvec ? __ldg(p + i) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// An empty asm that claims to change v: the compiler keeps the raw vectors
// in registers and unpacks them where they are used, rather than holding
// their f32 values (twice the registers for bf16 / f16) across a
// reduction (close to half the registers for bf16 rows); the registers
// saved are blocks on the SM, and bytes in flight.
template <int NV>
__device__ __forceinline__ void keep_raw(uint4 (&v)[NV]) {
#pragma unroll
  for (int j = 0; j < NV; ++j)
    asm volatile("" : "+r"(v[j].x), "+r"(v[j].y), "+r"(v[j].z), "+r"(v[j].w));
}

// the row's sum of v, in every lane of the row's WPR warps; `red` holds
// kRowBlock / 32 floats of shared scratch, one use per row.
template <int WPR>
__device__ __forceinline__ float row_sum(float v, float* red, int group) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if constexpr (WPR == 1) {
    return v;
  } else {
    const int warp = (threadIdx.x >> 5) % WPR;
    if ((threadIdx.x & 31) == 0) red[group * WPR + warp] = v;
    // barrier 1 + group: only this row's 32 * WPR threads meet there
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(32 * WPR)
                 : "memory");
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < WPR; ++i) s += red[group * WPR + i];
    return s;
  }
}

struct RowGrid {
  int blocks, threads;
};

// The launch shape of a register-row kernel over n rows: every row group
// a block of its own, the hardware handing the next block to whichever SM
// frees a slot. Rows share a block of kRowBlock threads, unless the rows
// would then not fill the SMs (the decode step's 8 rows): then each row
// gets a block of its own, 8 blocks on 8 SMs rather than 4 blocks of two
// rows. (Fewer blocks walking the rows in a grid-stride loop, w and b held
// across their rows, measured slower on the H100 at every main-path
// shape: the SMs' slots empty out before the loop ends.)
template <int WPR>
RowGrid row_grid(int n, int sms) {
  int groups = kRowBlock / (32 * WPR);
  if ((n + groups - 1) / groups < sms) groups = 1;
  return {(n + groups - 1) / groups, 32 * WPR * groups};
}

inline int sm_count(int device) {
  static int cache[64];  // 0: not read yet
  int v = 0;
  if (device >= 0 && device < 64 && cache[device]) return cache[device];
  cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device);
  if (device >= 0 && device < 64) cache[device] = v;
  return v > 0 ? v : 1;
}

// -- the register-row backward ------------------------------------------------
//
// dx of a row needs two row means (one for RMSNorm) of products of x, g and
// w; dw (and db) need sums over all rows. The design:
// - A row group (WPR warps, the lanes mapped onto the row's vectors as in
//   the forward) walks a fixed, contiguous range of rows, so its lanes'
//   columns are the same on every row: w is loaded into registers once,
//   and each lane keeps its columns' dw (and db) partials in f32 registers
//   across all its rows. x and g of a row are loaded once, raw, into
//   registers; both means, dx and the row's share of dw / db come from
//   them, so device memory is read once and dx written once.
// - The row sums go through shuffles and, past one warp a row, one named
//   barrier among the row's warps (double-buffered shared scratch, the
//   buffers taken by turns row after row): no block barrier a row.
// - The grid is one wave sized to the card: the blocks the SM holds at
//   once (occupancy, at most kBwdMaxBlocksPerSm) times the SMs. At the
//   end a block's row groups add their partials into shared memory in
//   group order, and the block writes one f32 partial row (a plane each
//   for dw and db).
// - A second kernel (`norm_cols_sum`) adds the partial rows, 32 columns a
//   block: warp k of the block sums rows k, k + kSumWarps, ..., then warp
//   0 adds the warps' sums in warp order. Every order is fixed by (n, h,
//   the grid): dw and db are the same bitwise run to run on one card, with
//   no state kept between calls.
// - The row group loads its next row (x, g and the statistics) into a
//   second register set while it computes the current one: measured on
//   the H100 at every main-path shape, as fast or faster than loading
//   each row when its turn comes (up to 13% at LayerNorm's (4096, 3584)
//   bf16), though it holds twice the rows' registers.

// threads a backward block launches (its row groups: 256 / (32 WPR))
constexpr int kBwdBlock = 256;
// blocks an SM at most: the partial rows the caller provides an SM
constexpr int kBwdMaxBlocksPerSm = 8;
// warps of a column-sum block, and its columns
constexpr int kSumWarps = 16;
constexpr int kSumCols = 32;

// the K sums of a row, in every lane of the row's WPR warps; `red` holds
// 2 x K x (kBwdBlock / 32) floats of shared scratch, half `turn` used (a
// row group takes the halves by turns, row after row: a warp that writes
// the next row's sums never overwrites ones a slower warp of its row still
// reads, since it has passed a barrier that warp reaches only after its
// read)
template <int WPR, int K>
__device__ __forceinline__ void row_sums(float (&v)[K], float* red,
                                         int group, int turn) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  if constexpr (WPR > 1) {
    constexpr int W = kBwdBlock / 32;
    float* r = red + turn * K * W + group * WPR;
    const int warp = (threadIdx.x >> 5) % WPR;
    if ((threadIdx.x & 31) == 0)
#pragma unroll
      for (int k = 0; k < K; ++k) r[k * W + warp] = v[k];
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(32 * WPR)
                 : "memory");
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < WPR; ++i) s += r[k * W + i];
      v[k] = s;
    }
  }
}

// The backward of RMSNorm (LN false: mean unused, dx = r (wg - xh m2)) or
// LayerNorm (LN: dx = r (wg - m1 - xh m2), db too) over n rows of h: xh =
// (x - mu) r, wg = w g, m1 = mean(wg), m2 = mean(wg xh); dw = sum g xh, db =
// sum g. part: a plane of part_rows x h f32 for dw (then one for db); block
// b writes row b of each.
template <typename T, int WPR, int NV, bool LN>
__device__ __forceinline__ void norm_bwd_rows(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
    int part_rows, int n, int h) {
  constexpr int V = Vec<T>::n, TPR = 32 * WPR, K = LN ? 2 : 1;
  extern __shared__ float4 cols4[];  // [K][h] f32: the block's partial rows
  float* const cols = reinterpret_cast<float*>(cols4);
  __shared__ float red[2 * K * (kBwdBlock / 32)];
  const int groups = blockDim.x / TPR;
  const int group = threadIdx.x / TPR, t = threadIdx.x % TPR;
  const long long ng = static_cast<long long>(gridDim.x) * groups;
  const long long gi = static_cast<long long>(blockIdx.x) * groups + group;
  const int r0 = static_cast<int>(n * gi / ng);
  const int r1 = static_cast<int>(n * (gi + 1) / ng);
  const int nvec = h / V;
  const uint4* xs = reinterpret_cast<const uint4*>(x);
  const uint4* gs = reinterpret_cast<const uint4*>(g);
  uint4* dxs = reinterpret_cast<uint4*>(dx);
  uint4 wv[NV];
  load_row<NV, TPR>(wv, reinterpret_cast<const uint4*>(w), t, nvec);
  keep_raw(wv);
  float dw[NV * V], db[LN ? NV * V : 1];
#pragma unroll
  for (int i = 0; i < NV * V; ++i) {
    dw[i] = 0.f;
    if constexpr (LN) db[i] = 0.f;
  }
  uint4 xv[NV], gv[NV];
  float r = 0.f, mu = 0.f;
  if (r0 < r1) {
    load_row<NV, TPR>(xv, xs + size_t(r0) * nvec, t, nvec);
    load_row<NV, TPR>(gv, gs + size_t(r0) * nvec, t, nvec);
    r = rstd[r0];
    if constexpr (LN) mu = mean[r0];
  }
  for (int row = r0; row < r1; ++row) {
    // the next row, in flight while this one is computed
    uint4 xn[NV], gn[NV];
    float rn = 0.f, mun = 0.f;
    if (row + 1 < r1) {
      load_row<NV, TPR>(xn, xs + size_t(row + 1) * nvec, t, nvec);
      load_row<NV, TPR>(gn, gs + size_t(row + 1) * nvec, t, nvec);
      rn = rstd[row + 1];
      if constexpr (LN) mun = mean[row + 1];
    }
    // the row's sums of wg (LayerNorm) and wg xh: masked slots hold zero g
    // and add nothing
    float s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float xf[V], gf[V], wf[V];
      unpack<T>(xv[j], xf);
      unpack<T>(gv[j], gf);
      unpack<T>(wv[j], wf);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float wg = gf[e] * wf[e];
        const float xh = (xf[e] - mu) * r;
        if constexpr (LN) {
          s[0] += wg;
          s[1] += wg * xh;
        } else {
          s[0] += wg * xh;
        }
      }
    }
    keep_raw(xv);
    keep_raw(gv);
    row_sums<WPR, K>(s, red, group, row & 1);
    const float m1 = LN ? s[0] / h : 0.f, m2 = s[K - 1] / h;
    uint4* orow = dxs + size_t(row) * nvec;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (j * TPR + t >= nvec) continue;
      float xf[V], gf[V], wf[V], of[V];
      unpack<T>(xv[j], xf);
      unpack<T>(gv[j], gf);
      unpack<T>(wv[j], wf);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xh = (xf[e] - mu) * r;
        of[e] = r * (gf[e] * wf[e] - m1 - xh * m2);
        dw[j * V + e] += gf[e] * xh;
        if constexpr (LN) db[j * V + e] += gf[e];
      }
      orow[j * TPR + t] = pack<T>(of);
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      xv[j] = xn[j];
      gv[j] = gn[j];
    }
    r = rn;
    mu = mun;
  }
  // no partials asked for (a LayerNorm without an affine: dw and db of
  // constants); the test is the same in every thread of the block
  if (part == nullptr) return;
  // the block's partial rows: its row groups add theirs in group order
  for (int k = 0; k < groups; ++k) {
    if (group == k) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (j * TPR + t >= nvec) continue;
        float4* c = cols4 + (j * TPR + t) * V / 4;
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const float* a = dw + j * V + 4 * q;
          float4 v = k ? c[q] : make_float4(0.f, 0.f, 0.f, 0.f);
          c[q] = make_float4(v.x + a[0], v.y + a[1], v.z + a[2], v.w + a[3]);
          if constexpr (LN) {
            float4* cb = c + h / 4;
            const float* bsum = db + j * V + 4 * q;
            float4 u = k ? cb[q] : make_float4(0.f, 0.f, 0.f, 0.f);
            cb[q] = make_float4(u.x + bsum[0], u.y + bsum[1], u.z + bsum[2],
                                u.w + bsum[3]);
          }
        }
      }
    }
    __syncthreads();
  }
  const size_t plane = size_t(part_rows) * h;
  float* out = part + size_t(blockIdx.x) * h;
  for (int c = threadIdx.x; c < h; c += blockDim.x) {
    out[c] = cols[c];
    if constexpr (LN) out[plane + c] = cols[h + c];
  }
}

// out_k[c] = sum over the nb partial rows of plane k, column c, in a fixed
// order (warp i sums rows i, i + kSumWarps, ...; then the warps in order),
// cast to T; K planes part_rows x h apart (dw, then db)
template <typename T, int K>
__device__ __forceinline__ void norm_cols_sum(const float* __restrict__ part,
                                              int nb, int part_rows, int h,
                                              T* __restrict__ out0,
                                              T* __restrict__ out1) {
  __shared__ float s[K][kSumWarps][kSumCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kSumCols + lane;
  const size_t plane = size_t(part_rows) * h;
  float a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) a[k] = 0.f;
  if (c < h) {
#pragma unroll 4
    for (int b = warp; b < nb; b += kSumWarps)
#pragma unroll
      for (int k = 0; k < K; ++k) a[k] += part[k * plane + size_t(b) * h + c];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) s[k][warp][lane] = a[k];
  __syncthreads();
  if (warp == 0 && c < h) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < kSumWarps; ++i) v += s[k][i][lane];
      (k == 0 ? out0 : out1)[c] = from_f<T>(v);
    }
  }
}

// The kernels, named apart for RMSNorm and LayerNorm so that a profile
// tells them apart: the row kernels (rms_norm_bwd_rows,
// layer_norm_bwd_rows) and the column sums (rms_norm_dw_sum,
// layer_norm_dwdb_sum).
template <typename T, int WPR, int NV>
__global__ void __launch_bounds__(kBwdBlock)
rms_norm_bwd_rows(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, const T* __restrict__ g,
                  T* __restrict__ dx, float* __restrict__ part, int part_rows,
                  int n, int h) {
  norm_bwd_rows<T, WPR, NV, false>(x, w, mean, rstd, g, dx, part,
                                   part_rows, n, h);
}

template <typename T, int WPR, int NV>
__global__ void __launch_bounds__(kBwdBlock)
layer_norm_bwd_rows(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd, const T* __restrict__ g,
                    T* __restrict__ dx, float* __restrict__ part,
                    int part_rows, int n, int h) {
  norm_bwd_rows<T, WPR, NV, true>(x, w, mean, rstd, g, dx, part,
                                  part_rows, n, h);
}

template <typename T>
__global__ void __launch_bounds__(32 * kSumWarps)
rms_norm_dw_sum(const float* __restrict__ part, int nb, int part_rows, int h,
                T* __restrict__ dw, T* __restrict__ unused) {
  norm_cols_sum<T, 1>(part, nb, part_rows, h, dw, unused);
}

template <typename T>
__global__ void __launch_bounds__(32 * kSumWarps)
layer_norm_dwdb_sum(const float* __restrict__ part, int nb, int part_rows,
                    int h, T* __restrict__ dw, T* __restrict__ db) {
  norm_cols_sum<T, 2>(part, nb, part_rows, h, dw, db);
}

// the row kernel and the column-sum kernel of RMSNorm (LN false) or
// LayerNorm; only the one asked for is instantiated
template <typename T, int WPR, int NV, bool LN>
constexpr auto bwd_rows_kernel() {
  if constexpr (LN)
    return layer_norm_bwd_rows<T, WPR, NV>;
  else
    return rms_norm_bwd_rows<T, WPR, NV>;
}

template <typename T, bool LN>
constexpr auto cols_sum_kernel() {
  if constexpr (LN)
    return layer_norm_dwdb_sum<T>;
  else
    return rms_norm_dw_sum<T>;
}

// The launch of the register-row backward: the row kernel over one wave of
// blocks, then the column sums. Rows share a block of kBwdBlock threads,
// unless the rows would then not fill the SMs: then a row group a block.
template <typename T, int WPR, int NV, bool LN>
cudaError_t launch_bwd_rows(const void* x, const void* w, const float* mean,
                            const float* rstd, const void* g, void* dx,
                            float* part, int part_rows, void* dw, void* db,
                            int n, int h, int device, cudaStream_t s) {
  constexpr int TPR = 32 * WPR, K = LN ? 2 : 1;
  auto kernel = bwd_rows_kernel<T, WPR, NV, LN>();
  const int sms = sm_count(device);
  int groups = kBwdBlock / TPR;
  if ((n + groups - 1) / groups < sms) groups = 1;
  const int threads = TPR * groups;
  const size_t smem = K * sizeof(float) * size_t(h);
  cudaError_t err = cudaSuccess;
  // past 48 KB of shared memory in all (the static row-sum scratch too),
  // the kernel must opt in
  if (smem + sizeof(float) * 2 * K * (kBwdBlock / 32) > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  occ = occ < 1 ? 1 : (occ > kBwdMaxBlocksPerSm ? kBwdMaxBlocksPerSm : occ);
  int blocks = (n + groups - 1) / groups;
  if (blocks > occ * sms) blocks = occ * sms;
  if (blocks > part_rows) blocks = part_rows;
  kernel<<<blocks, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), mean, rstd,
      static_cast<const T*>(g), static_cast<T*>(dx), part, part_rows, n, h);
  err = cudaGetLastError();
  if (err != cudaSuccess || dw == nullptr) return err;
  cols_sum_kernel<T, LN>()<<<(h + kSumCols - 1) / kSumCols, 32 * kSumWarps,
                             0, s>>>(part, blocks, part_rows, h,
                                     static_cast<T*>(dw),
                                     static_cast<T*>(db));
  return cudaGetLastError();
}

#define PDT_BWD_ROWS(N)                                                    \
  case N:                                                                  \
    return launch_bwd_rows<T, WPR, N, LN>(x, w, mean, rstd, g, dx, part,   \
                                          part_rows, dw, db, n, h, device, \
                                          s)

// the instance of (WPR, nv): nv 1-4 at one warp a row, 3-4 past it (the
// classes `ops.norm_kernels.bwd_row_class` gives)
template <typename T, bool LN, int WPR>
cudaError_t bwd_rows_nv(int nv, const void* x, const void* w,
                        const float* mean, const float* rstd, const void* g,
                        void* dx, float* part, int part_rows, void* dw,
                        void* db, int n, int h, int device, cudaStream_t s) {
  if constexpr (WPR == 1) {
    switch (nv) {
      PDT_BWD_ROWS(1);
      PDT_BWD_ROWS(2);
      default: break;
    }
  }
  switch (nv) {
    PDT_BWD_ROWS(3);
    PDT_BWD_ROWS(4);
    default: return cudaErrorInvalidValue;
  }
}

#undef PDT_BWD_ROWS

// the register-row backward of class (wpr, nv), which must cover the row's
// whole 16-byte vectors at 16-byte-aligned pointers; part holds K planes of
// part_rows x h f32 (part_rows >= 1), or part and dw are both null for dx
// alone (no partial rows written, no column sums launched)
template <typename T, bool LN>
cudaError_t launch_bwd_registers(const void* x, const void* w,
                                 const float* mean, const float* rstd,
                                 const void* g, void* dx, float* part,
                                 int part_rows, void* dw, void* db, int n,
                                 int h, int wpr, int nv, int device,
                                 cudaStream_t s) {
  constexpr int V = Vec<T>::n;
  if (h % V != 0 || h / V > 32 * wpr * nv || part_rows < 1 ||
      !aligned16(x) || !aligned16(w) || !aligned16(g) || !aligned16(dx))
    return cudaErrorInvalidValue;
  switch (wpr) {
#define PDT_BWD_WPR(W)                                                      \
  case W:                                                                   \
    return bwd_rows_nv<T, LN, W>(nv, x, w, mean, rstd, g, dx, part,         \
                                 part_rows, dw, db, n, h, device, s)
    PDT_BWD_WPR(1);
    PDT_BWD_WPR(2);
    PDT_BWD_WPR(4);
    PDT_BWD_WPR(8);
#undef PDT_BWD_WPR
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
