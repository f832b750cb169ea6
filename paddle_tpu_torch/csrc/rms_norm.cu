// RMSNorm for Hopper (sm_90a). Forward: o = x * rsqrt(mean(x^2) + eps) * w,
// computed in f32 in that order and stored in x's type, plus rstd as an
// (n,) f32 output. Backward: dx = rstd * (w*g - xhat * mean(w*g * xhat))
// with xhat = x * rstd, stored in x's type, and dw = sum over rows of g *
// xhat in f32, cast to w's type.
//
// Replaces: paddle_tpu/ops/norm_kernels.py:_rms_fwd_kernel (:45, launched
// by _rms_fwd, pallas_call at :75) and _rms_bwd_kernel (:53, launched by
// _rms_bwd_rule, pallas_call at :106).
//
// What bounds them on this card: bytes. The forward reads x and w and
// writes o and rstd, at about 4 operations per element. At the decode
// shape of the serving path (8 rows x 4096) the bytes take 0.04 us, so each
// of the 2L+1 launches per dispatch is bound by the launch and one trip to
// memory. At admission and in training (thousands of rows) it is bound by
// device-memory bandwidth. The backward reads x and g and writes dx, about
// 10 operations per element: bytes again.
//
// Two forward designs, picked by `ops.norm_kernels.norm_design`:
// - "registers" (rms_norm_fwd_rows, the register-row design of
//   norm_rows.cuh): the row in registers, device memory read once, a warp
//   or a few warps a row (a block holds up to four warps' rows, a row a
//   block when the rows do not fill the SMs), the sum of squares in
//   shuffles (plus one shared-memory step between the warps of a row). For
//   rows of whole 16-byte vectors, 16-byte-aligned, up to 4 warps x 8
//   vectors a lane (4096 f32, 8192 bf16 / f16 elements).
// - "strided" (rms_norm_fwd_kernel): one block of 256 threads a row, a
//   strided loop over the row, read twice (the second read from L1/L2),
//   one block reduction; it takes every row, vectorised where it can.
//
// dw needs a sum over all rows, which the TPU kernel carried from one grid
// step to the next in a revisited output block; here blocks run in
// parallel, so each block writes f32 partial sums of its rows and a second
// kernel adds them in a fixed order (no atomics): dw is the same bitwise
// run to run. Two backward designs, picked by
// `ops.norm_kernels.norm_bwd_design`:
// - "registers" (norm_bwd_rows and norm_cols_sum, the register-row
//   backward of norm_rows.cuh): x and g read once into registers, a warp
//   or a few warps a row with no block barrier a row, persistent row
//   groups keeping w and their dw partials in registers, one partial row
//   a block, the column sums spread over h / 32 blocks. For rows of whole
//   16-byte vectors, 16-byte-aligned, up to 8 warps x 4 vectors a lane
//   (4096 f32, 8192 bf16 / f16 elements).
// - "rowblock" (rms_norm_bwd_kernel, rms_norm_dw_kernel): one block of 256
//   threads per 16 rows, a row at a time behind block barriers, x and g
//   read twice, a partial row per block summed by one thread a column; it
//   takes every row up to 49152 elements.
//
// C interface: pointers are device pointers on the caller's current stream;
// each function returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "norm_rows.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ o, float* __restrict__ rstd, int h,
                    float eps) {
  __shared__ float red[kThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * h;
  T* orow = o + row * h;
  constexpr int V = Vec<T>::n;
  float ss = 0.f;
  if (kVec) {
    float f[V];
    for (int i = threadIdx.x * V; i < h; i += kThreads * V) {
      load_vec(xr + i, f);
#pragma unroll
      for (int j = 0; j < V; ++j) ss += f[j] * f[j];
    }
  } else {
    for (int i = threadIdx.x; i < h; i += kThreads) {
      const float v = to_f(xr[i]);
      ss += v * v;
    }
  }
  const float r = rsqrtf(block_sum(ss, red) / h + eps);
  if (kVec) {
    float f[V], g[V];
    for (int i = threadIdx.x * V; i < h; i += kThreads * V) {
      load_vec(xr + i, f);
      load_vec(w + i, g);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = f[j] * r * g[j];
      store_vec(orow + i, f);
    }
  } else {
    for (int i = threadIdx.x; i < h; i += kThreads)
      orow[i] = from_f<T>(to_f(xr[i]) * r * to_f(w[i]));
  }
  if (threadIdx.x == 0 && rstd != nullptr) rstd[row] = r;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* o, float* rstd, int n,
                   int h, float eps, cudaStream_t stream) {
  constexpr int V = Vec<T>::n;
  const bool vec = h % V == 0 &&
                   (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(o) % 16) == 0;
  if (vec)
    rms_norm_fwd_kernel<T, true><<<n, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(o), rstd, h, eps);
  else
    rms_norm_fwd_kernel<T, false><<<n, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(o), rstd, h, eps);
  return cudaGetLastError();
}

// The register-row forward (norm_rows.cuh): lane t of a row's TPR lanes
// holds its NV vectors of x and of w in registers, raw.
template <typename T, int WPR, int NV>
__global__ void __launch_bounds__(kRowBlock)
rms_norm_fwd_rows(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ o, float* __restrict__ rstd, int n, int h,
                  float eps) {
  constexpr int V = Vec<T>::n, TPR = 32 * WPR;
  __shared__ float red[kRowBlock / 32];
  const int groups = blockDim.x / TPR;
  const int group = threadIdx.x / TPR, t = threadIdx.x % TPR;
  const int row = blockIdx.x * groups + group;
  if (row >= n) return;  // the row's warps leave together
  const int nvec = h / V;
  const size_t base = size_t(row) * nvec;
  uint4 xv[NV], wv[NV];
  load_row<NV, TPR>(xv, reinterpret_cast<const uint4*>(x) + base, t, nvec);
  load_row<NV, TPR>(wv, reinterpret_cast<const uint4*>(w), t, nvec);
  keep_raw(wv);
  // masked slots hold zeros and add nothing
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float f[V];
    unpack<T>(xv[j], f);
#pragma unroll
    for (int e = 0; e < V; ++e) ss += f[e] * f[e];
  }
  keep_raw(xv);
  const float r = rsqrtf(row_sum<WPR>(ss, red, group) / h + eps);
  uint4* orow = reinterpret_cast<uint4*>(o) + base;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (j * TPR + t >= nvec) continue;
    float f[V], g[V];
    unpack<T>(xv[j], f);
    unpack<T>(wv[j], g);
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = f[e] * r * g[e];
    orow[j * TPR + t] = pack<T>(f);
  }
  if (t == 0 && rstd != nullptr) rstd[row] = r;
}

template <typename T, int WPR, int NV>
cudaError_t launch_rows(const void* x, const void* w, void* o, float* rstd,
                        int n, int h, float eps, int device,
                        cudaStream_t stream) {
  auto kernel = rms_norm_fwd_rows<T, WPR, NV>;
  const RowGrid g = row_grid<WPR>(n, sm_count(device));
  kernel<<<g.blocks, g.threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(o),
      rstd, n, h, eps);
  return cudaGetLastError();
}

#define PDT_RMS_ROWS(N) \
  case N: return launch_rows<T, WPR, N>(x, w, o, rstd, n, h, eps, device, s)

// the instance of (WPR, nv): nv 1-8 at one warp a row, 5-8 past it (the
// classes `ops.norm_kernels.row_class` gives)
template <typename T, int WPR>
cudaError_t rows_nv(int nv, const void* x, const void* w, void* o,
                    float* rstd, int n, int h, float eps, int device,
                    cudaStream_t s) {
  if constexpr (WPR == 1) {
    switch (nv) {
      PDT_RMS_ROWS(1);
      PDT_RMS_ROWS(2);
      PDT_RMS_ROWS(3);
      PDT_RMS_ROWS(4);
      default: break;
    }
  }
  switch (nv) {
    PDT_RMS_ROWS(5);
    PDT_RMS_ROWS(6);
    PDT_RMS_ROWS(7);
    PDT_RMS_ROWS(8);
    default: return cudaErrorInvalidValue;
  }
}

#undef PDT_RMS_ROWS

// wpr 0: the strided design; else the register-row class (wpr, nv), which
// must cover the row's vectors
template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, void* o, float* rstd,
                       int n, int h, float eps, int wpr, int nv, int device,
                       cudaStream_t s) {
  if (wpr == 0) return launch<T>(x, w, o, rstd, n, h, eps, s);
  constexpr int V = Vec<T>::n;
  if (h % V != 0 || h / V > 32 * wpr * nv || !aligned16(x) || !aligned16(w) ||
      !aligned16(o))
    return cudaErrorInvalidValue;
  switch (wpr) {
    case 1: return rows_nv<T, 1>(nv, x, w, o, rstd, n, h, eps, device, s);
    case 2: return rows_nv<T, 2>(nv, x, w, o, rstd, n, h, eps, device, s);
    case 4: return rows_nv<T, 4>(nv, x, w, o, rstd, n, h, eps, device, s);
    default: return cudaErrorInvalidValue;
  }
}


// The rowblock backward: rows per block; fixes the order of the dw partial
// sums
constexpr int kBwdRows = 16;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ rstd, const T* __restrict__ g,
                    T* __restrict__ dx, float* __restrict__ dw_part, int n,
                    int h) {
  extern __shared__ float dws[];  // [h]: this block's dw partial
  __shared__ float red[kThreads / 32];
  constexpr int V = Vec<T>::n;
  for (int i = threadIdx.x; i < h; i += kThreads) dws[i] = 0.f;
  __syncthreads();
  const int r0 = blockIdx.x * kBwdRows, r1 = min(n, r0 + kBwdRows);
  for (int row = r0; row < r1; ++row) {
    const T* xr = x + size_t(row) * h;
    const T* gr = g + size_t(row) * h;
    T* dxr = dx + size_t(row) * h;
    const float r = rstd[row];
    // mean(w*g * xhat) over the row
    float acc = 0.f;
    if (kVec) {
      float xf[V], gf[V], wf[V];
      for (int i = threadIdx.x * V; i < h; i += kThreads * V) {
        load_vec(xr + i, xf);
        load_vec(gr + i, gf);
        load_vec(w + i, wf);
#pragma unroll
        for (int j = 0; j < V; ++j) acc += gf[j] * wf[j] * (xf[j] * r);
      }
    } else {
      for (int i = threadIdx.x; i < h; i += kThreads)
        acc += to_f(gr[i]) * to_f(w[i]) * (to_f(xr[i]) * r);
    }
    const float mean = block_sum(acc, red) / h;
    // each thread touches only its own columns of dws: no race
    if (kVec) {
      float xf[V], gf[V], wf[V], of[V];
      for (int i = threadIdx.x * V; i < h; i += kThreads * V) {
        load_vec(xr + i, xf);
        load_vec(gr + i, gf);
        load_vec(w + i, wf);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xh = xf[j] * r;
          of[j] = r * (gf[j] * wf[j] - xh * mean);
          dws[i + j] += gf[j] * xh;
        }
        store_vec(dxr + i, of);
      }
    } else {
      for (int i = threadIdx.x; i < h; i += kThreads) {
        const float xh = to_f(xr[i]) * r, gv = to_f(gr[i]);
        dxr[i] = from_f<T>(r * (gv * to_f(w[i]) - xh * mean));
        dws[i] += gv * xh;
      }
    }
    // block_sum's shared scratch is reused by the next row
    __syncthreads();
  }
  __syncthreads();
  float* part = dw_part + size_t(blockIdx.x) * h;
  for (int i = threadIdx.x; i < h; i += kThreads) part[i] = dws[i];
}

// dw[c] = sum over blocks, in block order, of the partials; cast to w's type
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_dw_kernel(const float* __restrict__ dw_part, int nb, int h,
                   T* __restrict__ dw) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= h) return;
  float acc = 0.f;
  for (int b = 0; b < nb; ++b) acc += dw_part[size_t(b) * h + c];
  dw[c] = from_f<T>(acc);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const float* rstd,
                       const void* g, void* dx, float* dw_part, void* dw,
                       int n, int h, cudaStream_t stream) {
  constexpr int V = Vec<T>::n;
  const int nb = (n + kBwdRows - 1) / kBwdRows;
  const size_t smem = sizeof(float) * size_t(h);
  const bool vec = h % V == 0 &&
                   (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(g) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(dx) % 16) == 0;
  auto kernel = vec ? rms_norm_bwd_kernel<T, true>
                    : rms_norm_bwd_kernel<T, false>;
  // past 48 KB with the static row-sum scratch, the kernel must opt in
  if (smem + sizeof(float) * kThreads / 32 > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<nb, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), rstd,
      static_cast<const T*>(g), static_cast<T*>(dx), dw_part, n, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_norm_dw_kernel<T><<<(h + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(dw_part, nb, h, static_cast<T*>(dw));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, w and o share it);
// wpr 0 runs the strided design, else the register-row design with wpr
// warps a row and nv vectors a lane; device is the pointers' device, made
// current for the launch only; rstd may be null (no statistics stored).
extern "C" int pdt_rms_norm_fwd(const void* x, const void* w, void* o,
                                void* rstd, int n, int h, float eps,
                                int dtype, int wpr, int nv, int device,
                                void* stream) {
  if (n <= 0) return 0;
  if (wpr != 0 && h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  switch (dtype) {
    case 0:
      return launch_fwd<float>(x, w, o, r, n, h, eps, wpr, nv, device, s);
    case 1:
      return launch_fwd<__nv_bfloat16>(x, w, o, r, n, h, eps, wpr, nv,
                                       device, s);
    case 2:
      return launch_fwd<__half>(x, w, o, r, n, h, eps, wpr, nv, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, w, g, dx and dw share `dtype` (0 = float32, 1 = bfloat16, 2 =
// float16); rstd is the forward's (n,) f32 output. wpr 0 runs the rowblock
// design (dw_part: ceil(n / 16) x h f32 scratch), else the register-row
// design of class (wpr, nv) (dw_part: part_rows x h f32 scratch, at
// most part_rows blocks); device is the pointers' device, made current for
// the launch only.
extern "C" int pdt_rms_norm_bwd(const void* x, const void* w,
                                const void* rstd, const void* g, void* dx,
                                void* dw_part, void* dw, int n, int h,
                                int dtype, int wpr, int nv,
                                int part_rows, int device, void* stream) {
  if (n <= 0 || h <= 0) return 0;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rstd);
  float* part = static_cast<float*>(dw_part);
  if (wpr != 0) {
    switch (dtype) {
      case 0:
        return launch_bwd_registers<float, false>(
            x, w, nullptr, r, g, dx, part, part_rows, dw, nullptr, n, h, wpr,
            nv, device, s);
      case 1:
        return launch_bwd_registers<__nv_bfloat16, false>(
            x, w, nullptr, r, g, dx, part, part_rows, dw, nullptr, n, h, wpr,
            nv, device, s);
      case 2:
        return launch_bwd_registers<__half, false>(
            x, w, nullptr, r, g, dx, part, part_rows, dw, nullptr, n, h, wpr,
            nv, device, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (dtype) {
    case 0:
      return launch_bwd<float>(x, w, r, g, dx, part, dw, n, h, s);
    case 1:
      return launch_bwd<__nv_bfloat16>(x, w, r, g, dx, part, dw, n, h, s);
    case 2:
      return launch_bwd<__half>(x, w, r, g, dx, part, dw, n, h, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
