// RMSNorm for Hopper (sm_90a). Forward: o = x * rsqrt(mean(x^2) + eps) * w,
// computed in f32 and stored in x's type, plus rstd as an (n,) f32 output.
// Backward: dx = rstd * (w*g - xhat * mean(w*g * xhat)) with xhat = x * rstd,
// stored in x's type, and dw = sum over rows of g * xhat in f32, cast to
// w's type.
//
// Replaces: paddle_tpu/ops/norm_kernels.py:_rms_fwd_kernel (launched by
// _rms_fwd, pallas_call at :75) and _rms_bwd_kernel (:53, launched by
// _rms_bwd_rule, pallas_call at :106).
//
// What bounds them on this card: bytes. The forward reads each row twice
// (sum of squares, then the scaled store; the second read hits L1/L2) and
// writes it once, at about 4 operations per element. At the decode shape of
// the serving path (8 rows x 4096) the work is a few microseconds of memory
// traffic, so each of the 2L+1 launches per dispatch is bound by launch
// latency, not by the card. At admission and in training (thousands of
// rows) it is bound by device-memory bandwidth. The backward reads x and g
// twice (the second pass from L1/L2) and writes dx, about 10 operations per
// element: bytes again.
//
// What the design does about that: one block of 256 threads per row
// (forward) or per 16 rows (backward), 16-byte vector loads and stores where
// the row allows them, the row reductions in warp shuffles plus one
// shared-memory step, and no second pass over device memory for the
// statistics. dw needs a sum over all rows, which the TPU kernel carried
// from one grid step to the next in a revisited output block; here blocks
// run in parallel, so each block writes its rows' f32 partial sums (each
// thread owns fixed columns in shared memory, no atomics) and a second small
// kernel adds the partials in block order: the result is deterministic.
// Launch latency is left to a later change (CUDA graphs, or fusing the norm
// into the neighbouring matmul).
//
// C interface: pointers are device pointers on the caller's current stream;
// each function returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) f[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) e[i] = from_f<T>(f[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

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
  if (threadIdx.x == 0) rstd[row] = r;
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


// rows per block of the backward; fixes the order of the dw partial sums
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
  if (smem > 48 * 1024) {
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

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, w and o share it)
extern "C" int pdt_rms_norm_fwd(const void* x, const void* w, void* o,
                                void* rstd, int n, int h, float eps,
                                int dtype, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  switch (dtype) {
    case 0: return launch<float>(x, w, o, r, n, h, eps, s);
    case 1: return launch<__nv_bfloat16>(x, w, o, r, n, h, eps, s);
    case 2: return launch<__half>(x, w, o, r, n, h, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, w, g, dx and dw share `dtype` (0 = float32, 1 = bfloat16, 2 =
// float16); rstd is the forward's (n,) f32 output; dw_part is
// (ceil(n / 16), h) f32 scratch.
extern "C" int pdt_rms_norm_bwd(const void* x, const void* w,
                                const void* rstd, const void* g, void* dx,
                                void* dw_part, void* dw, int n, int h,
                                int dtype, void* stream) {
  if (n <= 0 || h <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rstd);
  float* part = static_cast<float*>(dw_part);
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
