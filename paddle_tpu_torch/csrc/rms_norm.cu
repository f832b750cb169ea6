// RMSNorm forward for Hopper (sm_90a): o = x * rsqrt(mean(x^2) + eps) * w,
// computed in f32 and stored in x's type, plus rstd as an (n,) f32 output.
//
// Replaces: paddle_tpu/ops/norm_kernels.py:_rms_fwd_kernel (launched by
// _rms_fwd, pallas_call at :75).
//
// What bounds it on this card: bytes. Each row is read twice (sum of
// squares, then the scaled store; the second read hits L1/L2) and written
// once, at about 4 operations per element. At the decode shape of the
// serving path (8 rows x 4096) the work is a few microseconds of memory
// traffic, so each of the 2L+1 launches per dispatch is bound by launch
// latency, not by the card. At admission (thousands of rows) it is bound by
// device-memory bandwidth.
//
// What the design does about that: one block of 256 threads per row, 16-byte
// vector loads and stores where the row allows them, the reduction in
// warp shuffles plus one shared-memory step, and no second kernel: the
// statistics never leave the block. Launch latency is left to a later
// change (CUDA graphs over the whole dispatch, or fusing the norm into the
// neighbouring matmul's prologue).
//
// C interface: pointers are device pointers on the caller's current stream;
// the function returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and o share it)
extern "C" int pdt_rms_norm_fwd(const void* x, const void* w, void* o,
                                void* rstd, int n, int h, float eps,
                                int dtype, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  switch (dtype) {
    case 0: return launch<float>(x, w, o, r, n, h, eps, s);
    case 1: return launch<__nv_bfloat16>(x, w, o, r, n, h, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
