// LayerNorm for Hopper (sm_90a). Forward: y = (x - mu) * rstd * w + b with
// mu and var = mean((x - mu)^2) over the row in f32 (two passes, as the TPU
// kernel computes them), rstd = rsqrt(var + eps), y stored in x's type, and
// mu and rstd kept as (n,) f32 outputs. Backward: with xhat = (x - mu) *
// rstd and wg = w * g, dx = rstd * (wg - mean(wg) - xhat * mean(wg * xhat))
// in x's type; dw = sum over rows of g * xhat and db = sum of g, in f32,
// cast to w's type.
//
// Replaces: paddle_tpu/ops/norm_kernels.py:_ln_fwd_kernel (:148, launched
// by _ln_fwd, pallas_call at :188) and _ln_bwd_kernel (:160, launched by
// _ln_bwd_rule, pallas_call at :216).
//
// What bounds them on this card: bytes. The forward reads each row three
// times (sum, centred sum of squares, the scaled store; the second and
// third reads hit L1/L2) and writes it once, at about 6 operations per
// element; the backward reads x and g twice and writes dx, about 12
// operations per element. At BERT-base's (16384, 768) f32 the forward's
// bytes take ~30 us of device-memory time.
//
// What the design does about that: one block of 256 threads per row
// (forward) or per 16 rows (backward), 16-byte vector loads and stores
// where the row allows them, the row reductions in warp shuffles plus one
// shared-memory step, no second pass over device memory for the
// statistics. dw and db need sums over all rows, which the TPU kernel
// carried from one grid step to the next in revisited output blocks; here
// blocks run in parallel, so each block writes its rows' f32 partial sums
// (each thread owns fixed columns in shared memory, no atomics) and a
// second small kernel adds the partials in block order: the result is
// deterministic, run to run. The same design as csrc/rms_norm.cu.
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

// the block's sum of (a, b); `red` holds 2 * kThreads / 32 floats and is
// free again when this returns
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  a = lane < kWarps ? red[lane] : 0.f;
  b = lane < kWarps ? red[kWarps + lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  __syncthreads();
  return make_float2(a, b);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ b, T* __restrict__ o,
                      float* __restrict__ mean, float* __restrict__ rstd,
                      int h, float eps) {
  __shared__ float red[2 * kThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * h;
  T* orow = o + row * h;
  constexpr int V = Vec<T>::n;
  float s = 0.f;
  if (kVec) {
    float f[V];
    for (int i = threadIdx.x * V; i < h; i += kThreads * V) {
      load_vec(xr + i, f);
#pragma unroll
      for (int j = 0; j < V; ++j) s += f[j];
    }
  } else {
    for (int i = threadIdx.x; i < h; i += kThreads) s += to_f(xr[i]);
  }
  const float mu = block_sum2(s, 0.f, red).x / h;
  float ss = 0.f;
  if (kVec) {
    float f[V];
    for (int i = threadIdx.x * V; i < h; i += kThreads * V) {
      load_vec(xr + i, f);
#pragma unroll
      for (int j = 0; j < V; ++j) ss += (f[j] - mu) * (f[j] - mu);
    }
  } else {
    for (int i = threadIdx.x; i < h; i += kThreads) {
      const float d = to_f(xr[i]) - mu;
      ss += d * d;
    }
  }
  const float r = rsqrtf(block_sum2(ss, 0.f, red).x / h + eps);
  if (kVec) {
    float f[V], wf[V], bf[V];
    for (int i = threadIdx.x * V; i < h; i += kThreads * V) {
      load_vec(xr + i, f);
      load_vec(w + i, wf);
      load_vec(b + i, bf);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = (f[j] - mu) * r * wf[j] + bf[j];
      store_vec(orow + i, f);
    }
  } else {
    for (int i = threadIdx.x; i < h; i += kThreads)
      orow[i] = from_f<T>((to_f(xr[i]) - mu) * r * to_f(w[i]) + to_f(b[i]));
  }
  if (threadIdx.x == 0) {
    mean[row] = mu;
    rstd[row] = r;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const void* b, void* o,
                       float* mean, float* rstd, int n, int h, float eps,
                       cudaStream_t stream) {
  constexpr int V = Vec<T>::n;
  const bool vec = h % V == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(b) && aligned16(o);
  auto kernel = vec ? layer_norm_fwd_kernel<T, true>
                    : layer_norm_fwd_kernel<T, false>;
  kernel<<<n, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(o), mean, rstd, h, eps);
  return cudaGetLastError();
}

// rows per block of the backward; fixes the order of the dw/db partials
constexpr int kBwdRows = 16;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd,
                      const T* __restrict__ g, T* __restrict__ dx,
                      float* __restrict__ dw_part,
                      float* __restrict__ db_part, int n, int h) {
  extern __shared__ float acc[];  // [2][h]: this block's dw, db partials
  __shared__ float red[2 * kThreads / 32];
  float* dws = acc;
  float* dbs = acc + h;
  constexpr int V = Vec<T>::n;
  for (int i = threadIdx.x; i < 2 * h; i += kThreads) acc[i] = 0.f;
  __syncthreads();
  const int r0 = blockIdx.x * kBwdRows, r1 = min(n, r0 + kBwdRows);
  for (int row = r0; row < r1; ++row) {
    const T* xr = x + size_t(row) * h;
    const T* gr = g + size_t(row) * h;
    T* dxr = dx + size_t(row) * h;
    const float mu = mean[row], r = rstd[row];
    // mean(wg) and mean(wg * xhat) over the row
    float a1 = 0.f, a2 = 0.f;
    if (kVec) {
      float xf[V], gf[V], wf[V];
      for (int i = threadIdx.x * V; i < h; i += kThreads * V) {
        load_vec(xr + i, xf);
        load_vec(gr + i, gf);
        load_vec(w + i, wf);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float wg = gf[j] * wf[j];
          a1 += wg;
          a2 += wg * ((xf[j] - mu) * r);
        }
      }
    } else {
      for (int i = threadIdx.x; i < h; i += kThreads) {
        const float wg = to_f(gr[i]) * to_f(w[i]);
        a1 += wg;
        a2 += wg * ((to_f(xr[i]) - mu) * r);
      }
    }
    const float2 m = block_sum2(a1, a2, red);
    const float m1 = m.x / h, m2 = m.y / h;
    // each thread touches only its own columns of dws / dbs: no race
    if (kVec) {
      float xf[V], gf[V], wf[V], of[V];
      for (int i = threadIdx.x * V; i < h; i += kThreads * V) {
        load_vec(xr + i, xf);
        load_vec(gr + i, gf);
        load_vec(w + i, wf);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xh = (xf[j] - mu) * r;
          of[j] = r * (gf[j] * wf[j] - m1 - xh * m2);
          dws[i + j] += gf[j] * xh;
          dbs[i + j] += gf[j];
        }
        store_vec(dxr + i, of);
      }
    } else {
      for (int i = threadIdx.x; i < h; i += kThreads) {
        const float xh = (to_f(xr[i]) - mu) * r, gv = to_f(gr[i]);
        dxr[i] = from_f<T>(r * (gv * to_f(w[i]) - m1 - xh * m2));
        dws[i] += gv * xh;
        dbs[i] += gv;
      }
    }
  }
  __syncthreads();
  float* pw = dw_part + size_t(blockIdx.x) * h;
  float* pb = db_part + size_t(blockIdx.x) * h;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    pw[i] = dws[i];
    pb[i] = dbs[i];
  }
}

// dw[c], db[c] = sums over blocks, in block order, of the partials; cast to
// w's type
template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_dwdb_kernel(const float* __restrict__ dw_part,
                       const float* __restrict__ db_part, int nb, int h,
                       T* __restrict__ dw, T* __restrict__ db) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= h) return;
  float aw = 0.f, ab = 0.f;
  for (int k = 0; k < nb; ++k) {
    aw += dw_part[size_t(k) * h + c];
    ab += db_part[size_t(k) * h + c];
  }
  dw[c] = from_f<T>(aw);
  db[c] = from_f<T>(ab);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const float* mean,
                       const float* rstd, const void* g, void* dx,
                       float* part, void* dw, void* db, int n, int h,
                       cudaStream_t stream) {
  constexpr int V = Vec<T>::n;
  const int nb = (n + kBwdRows - 1) / kBwdRows;
  const size_t smem = 2 * sizeof(float) * size_t(h);
  const bool vec = h % V == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(g) && aligned16(dx);
  auto kernel = vec ? layer_norm_bwd_kernel<T, true>
                    : layer_norm_bwd_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  float* dw_part = part;
  float* db_part = part + size_t(nb) * h;
  kernel<<<nb, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), mean, rstd,
      static_cast<const T*>(g), static_cast<T*>(dx), dw_part, db_part, n, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layer_norm_dwdb_kernel<T><<<(h + kThreads - 1) / kThreads, kThreads, 0,
                              stream>>>(dw_part, db_part, nb, h,
                                        static_cast<T*>(dw),
                                        static_cast<T*>(db));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, w, b and o share it);
// mean and rstd are (n,) f32 outputs.
extern "C" int pdt_layer_norm_fwd(const void* x, const void* w,
                                  const void* b, void* o, void* mean,
                                  void* rstd, int n, int h, float eps,
                                  int dtype, void* stream) {
  if (n <= 0) return 0;
  if (h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mu = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  switch (dtype) {
    case 0: return launch_fwd<float>(x, w, b, o, mu, r, n, h, eps, s);
    case 1:
      return launch_fwd<__nv_bfloat16>(x, w, b, o, mu, r, n, h, eps, s);
    case 2: return launch_fwd<__half>(x, w, b, o, mu, r, n, h, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, w, g, dx, dw and db share `dtype` (0 = float32, 1 = bfloat16, 2 =
// float16); mean and rstd are the forward's (n,) f32 outputs; part is
// 2 * ceil(n / 16) * h f32 scratch (the dw partials, then the db partials).
extern "C" int pdt_layer_norm_bwd(const void* x, const void* w,
                                  const void* mean, const void* rstd,
                                  const void* g, void* dx, void* part,
                                  void* dw, void* db, int n, int h,
                                  int dtype, void* stream) {
  if (n <= 0 || h <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mu = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* p = static_cast<float*>(part);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(x, w, mu, r, g, dx, p, dw, db, n, h, s);
    case 1:
      return launch_bwd<__nv_bfloat16>(x, w, mu, r, g, dx, p, dw, db, n, h,
                                       s);
    case 2:
      return launch_bwd<__half>(x, w, mu, r, g, dx, p, dw, db, n, h, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
