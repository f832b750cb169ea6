// BGMV LoRA epilogue for Hopper (sm_90a): the per-token low-rank adapter
// delta of batched multi-LoRA serving,
//
//   d[t] = round((x[t] @ A[id]) @ B[id] * s[id]),   id = ids[t],
//
// over stacked adapters A (R, K, r), B (R, r, N), s (R,) f32 and one adapter
// row per token, ids (T,) int32; rounded to x's type. With `accumulate` the
// delta is added into the base output y in place, y[t] = round(y[t] + d[t]),
// the rounding order of `y + delta.astype(y.dtype)`.
//
// Replaces: paddle_tpu/ops/lora_epilogue.py:_lora_epilogue_kernel (:111),
// launched by _lora_epilogue_pallas, pallas_call at :140.
//
// Design. The TPU kernel runs one grid step per token and lets the
// scalar-prefetched ids pick the token's (K, r) and (r, N) blocks. Here one
// C entry makes two launches:
//  1. shrink, one block per (token, chunk of kchunk rows of A): thread
//     (g, l) of the block (16 groups of 16 lanes) sums x[k] * A[id, k, j] in
//     f32 over the chunk's k = g, g + 16, ... for its rank columns j = l,
//     l + 16, ... < r, so a warp reads 16 consecutive columns of two A rows
//     at a time. The 16 partial sums of each column are added in group
//     order by one thread, into h (T, chunks, r) f32. Splitting K over
//     blocks is what keeps a decode batch (8 tokens) from walking a whole
//     (K, r) block in 8 blocks: the walk is latency-bound, so the card
//     needs many short ones in flight.
//  2. expand, one block per (token, 256 columns of N): the block first adds
//     the token's chunk sums of each column in chunk order, then each thread
//     forms one output, sum over j = 0..r-1 of h[t, j] * B[id, j, n] in
//     f32, times s[id].
// The order of every column's sum depends on K and kchunk only, not on r,
// so zero columns padded onto a stack change no bit of the others.
// No sum runs across tokens and every order of summation is fixed by the
// thread layout, so a token's delta is bitwise the same whatever batch it
// rides in: the mixed-batch bit-identity of lora_epilogue.py rests on that.
// Tokens of row 0 (the all-zeros no-adapter row, scale 0) skip the math: the
// delta is an exact zero and an accumulated y is left as it is. An id outside
// [0, R) is treated as row 0.
//
// What bounds it on this card: bytes. A token reads its adapter's A and B
// once, about 2 (K + N) r bytes in bf16, for 4 (K + N) r operations, far
// below the ~295 operations per byte where the tensor cores become the limit.
// At decode (8 tokens) the bytes take well under a microsecond; the two
// launches take a few microseconds each whatever the bytes (a first version
// with one shrink block per token took several times longer: 8 blocks
// walking whole (K, r) blocks). Tokens of one adapter each read its A and B
// again (from L2 after the first); SGMV, grouping the tokens of one sequence
// (ragged admission keeps them contiguous) so a segment reads A and B once,
// is later work.
//
// C interface: device pointers on the caller's stream; the entry returns
// cudaGetLastError() after each launch, or cudaErrorInvalidValue for a rank
// outside [1, 256].

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 16;  // shrink: k = g, g + 16, ... for thread group g
constexpr int kLanes = kThreads / kGroups;  // rank columns a group spans
constexpr int kMaxRank = kThreads;

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

__device__ __forceinline__ bool live_row(int id, int R) {
  return id > 0 && id < R;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lora_shrink_kernel(const T* __restrict__ x, const T* __restrict__ a,
                   const int* __restrict__ ids, float* __restrict__ h, int K,
                   int R, int r, int kchunk) {
  __shared__ float part[kGroups * kMaxRank];
  const int t = blockIdx.x, c = blockIdx.y;
  const int id = ids[t];
  if (!live_row(id, R)) return;  // block-uniform: the expand skips it too
  const int g = threadIdx.x / kLanes, jl = threadIdx.x - g * kLanes;
  const int k1 = min(K, (c + 1) * kchunk);
  const T* xr = x + size_t(t) * K;
  const T* ar = a + size_t(id) * K * r;
  for (int j = jl; j < r; j += kLanes) {
    float acc = 0.f;
    for (int k = c * kchunk + g; k < k1; k += kGroups)
      acc += to_f(xr[k]) * to_f(ar[size_t(k) * r + j]);
    part[g * r + j] = acc;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < r; j += kThreads) {
    float s = 0.f;
    for (int gg = 0; gg < kGroups; ++gg) s += part[gg * r + j];
    h[(size_t(t) * gridDim.y + c) * r + j] = s;
  }
}

template <typename T, bool kAccumulate>
__global__ void __launch_bounds__(kThreads)
lora_expand_kernel(const float* __restrict__ h, const T* __restrict__ b,
                   const float* __restrict__ scale,
                   const int* __restrict__ ids, T* __restrict__ y, int N,
                   int R, int r, int chunks) {
  __shared__ float hs[kMaxRank];
  const int t = blockIdx.x;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  const int id = ids[t];
  if (!live_row(id, R)) {  // block-uniform
    if (!kAccumulate && n < N) y[size_t(t) * N + n] = from_f<T>(0.f);
    return;
  }
  for (int j = threadIdx.x; j < r; j += kThreads) {
    const float* hj = h + size_t(t) * chunks * r + j;
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += hj[size_t(c) * r];
    hs[j] = s;
  }
  __syncthreads();
  if (n >= N) return;
  const T* br = b + size_t(id) * r * N + n;
  float acc = 0.f;
  for (int j = 0; j < r; ++j) acc += hs[j] * to_f(br[size_t(j) * N]);
  // __fmul_rn: the product is rounded on its own, never contracted into
  // an FMA with the add below, so an f32 y + d has the bits of the
  // unfused `y + delta`
  const T d = from_f<T>(__fmul_rn(acc, scale[id]));
  T* out = y + size_t(t) * N + n;
  if (kAccumulate)
    *out = from_f<T>(to_f(*out) + to_f(d));
  else
    *out = d;
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* b,
                   const float* scale, const int* ids, float* h, void* y,
                   int T_, int K, int N, int R, int r, int kchunk,
                   bool accumulate, cudaStream_t stream) {
  const int chunks = (K + kchunk - 1) / kchunk;
  lora_shrink_kernel<T><<<dim3(T_, chunks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), ids, h, K, R, r,
      kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(T_, (N + kThreads - 1) / kThreads);
  if (accumulate)
    lora_expand_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        h, static_cast<const T*>(b), scale, ids, static_cast<T*>(y), N, R, r,
        chunks);
  else
    lora_expand_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        h, static_cast<const T*>(b), scale, ids, static_cast<T*>(y), N, R, r,
        chunks);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, A, B and y share
// it). h: f32 scratch of T * ceil(K / kchunk) * r values. accumulate: 0
// writes the delta into y, 1 adds it into y.
extern "C" int pdt_lora_epilogue(const void* x, const void* a, const void* b,
                                 const void* scale, const void* ids, void* h,
                                 void* y, int T, int K, int N, int R, int r,
                                 int kchunk, int dtype, int accumulate,
                                 void* stream) {
  if (T <= 0 || N <= 0) return 0;
  if (K <= 0 || R <= 0 || r <= 0 || r > kMaxRank || kchunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const int* id = static_cast<const int*>(ids);
  float* hh = static_cast<float*>(h);
  switch (dtype) {
    case 0:
      return launch<float>(x, a, b, sc, id, hh, y, T, K, N, R, r, kchunk,
                           accumulate != 0, s);
    case 1:
      return launch<__nv_bfloat16>(x, a, b, sc, id, hh, y, T, K, N, R, r,
                                   kchunk, accumulate != 0, s);
    case 2:
      return launch<__half>(x, a, b, sc, id, hh, y, T, K, N, R, r, kchunk,
                            accumulate != 0, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
