// Rotary position embedding for Hopper (sm_90a), forward and backward.
//
// Replaces: paddle_tpu/ops/rope.py:_rope_kernel (:27, launched by
// _rope_apply, pallas_call at :60).
//
// x is (B, S, H, D) with any S and any even D, read in place; the pairs are
// interleaved, (x[2i], x[2i + 1]) rotated by the angle of (position s,
// pair i): y[2i] = x1 c - x2 s, y[2i + 1] = x2 c + x1 s, with c, s from the
// (S, D/2) f32 tables (already sliced at the position offset). The TPU
// kernel reads de-interleaved halves only because Mosaic could not lower
// the strided lane slice; here each thread reads one pair with one vector
// load (bf16x2, half2 or float2). Math in f32, the result cast to x's type.
// SIGN = -1 rotates by the opposite angle: the backward (the rotation is
// linear and orthogonal, so its VJP is the inverse rotation of the
// cotangent, and nothing is saved).
//
// Rounding: the products and the sum use __fmul_rn / __fsub_rn / __fadd_rn,
// so nvcc does not contract x1 c - x2 s into an FMA; each product is rounded
// once, as in the plain version (separate elementwise ops), and the f32
// results equal the plain version's bit for bit.
//
// What bounds it on this card: bytes. Four flops a pair against 2 elements
// read and 2 written (plus the tables, which stay in L2 across the B x H
// rows that share them): x and y once each over 3.35 TB/s.
//
// C interface: device pointers on the caller's current stream; the entry
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Pair;

template <>
struct Pair<float> {
  using V = float2;
  static __device__ __forceinline__ float2 load(const V& v) { return v; }
  static __device__ __forceinline__ V store(float a, float b) {
    return make_float2(a, b);
  }
};

template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static __device__ __forceinline__ float2 load(const V& v) {
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ V store(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};

template <>
struct Pair<__half> {
  using V = __half2;
  static __device__ __forceinline__ float2 load(const V& v) {
    return __half22float2(v);
  }
  static __device__ __forceinline__ V store(float a, float b) {
    return __floats2half2_rn(a, b);
  }
};

template <typename T, int SIGN>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const typename Pair<T>::V* __restrict__ x,
            const float* __restrict__ cosv, const float* __restrict__ sinv,
            typename Pair<T>::V* __restrict__ y, long long pairs, int S,
            int H, int half) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long p = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       p < pairs; p += stride) {
    const int i = static_cast<int>(p % half);
    const int s = static_cast<int>((p / (static_cast<long long>(half) * H)) %
                                   S);
    const float c = cosv[s * half + i];
    const float sn = SIGN > 0 ? sinv[s * half + i] : -sinv[s * half + i];
    const float2 v = Pair<T>::load(x[p]);
    const float r1 = __fsub_rn(__fmul_rn(v.x, c), __fmul_rn(v.y, sn));
    const float r2 = __fadd_rn(__fmul_rn(v.y, c), __fmul_rn(v.x, sn));
    y[p] = Pair<T>::store(r1, r2);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* cosv, const void* sinv,
                   void* y, long long pairs, int S, int H, int half,
                   int sign, cudaStream_t st) {
  using V = typename Pair<T>::V;
  const long long want = (pairs + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  if (sign > 0)
    rope_kernel<T, 1><<<blocks, kThreads, 0, st>>>(
        static_cast<const V*>(x), static_cast<const float*>(cosv),
        static_cast<const float*>(sinv), static_cast<V*>(y), pairs, S, H,
        half);
  else
    rope_kernel<T, -1><<<blocks, kThreads, 0, st>>>(
        static_cast<const V*>(x), static_cast<const float*>(cosv),
        static_cast<const float*>(sinv), static_cast<V*>(y), pairs, S, H,
        half);
  return cudaGetLastError();
}

}  // namespace

// x, y: (B, S, H, D) contiguous, D even; cos, sin: (S, D/2) f32 contiguous.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16; sign +1 (forward) or -1
// (backward).
extern "C" int pdt_rope(const void* x, const void* cosv, const void* sinv,
                        void* y, int B, int S, int H, int D, int sign,
                        int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D % 2 || (sign != 1 &&
                                                        sign != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(B) * S * H * (D / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, cosv, sinv, y, pairs, S, H, D / 2, sign, st);
    case 1:
      return launch<__nv_bfloat16>(x, cosv, sinv, y, pairs, S, H, D / 2,
                                   sign, st);
    case 2:
      return launch<__half>(x, cosv, sinv, y, pairs, S, H, D / 2, sign, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
