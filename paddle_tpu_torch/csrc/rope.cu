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
// the strided lane slice; here the pairs are read in place. Math in f32,
// the result cast to x's type. SIGN = -1 rotates by the opposite angle:
// the backward (the rotation is linear and orthogonal, so its VJP is the
// inverse rotation of the cotangent, and nothing is saved).
//
// Rounding: the products and the sum use __fmul_rn / __fsub_rn / __fadd_rn,
// so nvcc does not contract x1 c - x2 s into an FMA; each product is rounded
// once, as in the plain version (separate elementwise ops), and the f32
// results equal the plain version's bit for bit.
//
// What bounds it on this card: bytes. Four multiplies and two adds a pair
// against 2 elements read and 2 written: x and y once each (the tables, read
// once too, are D/2 floats a position against H D elements) over 3.35 TB/s.
//
// Two designs:
// - rope_vec (pdt_rope_qk), for heads of whole 16-byte vectors (D a
//   multiple of 8 in bf16 / f16, of 4 in f32) at 16-byte-aligned pointers.
//   One launch rotates q and, when HK > 0, k at the same positions. A
//   thread owns chunk j (a 16-byte vector: 4 pairs in bf16 / f16, 2 in
//   f32) of a set of heads at one position: the position comes from the
//   block index and (head lane, chunk) from the thread index, in 32-bit and
//   once; the chunk's cos and sin are loaded once into registers (one
//   float4 each, float2 in f32) and serve every head the thread walks:
//   heads g, g + G, g + 2 G, ... of q's H followed by k's HK. A thread
//   issues all its vector loads (up to kSlots) read-only before any
//   arithmetic, so each has 64 bytes in flight; neighbouring threads read
//   neighbouring 16 bytes of a head and neighbouring heads. No division in
//   the loop.
// - rope_kernel (pdt_rope), one pair a thread of a grid-stride loop, for
//   what rope_vec does not take: a head's bytes not a multiple of 16 (D 2,
//   D 6 ...) or a pointer off 16 bytes (a view). Pointers must lie on their
//   element pairs.
//
// C interface: device pointers on the caller's current stream; device is
// the pointers' device, made current for the launch when it is not; each
// entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "device_scope.cuh"

namespace {

constexpr int kThreads = 256;
// rope_vec: vectors a thread loads before any arithmetic, threads a block
// at least (positions share a block below it) and at most
constexpr int kSlots = 4;
constexpr int kMinBlock = 128;
constexpr int kMaxBlock = 1024;

__device__ __forceinline__ float rot1(float x1, float x2, float c, float s) {
  return __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
}

__device__ __forceinline__ float rot2(float x1, float x2, float c, float s) {
  return __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
}

// -- rope_kernel: one pair a thread -------------------------------------------

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
    y[p] = Pair<T>::store(rot1(v.x, v.y, c, sn), rot2(v.x, v.y, c, sn));
  }
}

template <typename T>
cudaError_t launch_pairs(const void* x, const void* cosv, const void* sinv,
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

// -- rope_vec: 16-byte vectors, q and k in one launch -------------------------

// A 16-byte vector of T holds kPairs pairs: for 16-bit T pair u is 32-bit
// word u, for f32 words 2u and 2u + 1.
template <typename T>
struct Vec {
  static constexpr int kPairs = 4;
  using V2 = typename Pair<T>::V;
  static __device__ __forceinline__ float2 get(const uint32_t (&w)[4],
                                               int u) {
    uint32_t b = w[u];
    return Pair<T>::load(*reinterpret_cast<const V2*>(&b));
  }
  static __device__ __forceinline__ void put(uint32_t (&w)[4], int u,
                                             float a, float b) {
    V2 r = Pair<T>::store(a, b);
    w[u] = *reinterpret_cast<const uint32_t*>(&r);
  }
};

template <>
struct Vec<float> {
  static constexpr int kPairs = 2;
  static __device__ __forceinline__ float2 get(const uint32_t (&w)[4],
                                               int u) {
    return make_float2(__uint_as_float(w[2 * u]),
                       __uint_as_float(w[2 * u + 1]));
  }
  static __device__ __forceinline__ void put(uint32_t (&w)[4], int u,
                                             float a, float b) {
    w[2 * u] = __float_as_uint(a);
    w[2 * u + 1] = __float_as_uint(b);
  }
};

// cos and sin of a chunk's kPairs pairs, read-only, into registers
template <int P>
__device__ __forceinline__ void load_trig(const float* p, float (&t)[4]) {
  if constexpr (P == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    t[0] = v.x; t[1] = v.y; t[2] = v.z; t[3] = v.w;
  } else {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    t[0] = v.x; t[1] = v.y;
  }
}

// Grid: blocks of ppb positions x tpp = G C threads; position p = blockIdx
// ppb + t / tpp, head lane g and chunk j from t % tpp. q, k, yq, yk in
// 16-byte vectors: head h of position p is C vectors at (p H + h) C.
template <typename T, int SIGN>
__global__ void __launch_bounds__(kMaxBlock)
rope_vec(const uint4* __restrict__ q, const uint4* __restrict__ k,
         const float* __restrict__ cosv, const float* __restrict__ sinv,
         uint4* __restrict__ yq, uint4* __restrict__ yk, int npos, int S,
         int H, int HK, int C, int G, int tpp, int ppb) {
  constexpr int P = Vec<T>::kPairs;
  const int t = threadIdx.x;
  const int lp = t / tpp;
  const int r = t - lp * tpp;
  const int g = r / C;
  const int j = r - g * C;
  const int p = blockIdx.x * ppb + lp;
  if (p >= npos) return;
  const int s = p % S;
  const int nh = H + HK;
  const size_t trig = static_cast<size_t>(s) * (C * P) + j * P;
  float c[4], sn[4];
  load_trig<P>(cosv + trig, c);
  load_trig<P>(sinv + trig, sn);
  if (SIGN < 0) {
#pragma unroll
    for (int u = 0; u < P; ++u) sn[u] = -sn[u];
  }
  const size_t qrow = static_cast<size_t>(p) * H;
  const size_t krow = static_cast<size_t>(p) * HK;
  for (int h0 = g; h0 < nh; h0 += kSlots * G) {
    uint4 v[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int h = h0 + i * G;
      if (h < nh)
        v[i] = __ldg((h < H ? q + (qrow + h) * C : k + (krow + h - H) * C) +
                     j);
    }
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int h = h0 + i * G;
      if (h >= nh) continue;
      uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const float2 x = Vec<T>::get(w, u);
        Vec<T>::put(w, u, rot1(x.x, x.y, c[u], sn[u]),
                    rot2(x.x, x.y, c[u], sn[u]));
      }
      (h < H ? yq + (qrow + h) * C : yk + (krow + h - H) * C)[j] =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <typename T>
cudaError_t launch_vec(const void* q, const void* k, const void* cosv,
                       const void* sinv, void* yq, void* yk, int npos, int S,
                       int H, int HK, int D, int sign, cudaStream_t st) {
  const int C = D * static_cast<int>(sizeof(T)) / 16;
  const int nh = H + HK;
  int G = (nh + kSlots - 1) / kSlots;
  if (G * C > kMaxBlock) G = kMaxBlock / C;
  const int tpp = G * C;
  const int ppb = tpp < kMinBlock ? kMinBlock / tpp : 1;
  const int blocks = (npos + ppb - 1) / ppb;
  const uint4* qv = static_cast<const uint4*>(q);
  const uint4* kv = static_cast<const uint4*>(k);
  const float* cv = static_cast<const float*>(cosv);
  const float* sv = static_cast<const float*>(sinv);
  uint4* yqv = static_cast<uint4*>(yq);
  uint4* ykv = static_cast<uint4*>(yk);
  if (sign > 0)
    rope_vec<T, 1><<<blocks, ppb * tpp, 0, st>>>(
        qv, kv, cv, sv, yqv, ykv, npos, S, H, HK, C, G, tpp, ppb);
  else
    rope_vec<T, -1><<<blocks, ppb * tpp, 0, st>>>(
        qv, kv, cv, sv, yqv, ykv, npos, S, H, HK, C, G, tpp, ppb);
  return cudaGetLastError();
}

}  // namespace

// The pair design. x, y: (B, S, H, D) contiguous, D even, on their element
// pairs; cos, sin: (S, D/2) f32 contiguous. dtype: 0 = float32,
// 1 = bfloat16, 2 = float16; sign +1 (forward) or -1 (backward).
extern "C" int pdt_rope(const void* x, const void* cosv, const void* sinv,
                        void* y, int B, int S, int H, int D, int sign,
                        int dtype, int device, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D % 2 || (sign != 1 &&
                                                        sign != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  const long long pairs = static_cast<long long>(B) * S * H * (D / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_pairs<float>(x, cosv, sinv, y, pairs, S, H, D / 2, sign,
                                 st);
    case 1:
      return launch_pairs<__nv_bfloat16>(x, cosv, sinv, y, pairs, S, H,
                                         D / 2, sign, st);
    case 2:
      return launch_pairs<__half>(x, cosv, sinv, y, pairs, S, H, D / 2, sign,
                                  st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The vector design, q and k in one launch. q, yq: (B, S, H, D); k, yk:
// (B, S, HK, D), or HK = 0 and k, yk unused (a single tensor); all
// contiguous, 16-byte aligned, D of whole 16-byte vectors (at most
// kMaxBlock of them). cos, sin: (S, D/2) f32 contiguous, 16-byte aligned.
// dtype and sign as pdt_rope's.
extern "C" int pdt_rope_qk(const void* q, const void* k, const void* cosv,
                           const void* sinv, void* yq, void* yk, int B, int S,
                           int H, int HK, int D, int sign, int dtype,
                           int device, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  if (B <= 0 || S <= 0 || H <= 0 || HK < 0 || D <= 0 || dtype < 0 ||
      dtype > 2 || (D * esize) % 16 || D * esize / 16 > kMaxBlock ||
      (sign != 1 && sign != -1) ||
      static_cast<long long>(B) * S > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  const int npos = B * S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_vec<float>(q, k, cosv, sinv, yq, yk, npos, S, H, HK, D,
                               sign, st);
    case 1:
      return launch_vec<__nv_bfloat16>(q, k, cosv, sinv, yq, yk, npos, S, H,
                                       HK, D, sign, st);
    default:
      return launch_vec<__half>(q, k, cosv, sinv, yq, yk, npos, S, H, HK, D,
                                sign, st);
  }
}
