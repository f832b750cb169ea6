// Dequant matmul for Hopper (sm_90a): y = (x @ w^T) * s[n] with int8 or
// float8_e4m3fn weights, one f32 scale per output channel, f32 accumulation.
//
// Replaces: paddle_tpu/ops/quant_matmul.py:_dequant_matmul_kernel
// (launched by _dequant_matmul_pallas, pallas_call at :168). The JAX
// package sends fp8 storage through XLA; here one kernel serves both
// storage types as two template instances.
//
// Layout (the torch way): x is (M, K) f32, bf16 or f16, row-major; w is (N, K)
// int8 or e4m3, row-major (a Linear weight, out x in); s is (N,) f32; y is
// (M, N) in x's dtype. Any M, K, N: every edge is masked.
//
// Math. y[m, n] = (sum_k x[m, k] * w[n, k]) * s[n]: the per-channel scale is
// constant along k, so it multiplies the f32 accumulator once, in the
// epilogue. The weight is widened only in registers or shared memory, never
// written back to device memory at full width.
//
// Four designs, picked by the caller (`ops.quant_matmul.dequant_design`)
// and checked by the entry:
//  * decode (dequant_decode_kernel): bf16 or f16 x with M <= 8 (the 8
//    slots, the lm_head's 8 sampled rows) and K % 64 == 0. What bounds it
//    is bytes: the weight dominates (1 byte per element against 16 bytes
//    of x per k, which stays in L1/L2). Tensor cores take the math off
//    the CUDA cores, with the weight rows on the mma's 16-row side and the
//    tokens on its 8-column side; weights widen in registers by bit
//    tricks, the block's warps split K, and the next chunk's loads are
//    issued before the current one computes.
//  * wgmma (dequant_wgmma_kernel; bf16 or f16 x with M > 8, K % 16 == 0,
//    16-byte aligned x, w and y: TMA's strides): at admission (M in the
//    thousands) the product is bound by operations. The roles swap: a
//    block computes a 128-channel x 256-token tile of y^T = W . x^T, so
//    the weight is wgmma's A operand, in registers, and x, (M, K)
//    row-major, is exactly a K-major B operand with the tokens as wgmma's
//    N. One producer warp keeps TMA loads of raw weight tiles (128 rows x
//    64 bytes, 64-byte swizzle) and x tiles (256 tokens x 64 k, 128-byte
//    swizzle) in flight through a ring of four stages on mbarriers; two
//    consumer warpgroups each read their 64 weight rows of a stage from
//    shared memory, widen them in registers into the m64k16 A fragments
//    (widen4) and issue four m64n256k16 wgmma with f32 accumulators. The
//    epilogue multiplies each accumulator row by its channel's scale and
//    stores the tile transposed through shared memory, so y is written
//    16 bytes at a time along N. Blocks walk the tiles in groups of 16
//    weight tiles, so the weight and x tiles in flight stay in the L2.
//  * mma.sync (dequant_mma_kernel; bf16 or f16 x, any shape; the design
//    the wgmma one replaced at admission, kept as its yardstick and for
//    the shapes TMA refuses): a 128 x 128 output tile per block, K in
//    steps of 32 through two shared-memory stages (the next tile's global
//    loads wait in registers while the current one is multiplied); each
//    weight tile is widened as it is staged, fragments load by ldmatrix,
//    and mma.sync.m16n8k16 accumulates in f32.
//  * CUDA cores (dequant_gemv_kernel; f32 x, and 16-bit x with M <= 8
//    off the decode kernel's K): each warp streams kRows weight rows with
//    16-byte loads (16 int8 / e4m3 values a lane), widens them to f32 in
//    registers, multiplies them with up to 8 activation rows, and reduces
//    with warp shuffles; the scale multiplies the reduced sum. f32 x never
//    goes through TF32.
//
// Exactness. int8 and e4m3 are exact in bf16 and in f16, and their
// products with bf16 or f16 x are exact in f32, so the tensor-core designs
// differ from the plain version only in the order of the f32 sums and the
// final rounding. Every sum order is fixed by the tiling (no split-K with
// atomics), so results are bitwise equal from run to run.
//
// The tensor-core designs widen in registers by bit tricks (widen4), not
// by conversion instructions, whose throughput is a small fraction of the
// FMA rate: into bf16 through an f32 add or multiply, into f16 by a
// half2 subtract (int8) or multiply (e4m3).
//
// C interface: device pointers on the caller's stream; the entry returns
// cudaGetLastError() after the launch.

#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace pdt_sm90;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(int8_t v) {
  return static_cast<float>(v);  // int8_t is signed: sign-extends
}
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 consecutive values at p (16-byte aligned) widened to f32
__device__ __forceinline__ void load16(const float* p, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
    f[4 * i] = v.x;
    f[4 * i + 1] = v.y;
    f[4 * i + 2] = v.z;
    f[4 * i + 3] = v.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[8 * i + j] = __bfloat162float(e[j]);
  }
}
__device__ __forceinline__ void load16(const __half* p, float* f) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const __half* e = reinterpret_cast<const __half*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[8 * i + j] = __half2float(e[j]);
  }
}
template <typename WT>
__device__ __forceinline__ void load16(const WT* p, float* f) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const WT* e = reinterpret_cast<const WT*>(&raw);
#pragma unroll
  for (int j = 0; j < 16; ++j) f[j] = to_f(e[j]);
}

// ---------------------------------------------------------------------------
// small M: CUDA cores, one warp per kRows weight rows, kM activation rows
// per block (grid.y walks M)
// ---------------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kRows = 4;
constexpr int kM = 8;

template <typename XT, typename WT, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
dequant_gemv_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                    const float* __restrict__ s, XT* __restrict__ y, int M,
                    int K, int N) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * kWarps + warp) * kRows;
  const int m0 = blockIdx.y * kM;
  const int mrows = min(kM, M - m0);
  if (n0 >= N) return;  // warp-uniform: no shuffle below misses a lane
  const XT* xb = x + size_t(m0) * K;
  float acc[kM][kRows];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[m][r] = 0.f;

  if constexpr (kVec) {
    // K % 16 == 0: lane chunks of 16 never straddle the end
    for (int k = lane * 16; k < K; k += 32 * 16) {
      float wf[kRows][16];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (n0 + r < N) {
          load16(w + size_t(n0 + r) * K + k, wf[r]);
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) wf[r][j] = 0.f;
        }
      }
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        if (m < mrows) {
          float xf[16];
          load16(xb + size_t(m) * K + k, xf);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int j = 0; j < 16; ++j) acc[m][r] += wf[r][j] * xf[j];
        }
      }
    }
  } else {
    for (int k = lane; k < K; k += 32) {
      float wf[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        wf[r] = n0 + r < N ? to_f(w[size_t(n0 + r) * K + k]) : 0.f;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        if (m < mrows) {
          const float xv = to_f(xb[size_t(m) * K + k]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[m][r] += wf[r] * xv;
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float v = warp_sum(acc[m][r]);
      if (lane == 0 && m < mrows && n0 + r < N)
        y[size_t(m0 + m) * N + n0 + r] = from_f<XT>(v * s[n0 + r]);
    }
  }
}

// ---------------------------------------------------------------------------
// shared by the tensor-core designs
// ---------------------------------------------------------------------------
// c += a . b, one m16n8k16 product in f32, XT = bf16 or f16
template <typename XT>
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  if constexpr (std::is_same<XT, bf16>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The four weight bytes of q (b0 lowest) widened to XT pairs: lo = (b0,
// b1), hi = (b2, b3), the first of each in the low half. Exact for every
// int8 and every finite e4m3 code.
//  * int8 -> bf16: each byte, biased to unsigned, becomes the low mantissa
//    byte of 2^23, so one FADD of -(2^23 + 128) recovers it as f32; its
//    upper half is the bf16 (|v| <= 128 has 8 significant bits).
//  * e4m3 -> bf16: sign and the 7 exponent/mantissa bits move into f32
//    position, and a multiply by 2^(127 - 7) rebiases the exponent; e4m3
//    subnormals arrive as f32 subnormals, which the multiply keeps exact.
//  * int8 -> f16: each biased byte becomes the low mantissa byte of 1024
//    (f16 0x64XX = 1024 + XX, exact), and one half2 subtract of 1152
//    (1024 + 128) gives two values at once.
//  * e4m3 -> f16: sign to bit 15, the exponent/mantissa bits to bits
//    13..7 (f16 exponent 0eeee, mantissa mmm0000000), then a half2
//    multiply by 2^8 rebiases (15 - 7); subnormals arrive as f16
//    subnormals (exact).
// (tests/test_torch_dequant_design.py emulates each on all 256 codes.)
template <typename XT, typename WT>
__device__ __forceinline__ void widen4(uint32_t q, uint32_t& lo,
                                       uint32_t& hi) {
  if constexpr (std::is_same<XT, bf16>::value) {
    float f[4];
    if constexpr (std::is_same<WT, int8_t>::value) {
      const uint32_t v = q ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[b] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 + b)) -
               8388736.0f;  // 2^23 + 128
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t t = __byte_perm(q, 0u, 0x0444 | (b << 12));
        f[b] = __uint_as_float((t & 0x80000000u) |
                               ((t >> 4) & 0x07F00000u)) *
               0x1p120f;
      }
    }
    lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  } else {
    if constexpr (std::is_same<WT, int8_t>::value) {
      const uint32_t v = q ^ 0x80808080u;
      const __half2 bias = __halves2half2(__ushort_as_half(0x6480),
                                          __ushort_as_half(0x6480));
      const uint32_t w0 = __byte_perm(v, 0x64646464u, 0x4140);
      const uint32_t w1 = __byte_perm(v, 0x64646464u, 0x4342);
      __half2 a = __hsub2(*reinterpret_cast<const __half2*>(&w0), bias);
      __half2 b = __hsub2(*reinterpret_cast<const __half2*>(&w1), bias);
      lo = *reinterpret_cast<uint32_t*>(&a);
      hi = *reinterpret_cast<uint32_t*>(&b);
    } else {
      const __half2 scale = __halves2half2(__ushort_as_half(0x5C00),
                                           __ushort_as_half(0x5C00));
      const uint32_t w0 = __byte_perm(q, 0u, 0x1404);  // [0, b0, 0, b1]
      const uint32_t w1 = __byte_perm(q, 0u, 0x3424);  // [0, b2, 0, b3]
      const uint32_t t0 = ((w0 >> 1) & 0x3F803F80u) | (w0 & 0x80008000u);
      const uint32_t t1 = ((w1 >> 1) & 0x3F803F80u) | (w1 & 0x80008000u);
      __half2 a = __hmul2(*reinterpret_cast<const __half2*>(&t0), scale);
      __half2 b = __hmul2(*reinterpret_cast<const __half2*>(&t1), scale);
      lo = *reinterpret_cast<uint32_t*>(&a);
      hi = *reinterpret_cast<uint32_t*>(&b);
    }
  }
}

// 16 weight bytes -> 8 words of XT pairs, in order
template <typename XT, typename WT>
__device__ __forceinline__ void widen16(uint4 raw, uint32_t* out) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    widen4<XT, WT>(words[i], out[2 * i], out[2 * i + 1]);
}

template <typename XT> __device__ __forceinline__ uint16_t to_bits(float v);
template <> __device__ __forceinline__ uint16_t to_bits<bf16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}
template <> __device__ __forceinline__ uint16_t to_bits<f16>(float v) {
  return __half_as_ushort(__float2half(v));
}

// ---------------------------------------------------------------------------
// mma.sync: 16-bit x, any shape. mma.sync.m16n8k16 on a 128 x 128 tile, 8
// warps as 2 x 4, each warp 64 x 32 (4 x 4 mma tiles). Two shared-memory
// stages: the next k tile's global loads are in flight in registers while
// the tensor cores work on the current one; fragments come from shared
// memory by ldmatrix.
// ---------------------------------------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLd = kBK + 8;  // row pitch in 16-bit elements: 80 bytes
constexpr int kMmaThreads = 256;

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// one k tile into registers: two chunks of 8 x values and one chunk of 16
// weights per thread, zero past every edge
template <typename WT, bool kVec>
__device__ __forceinline__ void fetch_tile(const uint16_t* x, const WT* w,
                                           int M, int K, int N, int m0,
                                           int n0, int k0, int tid,
                                           uint4* xr, uint4& wr) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kMmaThreads;
    const int gm = m0 + (c >> 2), gk = k0 + (c & 3) * 8;
    if (kVec && gm < M && gk + 8 <= K) {
      xr[i] = __ldg(reinterpret_cast<const uint4*>(x + size_t(gm) * K + gk));
    } else {
      __align__(16) uint16_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = gm < M && gk + j < K ? x[size_t(gm) * K + gk + j] : 0;
      xr[i] = *reinterpret_cast<const uint4*>(e);
    }
  }
  const int gn = n0 + (tid >> 1), gk = k0 + (tid & 1) * 16;
  if (kVec && gn < N && gk + 16 <= K) {
    wr = __ldg(reinterpret_cast<const uint4*>(w + size_t(gn) * K + gk));
  } else {
    __align__(16) uint8_t e[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      e[j] = gn < N && gk + j < K
                 ? reinterpret_cast<const uint8_t*>(w)[size_t(gn) * K + gk + j]
                 : 0;  // int8 0 and e4m3 +0 alike
    wr = *reinterpret_cast<const uint4*>(e);
  }
}

template <typename XT, typename WT, bool kVec>
__global__ void __launch_bounds__(kMmaThreads)
dequant_mma_kernel(const uint16_t* __restrict__ x, const WT* __restrict__ w,
                   const float* __restrict__ s, uint16_t* __restrict__ y,
                   int M, int K, int N) {
  __shared__ __align__(16) uint16_t xs[2][kBM][kLd];
  __shared__ __align__(16) uint16_t ws[2][kBN][kLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  uint4 xr[2], wr;
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kMmaThreads;
      *reinterpret_cast<uint4*>(&xs[buf][c >> 2][(c & 3) * 8]) = xr[i];
    }
    uint32_t h[8];
    widen16<XT, WT>(wr, h);
    uint4* dst = reinterpret_cast<uint4*>(&ws[buf][tid >> 1][(tid & 1) * 16]);
    dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
    dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
  };
  const int tiles = (K + kBK - 1) / kBK;
  fetch_tile<WT, kVec>(x, w, M, K, N, m0, n0, 0, tid, xr, wr);
  stage(0);
  __syncthreads();
  for (int kt = 0; kt < tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < tiles)
      fetch_tile<WT, kVec>(x, w, M, K, N, m0, n0, (kt + 1) * kBK, tid, xr,
                           wr);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(a[i], &xs[buf][wm * 64 + i * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, &ws[buf][wn * 32 + (2 * jp + (lane >> 4)) * 8 +
                            (lane & 7)][kk + ((lane >> 3) & 1) * 8]);
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816<XT>(acc[i][j], a[i], b[j]);
    }
    // the other stage was last read in iteration kt - 1, which every warp
    // finished before the barrier that ended it
    if (kt + 1 < tiles) stage(buf ^ 1);
    __syncthreads();
  }

  // epilogue: c0, c1 at (row g, cols c2, c2 + 1), c2, c3 at row g + 8
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn * 32 + j * 8 + c2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + i * 16 + g + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n + e < N)
            y[size_t(m) * N + n + e] =
                to_bits<XT>(acc[i][j][2 * h + e] * s[n + e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// decode: 16-bit x, M <= 8, K % 64 == 0. Tensor cores with the weight rows
// on the mma's M side (16 per block) and the tokens on its N side (8), so
// one m16n8k16 covers a decode step's 8 slots. The contraction order is
// free, so each lane takes 16 consecutive k of its rows and of its token's
// x row (16-byte loads) and feeds them to four mma k-steps under one
// permutation of k shared by A and B. The block's 8 warps split K and add
// their partial tiles in shared memory; the scale multiplies the sum.
// ---------------------------------------------------------------------------
constexpr int kDecWarps = 8;

template <typename XT, typename WT>
__global__ void __launch_bounds__(kDecWarps * 32)
dequant_decode_kernel(const uint16_t* __restrict__ x,
                      const WT* __restrict__ w, const float* __restrict__ s,
                      uint16_t* __restrict__ y, int M, int K, int N) {
  __shared__ float part[kDecWarps][16][8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * 16;
  // this lane's weight rows (clamped at the edge; masked at the store) and
  // token row (absent tokens feed zeros)
  const WT* w0 = w + size_t(min(n0 + g, N - 1)) * K + t * 16;
  const WT* w1 = w + size_t(min(n0 + g + 8, N - 1)) * K + t * 16;
  const bool has_x = g < M;
  const uint16_t* xr = x + size_t(has_x ? g : 0) * K + t * 16;
  const int chunks = K / 64;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  int ch = warp;
  uint4 wa = make_uint4(0, 0, 0, 0), wb = wa;
  if (ch < chunks) {
    wa = __ldg(reinterpret_cast<const uint4*>(w0 + size_t(ch) * 64));
    wb = __ldg(reinterpret_cast<const uint4*>(w1 + size_t(ch) * 64));
  }
  for (; ch < chunks; ch += kDecWarps) {
    // the next chunk's weights are in flight while this one computes
    uint4 na = wa, nb = wb;
    if (ch + kDecWarps < chunks) {
      const size_t nk = size_t(ch + kDecWarps) * 64;
      na = __ldg(reinterpret_cast<const uint4*>(w0 + nk));
      nb = __ldg(reinterpret_cast<const uint4*>(w1 + nk));
    }
    uint4 xa = make_uint4(0, 0, 0, 0), xb = xa;
    if (has_x) {
      const uint4* xp = reinterpret_cast<const uint4*>(xr + size_t(ch) * 64);
      xa = __ldg(xp);
      xb = __ldg(xp + 1);
    }
    uint32_t a0[8], a1[8];
    widen16<XT, WT>(wa, a0);
    widen16<XT, WT>(wb, a1);
    const uint32_t xw[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // mma k (2t, 2t + 1) <- k 4j + (0, 1) of the lane's 16; (2t + 8,
      // 2t + 9) <- 4j + (2, 3): the same permutation for A and B
      const uint32_t a[4] = {a0[2 * j], a1[2 * j], a0[2 * j + 1],
                             a1[2 * j + 1]};
      const uint32_t b[2] = {xw[2 * j], xw[2 * j + 1]};
      mma16816<XT>(c, a, b);
    }
    wa = na;
    wb = nb;
  }
  // c0, c1: weight row g, tokens 2t, 2t + 1; c2, c3: weight row g + 8
  part[warp][g][2 * t] = c[0];
  part[warp][g][2 * t + 1] = c[1];
  part[warp][g + 8][2 * t] = c[2];
  part[warp][g + 8][2 * t + 1] = c[3];
  __syncthreads();
  if (threadIdx.x < 128) {
    const int r = threadIdx.x >> 3, m = threadIdx.x & 7;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kDecWarps; ++i) sum += part[i][r][m];
    if (m < M && n0 + r < N)
      y[size_t(m) * N + n0 + r] = to_bits<XT>(sum * s[n0 + r]);
  }
}

// ---------------------------------------------------------------------------
// wgmma: 16-bit x, M > 8 (admission). A block computes y^T for 128 output
// channels x 256 tokens: two consumer warpgroups of 64 channels (the
// weight rows, wgmma's M, widened in registers into the A fragments) and
// one producer warp (setmaxnreg 240 / 24) that feeds a ring of four stages
// by TMA.
// ---------------------------------------------------------------------------
constexpr int kQBM = 128;     // output channels a block
constexpr int kQBN = 256;     // tokens a block: wgmma's N
constexpr int kQBK = 64;      // k a stage
constexpr int kQStages = 4;
constexpr int kQThreads = 384;
constexpr int kQGroup = 16;   // channel tiles a group of the block order

struct QLayout {
  static constexpr int kW = kQBM * kQBK;           // raw weight bytes a stage
  static constexpr int kX = kQBN * 128;            // 256 tokens x 64 k
  static constexpr int kStage = kW + kX;           // 40960: 1024-aligned
  static constexpr int kRing = kQStages * kStage;
  static constexpr int kBytes = kRing + 16 * kQStages + 1024;  // + barriers
  // the epilogue's transposed tile, in the ring: a token's 128 outputs and
  // 16 bytes of padding (rows 2 apart land 8 banks apart)
  static constexpr int kPitch = 2 * kQBM + 16;
};
static_assert(kQBN * QLayout::kPitch <= QLayout::kRing,
              "the epilogue tile fits in the ring");

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of weight chunk kk (16 bytes: k 16kk..16kk+15) of row `row`
// in a stage's tile of 64-byte rows under TMA's 64-byte swizzle (address
// bits 4-5 XOR bits 7-8: the chunk XOR (row / 2) % 4).
__device__ __forceinline__ int w_chunk(int row, int kk) {
  return row * 64 + ((kk ^ ((row >> 1) & 3)) << 4);
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(kQThreads, 1)
    dequant_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                         const __grid_constant__ CUtensorMap tx,
                         const float* __restrict__ s,
                         uint16_t* __restrict__ y, int M, int K, int N) {
  using L = QLayout;
  constexpr int NS = kQStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  unsigned char* gbase = smem + (base - smem_addr(smem));
  const uint32_t full = base + L::kRing, empty = full + 8 * NS;
  // the block order: groups of kQGroup channel tiles, the token tiles of a
  // group after each other, its channel tiles fastest
  const int nwt = (N + kQBM - 1) / kQBM, ntt = (M + kQBN - 1) / kQBN;
  const int span = kQGroup * ntt;
  const int grp = blockIdx.x / span, in = blockIdx.x - grp * span;
  const int gw = min(kQGroup, nwt - grp * kQGroup);
  const int n0 = (grp * kQGroup + in % gw) * kQBM, m0 = (in / gw) * kQBN;
  const int nk = (K + kQBK - 1) / kQBK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 8);  // every warp of both consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(24));
    if (threadIdx.x != 256) return;
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % NS;
      mbar_wait(empty + 8 * st, ((kt / NS) & 1) ^ 1);
      mbar_expect_tx(full + 8 * st, L::kStage);
      const uint32_t ws = base + st * L::kStage;
      tma_load_2d(ws, &tw, full + 8 * st, kt * kQBK, n0);
      tma_load_2d(ws + L::kW, &tx, full + 8 * st, kt * kQBK, m0);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(240));
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  float acc[kQBN / 2];
#pragma unroll
  for (int i = 0; i < kQBN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % NS;
    mbar_wait(full + 8 * st, (kt / NS) & 1);
    const uint32_t ws = base + st * L::kStage, xs = ws + L::kW;
    const unsigned char* wsg = gbase + st * L::kStage;
    if (kt == 0) reg_fence(acc);  // the zeros are in place
    // A fragment of k step kk: a[kk][0] = row g, k (2t, 2t + 1);
    // [1] = row g + 8, the same k; [2], [3] = k (2t + 8, 2t + 9). A lane
    // reads word t / 2 and word 2 + t / 2 of the row's 16-byte chunk (a
    // quad's four lanes read two words; the swizzle puts the 8 rows of a
    // warp's read on 8 different bank groups) and keeps the half it
    // needs.
    uint32_t a[4][4];
    const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 64 * wg + 16 * warp + g + 8 * h;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t* p = reinterpret_cast<const uint32_t*>(
            wsg + w_chunk(row, kk)) + (t >> 1);
        widen4<XT, WT>(__byte_perm(p[0], p[2], sel), a[kk][h],
                       a[kk][2 + h]);
      }
    }
    reg_fence(a);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_rs<XT, kQBN, 0>(acc, a[kk], desc_kmajor(xs, kk));
    wg_commit();
    wg_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }
  reg_fence(acc);

  // epilogue: both consumers are past their last products and the
  // producer's loads have all landed, so the ring is free. Accumulator
  // element i is channel g + 8 ((i >> 1) & 1) of the warp's 16, token
  // 8 (i >> 2) + 2t + (i & 1); scaled, rounded and stored transposed.
  named_sync(3, 256);
  const int nl = 64 * wg + 16 * warp + g;
  const float s0 = n0 + nl < N ? s[n0 + nl] : 0.f;
  const float s1 = n0 + nl + 8 < N ? s[n0 + nl + 8] : 0.f;
  uint16_t* tile = reinterpret_cast<uint16_t*>(gbase);
  constexpr int P = L::kPitch / 2;
#pragma unroll
  for (int c = 0; c < kQBN / 8; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int tok = 8 * c + 2 * t + e;
      tile[tok * P + nl] = to_bits<XT>(acc[4 * c + e] * s0);
      tile[tok * P + nl + 8] = to_bits<XT>(acc[4 * c + 2 + e] * s1);
    }
  named_sync(3, 256);
  const bool vec = N % 8 == 0;
  for (int i = threadIdx.x; i < kQBN * (kQBM / 8); i += 256) {
    const int tok = i / (kQBM / 8), ch = i % (kQBM / 8);
    const int m = m0 + tok, n = n0 + 8 * ch;
    if (m >= M || n >= N) continue;
    const uint16_t* src = tile + tok * P + 8 * ch;
    uint16_t* dst = y + size_t(m) * N + n;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && n + j < N; ++j) dst[j] = src[j];
    }
  }
}

template <typename XT, typename WT>
cudaError_t launch_gemv(const void* x, const void* w, const float* s,
                        void* y, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + kWarps * kRows - 1) / (kWarps * kRows),
                  (M + kM - 1) / kM);
  const bool vec = K % 16 == 0 && aligned16(x) && aligned16(w);
  const XT* xp = static_cast<const XT*>(x);
  const WT* wp = static_cast<const WT*>(w);
  XT* yp = static_cast<XT*>(y);
  if (vec)
    dequant_gemv_kernel<XT, WT, true>
        <<<grid, kWarps * 32, 0, stream>>>(xp, wp, s, yp, M, K, N);
  else
    dequant_gemv_kernel<XT, WT, false>
        <<<grid, kWarps * 32, 0, stream>>>(xp, wp, s, yp, M, K, N);
  return cudaGetLastError();
}

template <typename XT, typename WT>
cudaError_t launch_mma(const void* x, const void* w, const float* s,
                       void* y, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const bool vec = K % 16 == 0 && aligned16(x) && aligned16(w);
  const uint16_t* xp = static_cast<const uint16_t*>(x);
  const WT* wp = static_cast<const WT*>(w);
  uint16_t* yp = static_cast<uint16_t*>(y);
  if (vec)
    dequant_mma_kernel<XT, WT, true>
        <<<grid, kMmaThreads, 0, stream>>>(xp, wp, s, yp, M, K, N);
  else
    dequant_mma_kernel<XT, WT, false>
        <<<grid, kMmaThreads, 0, stream>>>(xp, wp, s, yp, M, K, N);
  return cudaGetLastError();
}

template <typename XT, typename WT>
cudaError_t launch_wgmma(const void* x, const void* w, const float* s,
                         void* y, int M, int K, int N, int x_dtype,
                         cudaStream_t stream) {
  if (!bind_device(x)) return cudaErrorInvalidValue;
  CUtensorMap tw, tx;
  const cuuint64_t wdims[2] = {cuuint64_t(K), cuuint64_t(N)};
  const cuuint64_t wstr[1] = {cuuint64_t(K)};
  const cuuint32_t wbox[2] = {kQBK, kQBM};
  const cuuint64_t xdims[2] = {cuuint64_t(K), cuuint64_t(M)};
  const cuuint64_t xstr[1] = {cuuint64_t(K) * 2};
  const cuuint32_t xbox[2] = {kQBK, kQBN};
  if (!make_map(&tw, w, 2, wdims, wstr, wbox, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_tiled_map(&tx, x, 2, xdims, xstr, xbox, x_dtype))
    return cudaErrorInvalidValue;
  auto kernel = dequant_wgmma_kernel<XT, WT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, QLayout::kBytes);
  if (err != cudaSuccess) return err;
  const int blocks = ((N + kQBM - 1) / kQBM) * ((M + kQBN - 1) / kQBN);
  kernel<<<blocks, kQThreads, QLayout::kBytes, stream>>>(
      tw, tx, s, static_cast<uint16_t*>(y), M, K, N);
  return cudaGetLastError();
}

// design: 0 decode, 1 wgmma, 2 mma.sync, 3 CUDA cores
template <typename XT, typename WT>
cudaError_t launch16(const void* x, const void* w, const float* s, void* y,
                     int M, int K, int N, int x_dtype, int design,
                     cudaStream_t stream) {
  switch (design) {
    case 0:
      if (M > 8 || K % 64 != 0 || !aligned16(x) || !aligned16(w))
        return cudaErrorInvalidValue;
      dequant_decode_kernel<XT, WT>
          <<<(N + 15) / 16, kDecWarps * 32, 0, stream>>>(
              static_cast<const uint16_t*>(x), static_cast<const WT*>(w), s,
              static_cast<uint16_t*>(y), M, K, N);
      return cudaGetLastError();
    case 1:
      if (K % 16 != 0 || !aligned16(x) || !aligned16(w) || !aligned16(y))
        return cudaErrorInvalidValue;
      return launch_wgmma<XT, WT>(x, w, s, y, M, K, N, x_dtype, stream);
    case 2:
      return launch_mma<XT, WT>(x, w, s, y, M, K, N, stream);
    case 3:
      return launch_gemv<XT, WT>(x, w, s, y, M, K, N, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename WT>
cudaError_t launch(const void* x, const void* w, const float* s, void* y,
                   int M, int K, int N, int x_dtype, int design,
                   cudaStream_t stream) {
  if (x_dtype == 1)
    return launch16<bf16, WT>(x, w, s, y, M, K, N, x_dtype, design, stream);
  if (x_dtype == 2)
    return launch16<f16, WT>(x, w, s, y, M, K, N, x_dtype, design, stream);
  if (design != 3) return cudaErrorInvalidValue;  // f32: CUDA cores only
  return launch_gemv<float, WT>(x, w, s, y, M, K, N, stream);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x and y share it).
// w_dtype: 0 = int8, 1 = float8_e4m3fn. design: 0 decode, 1 wgmma, 2
// mma.sync, 3 CUDA cores; cudaErrorInvalidValue for an input the design
// does not take.
extern "C" int pdt_dequant_matmul(const void* x, const void* w,
                                  const void* scale, void* y, int M, int K,
                                  int N, int x_dtype, int w_dtype,
                                  int design, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || (x_dtype < 0 || x_dtype > 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  switch (w_dtype) {
    case 0:
      return launch<int8_t>(x, w, s, y, M, K, N, x_dtype, design, st);
    case 1:
      return launch<__nv_fp8_e4m3>(x, w, s, y, M, K, N, x_dtype, design, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
