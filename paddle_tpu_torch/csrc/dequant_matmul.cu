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
// Three paths, picked by the launcher:
//  * decode: bf16 x with M <= 8 (the 8 slots, the lm_head's 8 sampled rows)
//    and K % 64 == 0. What bounds it is bytes: the weight dominates (1 byte
//    per element against 16 bytes of x per k, which stays in L1/L2). Tensor
//    cores take the math off the CUDA cores, with the weight rows on the
//    mma's 16-row side and the tokens on its 8-column side; weights widen to
//    bf16 in registers by bit tricks (no conversion instructions), the
//    block's warps split K, and the next chunk's loads are issued before the
//    current one computes.
//  * every other small M, and every f32 or f16 x: CUDA cores. Each warp
//    streams kRows weight rows with 16-byte loads (16 int8 / e4m3 values a
//    lane), widens them to f32 in registers, multiplies them with up to 8
//    activation rows, and reduces with warp shuffles; the scale multiplies
//    the reduced sum. f32 x never goes through TF32.
//  * bf16 x with M > 16 (admission batches): tensor cores. A 128 x 128
//    output tile per block, K in steps of 32 through two shared-memory
//    stages (the next tile's global loads wait in registers while the
//    current one is multiplied); each int8 / e4m3 weight tile is widened to
//    bf16 as it is staged (exact: both fit bf16's significand and range),
//    fragments load by ldmatrix, and mma.sync.m16n8k16 bf16 accumulates in
//    f32. The products are exact in f32, so only the order of the sums
//    differs from the plain version. At M = 6432 this is bound by
//    operations; wgmma with TMA-fed stages is later work.
//
// The tensor-core paths widen in registers by bit tricks (widen16), not by
// conversion instructions, whose throughput is a small fraction of the
// FMA rate.
//
// C interface: device pointers on the caller's stream; the entry returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

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
// shared by the tensor-core paths
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 int8 -> 8 words of bf16 pairs (exact: |v| <= 128 has 8 significant
// bits). Each byte, biased to unsigned, becomes the low mantissa byte of
// 2^23, so one FADD recovers it as f32; its upper half is the bf16.
__device__ __forceinline__ void widen16(uint4 raw, const int8_t*,
                                        uint32_t* out) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t v = words[i] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 + b)) -
             8388736.0f;  // 2^23 + 128
    out[2 * i] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]),
                             0x7632);
    out[2 * i + 1] = __byte_perm(__float_as_uint(f[2]),
                                 __float_as_uint(f[3]), 0x7632);
  }
}

// 16 e4m3 -> 8 words of bf16 pairs (exact: 3 mantissa bits). Sign and the
// 7 exponent/mantissa bits move into f32 position, and a multiply by
// 2^(127 - 7) rebiases the exponent; e4m3 subnormals arrive as f32
// subnormals, which the multiply keeps exact (no flush to zero).
__device__ __forceinline__ void widen16(uint4 raw, const __nv_fp8_e4m3*,
                                        uint32_t* out) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t t = __byte_perm(words[i], 0u, 0x0444 | (b << 12));
      f[b] = __uint_as_float((t & 0x80000000u) | ((t >> 4) & 0x07F00000u)) *
             0x1p120f;
    }
    out[2 * i] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]),
                             0x7632);
    out[2 * i + 1] = __byte_perm(__float_as_uint(f[2]),
                                 __float_as_uint(f[3]), 0x7632);
  }
}

// ---------------------------------------------------------------------------
// bf16 x, M > 16: mma.sync.m16n8k16 on a 128 x 128 tile, 8 warps as 2 x 4,
// each warp 64 x 32 (4 x 4 mma tiles). Two shared-memory stages: the next
// k tile's global loads are in flight in registers while the tensor cores
// work on the current one; fragments come from shared memory by ldmatrix.
// ---------------------------------------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLd = kBK + 8;  // row pitch in bf16: 80 bytes, conflict-free
constexpr int kMmaThreads = 256;

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// one k tile into registers: two chunks of 8 bf16 of x and one chunk of 16
// weights per thread, zero past every edge
template <typename WT, bool kVec>
__device__ __forceinline__ void fetch_tile(const __nv_bfloat16* x,
                                           const WT* w, int M, int K, int N,
                                           int m0, int n0, int k0, int tid,
                                           uint4* xr, uint4& wr) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kMmaThreads;
    const int gm = m0 + (c >> 2), gk = k0 + (c & 3) * 8;
    if (kVec && gm < M && gk + 8 <= K) {
      xr[i] = __ldg(reinterpret_cast<const uint4*>(x + size_t(gm) * K + gk));
    } else {
      __align__(16) __nv_bfloat16 e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = gm < M && gk + j < K ? x[size_t(gm) * K + gk + j]
                                    : __float2bfloat16(0.f);
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

template <typename WT, bool kVec>
__global__ void __launch_bounds__(kMmaThreads)
dequant_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const WT* __restrict__ w, const float* __restrict__ s,
                   __nv_bfloat16* __restrict__ y, int M, int K, int N) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][kBM][kLd];
  __shared__ __align__(16) __nv_bfloat16 ws[2][kBN][kLd];
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
    widen16(wr, static_cast<const WT*>(nullptr), h);
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
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
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
                __float2bfloat16(acc[i][j][2 * h + e] * s[n + e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 x, M <= 8, K % 64 == 0 (decode): tensor cores with the weight rows
// on the mma's M side (16 per block) and the tokens on its N side (8), so
// one m16n8k16 covers a decode step's 8 slots. The contraction order is
// free, so each lane takes 16 consecutive k of its rows and of its token's
// x row (16-byte loads) and feeds them to four mma k-steps under one
// permutation of k shared by A and B. The block's 8 warps split K and add
// their partial tiles in shared memory; the scale multiplies the sum.
// ---------------------------------------------------------------------------
constexpr int kDecWarps = 8;

template <typename WT>
__global__ void __launch_bounds__(kDecWarps * 32)
dequant_decode_kernel(const __nv_bfloat16* __restrict__ x,
                      const WT* __restrict__ w, const float* __restrict__ s,
                      __nv_bfloat16* __restrict__ y, int M, int K, int N) {
  __shared__ float part[kDecWarps][16][8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * 16;
  // this lane's weight rows (clamped at the edge; masked at the store) and
  // token row (absent tokens feed zeros)
  const WT* w0 = w + size_t(min(n0 + g, N - 1)) * K + t * 16;
  const WT* w1 = w + size_t(min(n0 + g + 8, N - 1)) * K + t * 16;
  const bool has_x = g < M;
  const __nv_bfloat16* xr = x + size_t(has_x ? g : 0) * K + t * 16;
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
    widen16(wa, static_cast<const WT*>(nullptr), a0);
    widen16(wb, static_cast<const WT*>(nullptr), a1);
    const uint32_t xw[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // mma k (2t, 2t + 1) <- k 4j + (0, 1) of the lane's 16; (2t + 8,
      // 2t + 9) <- 4j + (2, 3): the same permutation for A and B
      const uint32_t a[4] = {a0[2 * j], a1[2 * j], a0[2 * j + 1],
                             a1[2 * j + 1]};
      const uint32_t b[2] = {xw[2 * j], xw[2 * j + 1]};
      mma_bf16(c, a, b);
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
      y[size_t(m) * N + n0 + r] = __float2bfloat16(sum * s[n0 + r]);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

template <typename WT>
cudaError_t launch_mma(const void* x, const void* w, const float* s,
                       void* y, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const bool vec = K % 16 == 0 && aligned16(x) && aligned16(w);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const WT* wp = static_cast<const WT*>(w);
  __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
  if (vec)
    dequant_mma_kernel<WT, true>
        <<<grid, kMmaThreads, 0, stream>>>(xp, wp, s, yp, M, K, N);
  else
    dequant_mma_kernel<WT, false>
        <<<grid, kMmaThreads, 0, stream>>>(xp, wp, s, yp, M, K, N);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t launch(const void* x, const void* w, const float* s, void* y,
                   int M, int K, int N, int x_dtype, cudaStream_t stream) {
  if (x_dtype == 1 && M <= 8 && K % 64 == 0 && aligned16(x) &&
      aligned16(w)) {
    dequant_decode_kernel<WT><<<(N + 15) / 16, kDecWarps * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const WT*>(w), s,
        static_cast<__nv_bfloat16*>(y), M, K, N);
    return cudaGetLastError();
  }
  if (x_dtype == 1 && M > 16)
    return launch_mma<WT>(x, w, s, y, M, K, N, stream);
  if (x_dtype == 1)
    return launch_gemv<__nv_bfloat16, WT>(x, w, s, y, M, K, N, stream);
  if (x_dtype == 2)
    return launch_gemv<__half, WT>(x, w, s, y, M, K, N, stream);
  return launch_gemv<float, WT>(x, w, s, y, M, K, N, stream);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x and y share it).
// w_dtype: 0 = int8, 1 = float8_e4m3fn.
extern "C" int pdt_dequant_matmul(const void* x, const void* w,
                                  const void* scale, void* y, int M, int K,
                                  int N, int x_dtype, int w_dtype,
                                  void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || (x_dtype < 0 || x_dtype > 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  switch (w_dtype) {
    case 0:
      return launch<int8_t>(x, w, s, y, M, K, N, x_dtype, st);
    case 1:
      return launch<__nv_fp8_e4m3>(x, w, s, y, M, K, N, x_dtype, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
