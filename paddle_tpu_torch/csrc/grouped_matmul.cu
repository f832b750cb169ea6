// Grouped (ragged) matmul for Hopper (sm_90a): out[r] = lhs[r] @ B_g(r),
// where the rows of lhs are sorted by group and group_sizes[e] of them
// belong to group e (an MoE layer's experts). Rows past
// sum(group_sizes) are written as zeros.
//
// Replaces: paddle_tpu/ops/grouped_matmul.py:_gmm_kernel (launched by
// gmm_pallas, pallas_call at :98), in the forward and in the backward's
// d(lhs) (:137-143, there on swapaxes(rhs, 1, 2)).
//
// Layout: lhs (M, K) row-major; rhs (E, K, N) row-major (the JAX layout,
// `trans` = 0), or rhs (E, N, K) read as its transpose (`trans` = 1: the
// backward's dout @ rhs[e]^T without writing rhs^T anywhere); out (M, N)
// in lhs's dtype. bf16, f16 or f32 (lhs, rhs and out share it), any M, K,
// N.
//
// Work list (megablox-style). The TPU kernel needs every group padded to a
// multiple of its 128-row tile, so no tile straddles two groups; the MoE
// dispatch pads for it (paddle_tpu/incubate/moe/__init__.py:153-169), up
// to 25% more rows at A14B. Here the groups stay unpadded: a first
// one-block kernel reads group_sizes on the device (no copy to the host)
// and lists every (m tile, group) pair that shares rows, as (tile, group,
// first row, end row); the rows past the last group are one more
// pseudo-group whose items write zeros. The main kernel runs one block per
// (item, n tile): a tile that straddles a group boundary is computed once
// for each group with the other group's rows zero-filled on load and
// masked on store. Items past the list's end exit at once. Every output
// row is written exactly once, by one block, with no atomics.
//
// What bounds it on this card: operations. At the A14B expert shapes (M =
// 32768 routed rows, (K, N) = (3584, 2560) and (2560, 3584), E = 64) the
// product is 2 M K N = 601 GFLOP against ~0.47 GB of operands: ~0.61 ms of
// bf16 tensor-core time, 0.14 ms of bytes. The bf16 path is a 128 x 128
// output tile per block, 8 warps as 2 x 4 of 64 x 32, K in steps of 32
// through a ring of four shared-memory stages fed by cp.async (three
// steps' copies are in flight while the tensor cores work on the fourth;
// with two stages the copy of one step had only one step of mma to hide
// behind), fragments by ldmatrix (.trans for the (K, N) layout, so no
// tile is transposed in shared memory), mma.sync.m16n8k16 bf16 with f32
// accumulation, one rounding to bf16 in the epilogue; f16 is the same
// kernel on mma.sync's f16 form. wgmma with TMA-fed
// stages is later work. f32 runs on CUDA cores (64 x 64 tiles, 4 x 4
// outputs a thread, exact f32 FMAs, no TF32), as the JAX package's f32
// matmul does.
//
// C interface: device pointers on the caller's stream; the entry returns
// cudaGetLastError() after its two launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// item.y: the group, -1 for rows past the last group (zeros), -2 for an
// unused slot at the end of the list
constexpr int kZeros = -1;
constexpr int kUnused = -2;

// One block lists the work items. Its threads copy group_sizes to shared
// memory; thread 0 then walks the groups in order (E + 1 ranges that
// partition [0, M), so at most ceil(M / bm) + E items) and fills the rest
// of the list with unused slots.
__global__ void gmm_plan_kernel(const int* __restrict__ sizes, int E, int M,
                                int bm, int4* __restrict__ work, int wmax) {
  extern __shared__ int ssz[];
  for (int e = threadIdx.x; e < E; e += blockDim.x) ssz[e] = sizes[e];
  __syncthreads();
  if (threadIdx.x != 0) return;
  int w = 0, start = 0;
  for (int e = 0; e <= E; ++e) {
    int end = M;
    if (e < E) {
      const int s = ssz[e];
      end = s <= 0 ? start : (s >= M - start ? M : start + s);
    }
    for (int t = start / bm; t * bm < end && w < wmax; ++t)
      work[w++] = make_int4(t, e < E ? e : kZeros, max(start, t * bm),
                            min(end, (t + 1) * bm));
    start = end;
  }
  for (; w < wmax; ++w) work[w] = make_int4(0, kUnused, 0, 0);
}

// ---------------------------------------------------------------------------
// bf16 and f16: mma.sync on 128 x 128 tiles
// ---------------------------------------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;
constexpr int kStages = 4;
constexpr int kLdA = kBK + 8;    // A tile [m][k]: 80-byte rows
constexpr int kLdBnk = kBK + 8;  // B tile [n][k] (trans): 80-byte rows
constexpr int kLdBkn = kBN + 8;  // B tile [k][n]: 272-byte rows
// 80 and 272 bytes are 16 mod 128 and 5 x 16, 17 x 16: the eight rows an
// ldmatrix reads fall in distinct banks, and every row starts 16-byte
// aligned for cp.async

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b, const bf16*) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b, const __half*) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two adjacent outputs, rounded once each, in one 4-byte store
__device__ __forceinline__ void store2(bf16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* o, float a, float b) {
  *reinterpret_cast<__half2*>(o) = __floats2half2_rn(a, b);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes global -> shared, asynchronously; `pred` false writes zeros
// (no byte is read, and `src` is then any valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage one K step (k0 .. k0 + 31) of the A rows [r0, r1) of m tile m0
// (other rows zero) and of the B tile at n0. kVec (K % 8 == 0, N % 8 == 0
// and 16-byte aligned bases) copies 16-byte chunks with cp.async, which
// lie wholly inside or wholly outside the matrix; otherwise element loads.
template <typename T, bool kBnk, bool kVec>
__device__ __forceinline__ void gmm_stage(
    const T* __restrict__ lhs, const T* __restrict__ B, T* As, T* Bs, int m0,
    int r0, int r1, int n0, int k0, int K, int N, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;
    // A: 128 rows x 4 chunks of 8
    {
      const int row = c >> 2, kc = (c & 3) * 8;
      const int gm = m0 + row, gk = k0 + kc;
      const bool rows_ok = gm >= r0 && gm < r1;
      T* dst = As + row * kLdA + kc;
      if (kVec) {
        const bool ok = rows_ok && gk < K;
        cp_async16(dst, ok ? lhs + size_t(gm) * K + gk : lhs, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = rows_ok && gk + j < K ? lhs[size_t(gm) * K + gk + j]
                                         : from_f<T>(0.f);
      }
    }
    if (kBnk) {
      // B [n][k]: 128 rows of n x 4 chunks of 8 k
      const int n = c >> 2, kc = (c & 3) * 8;
      const int gn = n0 + n, gk = k0 + kc;
      T* dst = Bs + n * kLdBnk + kc;
      if (kVec) {
        const bool ok = gn < N && gk < K;
        cp_async16(dst, ok ? B + size_t(gn) * K + gk : B, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = gn < N && gk + j < K ? B[size_t(gn) * K + gk + j]
                                        : from_f<T>(0.f);
      }
    } else {
      // B [k][n]: 32 rows of k x 16 chunks of 8 n
      const int k = c >> 4, nc = (c & 15) * 8;
      const int gk = k0 + k, gn = n0 + nc;
      T* dst = Bs + k * kLdBkn + nc;
      if (kVec) {
        const bool ok = gk < K && gn < N;
        cp_async16(dst, ok ? B + size_t(gk) * N + gn : B, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = gk < K && gn + j < N ? B[size_t(gk) * N + gn + j]
                                        : from_f<T>(0.f);
      }
    }
  }
}

constexpr int kAStage = kBM * kLdA;
template <bool kBnk>
__host__ __device__ constexpr int b_stage() {
  return kBnk ? kBN * kLdBnk : kBK * kLdBkn;
}
// dynamic shared memory of the ring: 80 KB (trans) or 74 KB
template <bool kBnk>
constexpr size_t gmm_smem() {
  return sizeof(bf16) * kStages * (kAStage + b_stage<kBnk>());
}

template <typename T, bool kBnk, bool kVec>
__global__ void __launch_bounds__(kThreads)
gmm_mma_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
               const int4* __restrict__ work, int wmax,
               T* __restrict__ out, int K, int N) {
  constexpr int kBStage = b_stage<kBnk>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [kStages][kAStage]
  T* Bs = As + kStages * kAStage;      // [kStages][kBStage]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int n0 = blockIdx.x * kBN;
  for (int w = blockIdx.y; w < wmax; w += gridDim.y) {
    const int4 item = work[w];
    if (item.y == kUnused) return;  // the list's unused tail
    const int m0 = item.x * kBM, r0 = item.z, r1 = item.w;
    if (item.y == kZeros) {
      for (int i = tid; i < (r1 - r0) * kBN; i += kThreads) {
        const int r = r0 + i / kBN, c = n0 + i % kBN;
        if (c < N) out[size_t(r) * N + c] = from_f<T>(0.f);
      }
      continue;
    }
    const T* B = rhs + size_t(item.y) * K * N;
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    const int tiles = (K + kBK - 1) / kBK;
    // prologue: steps 0 .. kStages - 2 in flight, one commit group each
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < tiles)
        gmm_stage<T, kBnk, kVec>(lhs, B, As + st * kAStage, Bs + st * kBStage,
                              m0, r0, r1, n0, st * kBK, K, N, tid);
      cp_commit();
    }
    for (int kt = 0; kt < tiles; ++kt) {
      // kStages - 1 + kt groups committed: all but the newest
      // kStages - 2 landed, so step kt has
      cp_wait<kStages - 2>();
      // step kt is visible to every warp, and every warp is done with
      // step kt - 1, whose slot the next copy refills
      __syncthreads();
      const int nxt = kt + kStages - 1;
      if (nxt < tiles)
        gmm_stage<T, kBnk, kVec>(lhs, B, As + (nxt % kStages) * kAStage,
                              Bs + (nxt % kStages) * kBStage, m0, r0, r1,
                              n0, nxt * kBK, K, N, tid);
      cp_commit();
      const T* as = As + (kt % kStages) * kAStage;
      const T* bs = Bs + (kt % kStages) * kBStage;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ldsm_x4(a[i], as + (wm * 64 + i * 16 + (lane & 7) +
                              ((lane >> 3) & 1) * 8) * kLdA +
                              kk + (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          // four 8 x 8 blocks: (n block 2jp, k 0-7), (2jp, k 8-15),
          // (2jp + 1, k 0-7), (2jp + 1, k 8-15)
          uint32_t r[4];
          const int nb = wn * 32 + (2 * jp + (lane >> 4)) * 8;
          if (kBnk) {
            ldsm_x4(r, bs + (nb + (lane & 7)) * kLdBnk + kk +
                           ((lane >> 3) & 1) * 8);
          } else {
            ldsm_x4_trans(r, bs + (kk + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * kLdBkn + nb);
          }
          b[2 * jp][0] = r[0];
          b[2 * jp][1] = r[1];
          b[2 * jp + 1][0] = r[2];
          b[2 * jp + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma(acc[i][j], a[i], b[j], as);
      }
    }
    // every warp is done with the ring before the next item's prologue
    // refills it
    __syncthreads();

    // epilogue: c0, c1 at (row g, cols c2, c2 + 1), c2, c3 at row g + 8;
    // only this item's rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + c2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * 64 + i * 16 + g + 8 * h;
          if (m < r0 || m >= r1) continue;
          T* o = out + size_t(m) * N + n;
          if ((N & 1) == 0 && n + 1 < N) {
            store2(o, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (n + e < N) o[e] = from_f<T>(acc[i][j][2 * h + e]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, 64 x 64 tiles, K in steps of 16, 4 x 4 outputs a thread
// ---------------------------------------------------------------------------
constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

template <bool kBnk>
__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
               const int4* __restrict__ work, int wmax,
               float* __restrict__ out, int K, int N) {
  __shared__ __align__(16) float As[kFBK][kFBM + 4];  // [k][m]
  __shared__ __align__(16) float Bs[kFBK][kFBN + 4];  // [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kFBN;
  for (int w = blockIdx.y; w < wmax; w += gridDim.y) {
    const int4 item = work[w];
    if (item.y == kUnused) return;
    const int m0 = item.x * kFBM, r0 = item.z, r1 = item.w;
    if (item.y == kZeros) {
      for (int i = tid; i < (r1 - r0) * kFBN; i += kThreads) {
        const int r = r0 + i / kFBN, c = n0 + i % kFBN;
        if (c < N) out[size_t(r) * N + c] = 0.f;
      }
      continue;
    }
    const float* B = rhs + size_t(item.y) * K * N;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kFBK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = tid + i * kThreads;
        const int m = c >> 4, k = c & 15;
        const int gm = m0 + m, gk = k0 + k;
        As[k][m] = gm >= r0 && gm < r1 && gk < K ? lhs[size_t(gm) * K + gk]
                                                 : 0.f;
        if (kBnk) {
          const int gn = n0 + m;  // c >> 4 walks n here
          Bs[k][m] = gn < N && gk < K ? B[size_t(gn) * K + gk] : 0.f;
        } else {
          const int kr = c >> 6, n = c & 63;
          const int gkr = k0 + kr, gn = n0 + n;
          Bs[kr][n] = gkr < K && gn < N ? B[size_t(gkr) * N + gn] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kFBK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j],
                                                       acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m < r0 || m >= r1) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < N) out[size_t(m) * N + n] = acc[i][j];
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// grid.y walks the work list; a block takes every gridDim.y-th item
constexpr int kMaxGridY = 65535;

template <typename T, bool kBnk, bool kVec>
cudaError_t launch_mma(dim3 grid, cudaStream_t st, const T* a, const T* b,
                       const int4* wk, int wmax, T* o, int K, int N) {
  auto kernel = gmm_mma_kernel<T, kBnk, kVec>;
  constexpr size_t smem = gmm_smem<kBnk>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(a, b, wk, wmax, o, K, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma(dim3 grid, cudaStream_t st, const void* lhs,
                       const void* rhs, const int4* wk, int wmax, void* out,
                       int K, int N, bool trans, bool vec) {
  const T* a = static_cast<const T*>(lhs);
  const T* b = static_cast<const T*>(rhs);
  T* o = static_cast<T*>(out);
  if (trans && vec)
    return launch_mma<T, true, true>(grid, st, a, b, wk, wmax, o, K, N);
  if (trans)
    return launch_mma<T, true, false>(grid, st, a, b, wk, wmax, o, K, N);
  if (vec)
    return launch_mma<T, false, true>(grid, st, a, b, wk, wmax, o, K, N);
  return launch_mma<T, false, false>(grid, st, a, b, wk, wmax, o, K, N);
}

}  // namespace

// lhs (M, K); rhs (E, K, N), or (E, N, K) with trans = 1; group_sizes (E,)
// int32 on the device; work: 4 * wmax int32 of scratch, wmax = ceil(M /
// tile_m) + E; out (M, N). dtype: 0 = float32, 1 = bfloat16, 2 = float16
// (lhs, rhs and out share it).
extern "C" int pdt_grouped_matmul(const void* lhs, const void* rhs,
                                  const void* group_sizes, void* work,
                                  void* out, int M, int K, int N, int E,
                                  int trans, int dtype, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || E <= 0 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bm = dtype != 0 ? kBM : kFBM;
  const int wmax = (M + bm - 1) / bm + E;
  int4* wk = static_cast<int4*>(work);
  gmm_plan_kernel<<<1, 256, sizeof(int) * size_t(E), st>>>(
      static_cast<const int*>(group_sizes), E, M, bm, wk, wmax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype != 0) {
    const dim3 grid((N + kBN - 1) / kBN, wmax < kMaxGridY ? wmax : kMaxGridY);
    const bool vec = K % 8 == 0 && N % 8 == 0 && aligned16(lhs) &&
                     aligned16(rhs);
    err = dtype == 1 ? launch_mma<bf16>(grid, st, lhs, rhs, wk, wmax, out, K,
                                        N, trans != 0, vec)
                     : launch_mma<__half>(grid, st, lhs, rhs, wk, wmax, out,
                                          K, N, trans != 0, vec);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    const dim3 grid((N + kFBN - 1) / kFBN,
                    wmax < kMaxGridY ? wmax : kMaxGridY);
    const float* a = static_cast<const float*>(lhs);
    const float* b = static_cast<const float*>(rhs);
    float* o = static_cast<float*>(out);
    if (trans)
      gmm_f32_kernel<true><<<grid, kThreads, 0, st>>>(a, b, wk, wmax, o, K,
                                                      N);
    else
      gmm_f32_kernel<false><<<grid, kThreads, 0, st>>>(a, b, wk, wmax, o, K,
                                                       N);
  }
  return static_cast<int>(cudaGetLastError());
}
