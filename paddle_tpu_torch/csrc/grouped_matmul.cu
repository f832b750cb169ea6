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
// (item, n tile), the n tiles of an item next to each other in launch
// order and the items of one group after each other (so a group's rhs
// tiles are read from L2 after the first): a tile that straddles a group
// boundary is computed once for each group and masked on store to that
// group's rows. Items past the list's end exit at once. Every output row
// is written exactly once, by one block, with no atomics.
//
// What bounds it on this card: operations. At the A14B expert shapes (M =
// 32768 routed rows, (K, N) = (3584, 2560) and (2560, 3584), E = 64) the
// product is 2 M K N = 601 GFLOP against ~0.47 GB of operands: ~0.61 ms of
// bf16 tensor-core time, 0.14 ms of bytes. Two designs:
// - wgmma (gmm_wgmma_kernel; bf16 and f16 with K and N multiples of 8, the
//   16-byte strides TMA wants): a 128 x 256 output tile a block (faster
//   than 128 x 128 at the A14B shapes on the H100), two consumer
//   warpgroups of 64 rows and one producer warp (setmaxnreg 240 / 24).
//   lhs tiles of 128 rows x 64 k arrive by TMA from a 2-D map, rhs tiles
//   of 64 k x 256 from a 3-D map over the experts
//   (MN-major B for (E, K, N), K-major B for `trans`), 128-byte swizzle,
//   through a ring of four stages (full / empty mbarriers); a last k step
//   past K reads zeros (TMA's fill) on both sides. Each k step is
//   four m64n256k16 wgmma a warpgroup from shared memory, one group in
//   flight while the next step's wait runs; a warpgroup whose 64 rows hold
//   none of the item's rows issues none. f32 accumulation, one rounding
//   in the epilogue.
// - mma.sync (gmm_mma_kernel; the other bf16 / f16 shapes, and the yardstick
//   the wgmma design is timed against): 128 x 128 tiles, 8 warps as 2 x 4
//   of 64 x 32, K in steps of 32 through a ring of four shared-memory
//   stages fed by cp.async, fragments by ldmatrix (.trans for the (K, N)
//   layout), mma.sync.m16n8k16 with f32 accumulation; the inner loop, not
//   memory, sets its pace (four stages were no faster than two).
// f32 runs on CUDA cores (64 x 64 tiles, 4 x 4 outputs a thread, exact f32
// FMAs, no TF32), as the JAX package's f32 matmul does.
//
// C interface: device pointers on the caller's stream; each entry returns
// cudaErrorInvalidValue for an input it does not take, else
// cudaGetLastError() after its two launches.

#include "sm90.cuh"

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
    // an empty group lists no item (its start may lie inside a tile)
    for (int t = start / bm; start < end && t * bm < end && w < wmax; ++t)
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

// ---------------------------------------------------------------------------
// bf16 and f16: wgmma on 128 x 256 tiles fed by TMA
// ---------------------------------------------------------------------------
namespace pdt_sm90 {

constexpr int kGmmBM = 128;  // rows an item: two consumer warpgroups of 64
constexpr int kGmmBN = 256;  // output columns a block
constexpr int kGmmBK = 64;   // k a step: one 128-byte swizzled row
constexpr int kGmmThreads = 384;
constexpr int kGmmStages = 4;

struct GmmLayout {
  static constexpr int kA = kGmmBM * 128;  // 128 rows x 64 k
  static constexpr int kB = kGmmBN * 128;  // 64 k x 256, either layout
  static constexpr int kStage = kA + kB;
  static constexpr int kBars = kGmmStages * kStage;  // full, empty
  static constexpr int kBytes = kBars + 8 * 2 * kGmmStages + 1024;
};

// One block per (work item, n tile): the producer warp's lane 0 streams the
// item's k steps (lhs rows m0.., this n tile of group item.y's rhs) through
// the ring; each consumer warpgroup multiplies its 64 rows, if they hold
// any of the item's rows, and stores those rows. `it` counts k steps over
// the block's items, so the ring's phases run on from one item to the next.
template <typename T, bool TRANS>
__global__ void __launch_bounds__(kGmmThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     const int4* __restrict__ work, int wmax,
                     u16* __restrict__ out, int K, int N) {
  using L = GmmLayout;
  constexpr int NS = kGmmStages, BN = kGmmBN;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t full = base + L::kBars, empty = full + 8 * NS;
  const int n0 = blockIdx.x * BN;
  const int nk = (K + kGmmBK - 1) / kGmmBK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 8);  // a warp of each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(24));
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int w = blockIdx.y; w < wmax; w += gridDim.y) {
      const int4 item = work[w];
      if (item.y == kUnused) break;
      if (item.y == kZeros) continue;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int st = it % NS;
        mbar_wait(empty + 8 * st, ((it / NS) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, L::kStage);
        const uint32_t as = base + st * L::kStage, bs = as + L::kA;
        tma_load_2d(as, &ta, full + 8 * st, kt * kGmmBK, item.x * kGmmBM);
        if constexpr (TRANS) {
          tma_load_3d(bs, &tb, full + 8 * st, kt * kGmmBK, n0, item.y);
        } else {
          for (int c = 0; c < BN / 64; ++c)
            tma_load_3d(bs + c * kBox, &tb, full + 8 * st, n0 + 64 * c,
                        kt * kGmmBK, item.y);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(240));
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  int it = 0;
  for (int w = blockIdx.y; w < wmax; w += gridDim.y) {
    const int4 item = work[w];
    if (item.y == kUnused) break;
    const int r0 = item.z, r1 = item.w;
    if (item.y == kZeros) {
      // rows past the last group: zeros, two outputs a store
      for (int i = threadIdx.x; i < (r1 - r0) * (BN / 2); i += 256) {
        const int c = n0 + 2 * (i % (BN / 2));
        if (c < N)
          *reinterpret_cast<uint32_t*>(
              out + size_t(r0 + i / (BN / 2)) * N + c) = 0u;
      }
      continue;
    }
    const int w0 = item.x * kGmmBM + 64 * wg;  // this warpgroup's rows
    const bool act = w0 < r1 && w0 + 64 > r0;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int st = it % NS;
      mbar_wait(full + 8 * st, (it / NS) & 1);
      if (act) {
        const uint32_t as = base + st * L::kStage + wg * kBox;
        const uint32_t bs = base + st * L::kStage + L::kA;
        if (kt == 0) reg_fence(acc);  // the zeros are in place
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kGmmBK / 16; ++kk) {
          if constexpr (TRANS)
            wg_ss<T, BN, 0>(acc, desc_kmajor(as, kk), desc_kmajor(bs, kk));
          else
            wg_ss<T, BN, 1>(acc, desc_kmajor(as, kk), desc_mnmajor(bs, kk));
        }
        wg_commit();
        // the previous step's products are done: its stage is free
        wg_wait<1>();
      }
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % NS));
      }
    }
    if (act) {
      wg_wait<0>();
      reg_fence(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % NS));
    if (!act) continue;
    // element i: row g + 8 ((i >> 1) & 1) of the warp's 16, column
    // 8 (i >> 2) + 2t + (i & 1); only the item's rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + 16 * warp + g + 8 * r;
      if (row < r0 || row >= r1) continue;
      u16* o = out + size_t(row) * N + n0 + 2 * t;
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
        if (n0 + 8 * c + 2 * t < N)
          *reinterpret_cast<uint32_t*>(o + 8 * c) =
              pack2<T>(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
    }
  }
}

template <typename T, bool TRANS>
cudaError_t launch_gmm(const CUtensorMap& ta, const CUtensorMap& tb,
                       const int4* wk, int wmax, void* out, int K, int N,
                       cudaStream_t st) {
  auto kernel = gmm_wgmma_kernel<T, TRANS>;
  constexpr int bytes = GmmLayout::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kGmmBN - 1) / kGmmBN,
                  wmax < kMaxGridY ? wmax : kMaxGridY);
  kernel<<<grid, kGmmThreads, bytes, st>>>(ta, tb, wk, wmax,
                                           static_cast<u16*>(out), K, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_gmm(bool trans, const CUtensorMap& ta, const CUtensorMap& tb,
                    const int4* wk, int wmax, void* out, int K, int N,
                    cudaStream_t st) {
  return trans ? launch_gmm<T, true>(ta, tb, wk, wmax, out, K, N, st)
               : launch_gmm<T, false>(ta, tb, wk, wmax, out, K, N, st);
}

}  // namespace pdt_sm90

// The wgmma design: lhs (M, K); rhs (E, K, N), or (E, N, K) with trans = 1;
// group_sizes (E,) int32 on the device; work: 4 * wmax int32 of scratch,
// wmax = ceil(M / 128) + E; out (M, N). dtype: 1 = bfloat16, 2 = float16;
// K and N multiples of 8 and 16-byte aligned tensors (TMA's strides).
extern "C" int pdt_grouped_matmul_sm90(const void* lhs, const void* rhs,
                                       const void* group_sizes, void* work,
                                       void* out, int M, int K, int N, int E,
                                       int trans, int dtype, void* stream) {
  namespace h = pdt_sm90;
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || E <= 0 || (dtype != 1 && dtype != 2) || K % 8 != 0 ||
      N % 8 != 0 ||
      !h::aligned16(lhs) || !h::aligned16(rhs) || !h::aligned16(out) ||
      !h::bind_device(lhs))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  const cuuint64_t adims[2] = {cuuint64_t(K), cuuint64_t(M)};
  const cuuint64_t astr[1] = {cuuint64_t(K) * 2};
  const cuuint32_t abox[2] = {64, h::kGmmBM};
  bool ok = h::make_tiled_map(&ta, lhs, 2, adims, astr, abox, dtype);
  if (trans) {
    const cuuint64_t dims[3] = {cuuint64_t(K), cuuint64_t(N), cuuint64_t(E)};
    const cuuint64_t str[2] = {cuuint64_t(K) * 2, cuuint64_t(N) * K * 2};
    const cuuint32_t box[3] = {64, cuuint32_t(h::kGmmBN), 1};
    ok = ok && h::make_tiled_map(&tb, rhs, 3, dims, str, box, dtype);
  } else {
    const cuuint64_t dims[3] = {cuuint64_t(N), cuuint64_t(K), cuuint64_t(E)};
    const cuuint64_t str[2] = {cuuint64_t(N) * 2, cuuint64_t(K) * N * 2};
    const cuuint32_t box[3] = {64, 64, 1};
    ok = ok && h::make_tiled_map(&tb, rhs, 3, dims, str, box, dtype);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int wmax = (M + h::kGmmBM - 1) / h::kGmmBM + E;
  int4* wk = static_cast<int4*>(work);
  gmm_plan_kernel<<<1, 256, sizeof(int) * size_t(E), st>>>(
      static_cast<const int*>(group_sizes), E, M, h::kGmmBM, wk, wmax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = dtype == 1 ? h::run_gmm<h::bf16>(trans != 0, ta, tb, wk, wmax, out,
                                         K, N, st)
                   : h::run_gmm<h::f16>(trans != 0, ta, tb, wk, wmax, out, K,
                                        N, st);
  return static_cast<int>(err);
}

// The mma.sync and f32 designs: lhs (M, K); rhs (E, K, N), or (E, N, K)
// with trans = 1; group_sizes (E,) int32 on the device; work: 4 * wmax
// int32 of scratch, wmax = ceil(M / tile_m) + E; out (M, N). dtype: 0 =
// float32, 1 = bfloat16, 2 = float16 (lhs, rhs and out share it).
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
