// LoRA epilogue for Hopper (sm_90a): the per-token low-rank adapter
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
// scalar-prefetched ids pick the token's (K, r) and (r, N) blocks. Here two
// designs, picked by the caller (`ops.lora_epilogue.lora_design`):
//
// SGMV (lora_sgmv_kernel; bf16 and f16, rank <= 64), one launch. A block
// takes a tile of consecutive tokens (64 up to rank 16, 32 up to rank 32,
// 16 up to 64); ragged admission keeps a
// sequence's rows contiguous and a sequence has one adapter, so a tile
// usually holds one live id, and the block reads that adapter's A and B
// once for all of the tile's rows (BGMV reads them once per token). The
// blocks of one tile form a cluster: of 16 blocks when there is one tile
// (decode; a size past the portable 8, which the launch opts into), of 8
// when there are more, each block then taking two of the 16 parts of K in
// turn:
//  1. shrink on tensor cores: 16 parts x 16 warps split K into 256 fixed
//     slices of kq = 16 ceil(K / 4096) (a slice past K is empty);
//     for each distinct live id of the tile (in order of first appearance)
//     a warp runs mma.sync.m16n8k16 over its slice for every 16-row group
//     of the tile that holds that id, x rows as the A operand and A[id] as
//     B, f32 accumulation, and keeps the rows of that id. A warp stages
//     its chunks of A[id]'s and x's rows by cp.async, a round of up to 4
//     in flight, and takes B fragments by ldmatrix.trans; the k order
//     inside an mma step is permuted the same way for both operands, so a
//     lane reads 4 consecutive k of x (8 bytes);
//  2. the 16 warps' partial h are added in warp order (f32) in shared
//     memory, and each block stores a part's sum into that part's slot of
//     every block of the cluster (distributed shared memory); after one
//     cluster barrier each block adds the 16 slots in order: h (the tile's
//     rows x r, f32) never leaves the cluster, and the wrapper allocates
//     no scratch;
//  3. expand on CUDA cores: each block writes its share of the columns;
//     a thread holds a pair of columns of B for up to 32 / r ids in
//     registers (one 4-byte load a row, the first batch's issued before
//     the shrink) and forms sum_j h[t, j] * B[id, j, n] in f32 in the
//     order j = 0..r-1 for its rows t of each id, times s[id].
// At decode (8 tokens) one tile's cluster is repeated over groups of
// columns (each recomputes the same h) so that enough blocks run.
// BGMV (f32, ranks past 64, and the yardstick the SGMV design is timed
// against), two launches:
//  1. shrink, one block per (token, chunk of kchunk rows of A): thread
//     (g, l) of the block (16 groups of 16 lanes) sums x[k] * A[id, k, j] in
//     f32 over the chunk's k = g, g + 16, ... for its rank columns j = l,
//     l + 16, ... < r, so a warp reads 16 consecutive columns of two A rows
//     at a time. The 16 partial sums of each column are added in group
//     order by one thread, into h (T, chunks, r) f32, a scratch the wrapper
//     allocates.
//  2. expand, one block per (token, 256 columns of N): the block first adds
//     the token's chunk sums of each column in chunk order, then each thread
//     forms one output, sum over j = 0..r-1 of h[t, j] * B[id, j, n] in
//     f32, times s[id].
//
// Bitwise invariants (both designs). The order of every sum of a token's
// delta is fixed by K, r's design and the thread layout alone: no sum runs
// across tokens, and a tensor core computes each output of an mma from
// its own row and column. So a token's delta is bitwise the same whatever
// batch it rides in, at whatever position, and whatever else shares its
// tile: the mixed-batch bit-identity of lora_epilogue.py rests on that.
// Zero rank columns padded onto a stack change no bit of the others (a
// column's shrink ignores the other columns; the expand's extra terms are
// exact zeros). Tokens of row 0 (the all-zeros no-adapter row, scale 0)
// skip the math: the delta is an exact zero and an accumulated y is left
// as it is. An id outside [0, R) is treated as row 0.
//
// What bounds it on this card: bytes. A token's delta costs 4 (K + N) r
// operations against 2 (K + N) r bytes of A and B in bf16 (read once per
// tile by SGMV), and at admission the output y (written once, read once
// more when accumulating) dominates the bytes. At decode the bytes take
// well under a microsecond, and the launch and its dependent steps
// (loads, barriers) set the time.
//
// C interface: device pointers on the caller's stream; each entry returns
// cudaGetLastError() after its launches, or cudaErrorInvalidValue for a
// rank outside its design's range.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

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


// ---------------------------------------------------------------------------
// SGMV: bf16 / f16, rank <= kSMaxRank, one launch of clusters of kSCluster
// ---------------------------------------------------------------------------
namespace cg = cooperative_groups;

constexpr int kSThreads = 512;
constexpr int kSWarps = kSThreads / 32;
constexpr int kSTile = 64;     // tokens a tile (a cluster), ranks <= 16
constexpr int kSCluster = 16;  // blocks a cluster: K split 16 ways
constexpr int kSMaxRank = 64;
constexpr int kSCols = 128;    // columns a block at least, when groups repeat

// Per rank class rb: the tile's tokens (fewer for larger ranks, so that
// the warps' partial sums fit), the k rows a staging slot holds, and the
// pitches in bytes of a staged row of A (rp ranks) and of x (ch k): 16
// bytes past the data, so ldmatrix's and the x fragments' rows spread over
// banks
__host__ __device__ constexpr int sgmv_tile(int rb) {
  return kSTile * 16 / rb;
}
__host__ __device__ constexpr int sgmv_chunk(int rb) {
  return rb > 32 ? 16 : 32;
}
__host__ __device__ constexpr int sgmv_apitch(int rp) { return 2 * rp + 16; }
__host__ __device__ constexpr int sgmv_xpitch(int ch) { return 2 * ch + 16; }
__host__ __device__ constexpr int sgmv_slot(int rp, int rb) {
  return sgmv_chunk(rb) * sgmv_apitch(rp) + 16 * sgmv_xpitch(sgmv_chunk(rb));
}

// bytes of a block's shared memory: the tile's ids, its distinct live ids
// and their count, each warp's list of the ids of a 16-row group, the
// warps' partial h (the full h reuses it), the cluster's block sums and
// each warp's nb staging slots; tm = the tile's
// rows (or T below that), rp = r rounded up to 8, rb = the rank's class
inline size_t sgmv_smem(int tm, int rp, int rb, int nb) {
  return sizeof(int) * (2 * kSTile + 4 + kSWarps * kSTile) +
         sizeof(float) * size_t(tm) * rp * (kSWarps + kSCluster) +
         size_t(kSWarps) * nb * sgmv_slot(rp, rb);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// a 16-bit load the compiler issues where it stands (a plain load of
// const restrict data may sink to its use, past a barrier it was meant to
// overlap)
__device__ __forceinline__ uint16_t ld_issue16(const void* p) {
  uint16_t v;
  asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t ld_issue32(const void* p) {
  uint32_t v;
  asm volatile("ld.global.nc.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}
// two 16-bit values (the first in the low half) as floats
__device__ __forceinline__ float2 pair_to_f(uint32_t w, const __nv_bfloat16*) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xFFFF0000u));
}
__device__ __forceinline__ float2 pair_to_f(uint32_t w, const __half*) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}
template <typename T>
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
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

// Grid: (kSCluster x column groups, tiles); the column group's kSCluster
// blocks each take `ncols` columns. kq: each warp's k slice (a multiple
// of 16), slice (rank in the cluster) x 8 + warp. tm: the rows of a full
// tile (the shared buffers' row stride). nb: staging slots a warp. A warp
// stages its items (an id with rows in a 16-row group, a chunk of its
// slice) by cp.async in rounds of nb, a round's copies in flight
// together: a slot holds the chunk's rows of A[id] (B fragments by
// ldmatrix.trans) and of the group's x (A fragments, 8 bytes a row). The
// expand's B column pairs of up to 32 / RB ids are loaded before the shrink.
template <typename T, int RB, bool kAccumulate>
__global__ void __launch_bounds__(kSThreads)
lora_sgmv_kernel(const T* __restrict__ x, const T* __restrict__ a,
                 const T* __restrict__ b, const float* __restrict__ scale,
                 const int* __restrict__ ids, T* __restrict__ y, int T_,
                 int K, int N, int R, int r, int kq, int ncols, int tm,
                 int nb, int vb) {
  constexpr int NT = RB / 8;              // n tiles of the rank
  constexpr int CH = sgmv_chunk(RB);      // k rows a slot
  constexpr int TM = sgmv_tile(RB);       // tokens a tile
  constexpr int IB = 32 / RB > 0 ? 32 / RB : 1;  // ids whose B a thread holds
  extern __shared__ __align__(16) int sm[];
  int* tids = sm;                      // the tile's ids, dead rows 0
  int* list = sm + kSTile;             // distinct live ids
  int* count = sm + 2 * kSTile;
  const int rp = (r + 7) & ~7, nt = rp / 8;
  const int apitch = sgmv_apitch(rp), xpitch = sgmv_xpitch(CH);
  const int slot = sgmv_slot(rp, RB);
  int* wlist = sm + 2 * kSTile + 4;    // a warp's ids of a 16-row group
  float* wp = reinterpret_cast<float*>(wlist + kSWarps * kSTile);
  float* recv = wp + kSWarps * tm * rp;  // block q's sum at slot q
  float* h = wp;                         // the full h, after the sums
  unsigned char* stage = reinterpret_cast<unsigned char*>(
      recv + kSCluster * tm * rp);
  cg::cluster_group cluster = cg::this_cluster();
  // every block of the cluster has started before any writes another's
  // shared memory: arrive now, wait before the first remote store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int q = int(cluster.block_rank());
  const int t0 = blockIdx.y * TM;
  const int rows = min(TM, T_ - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;

  if (threadIdx.x < kSTile) {
    const int id = threadIdx.x < rows ? ids[t0 + threadIdx.x] : 0;
    tids[threadIdx.x] = live_row(id, R) ? id : 0;
  }
  __syncthreads();
  if (warp == 0) {
    // a row is its id's first when no earlier row of the tile has it
    int nl = 0;
#pragma unroll
    for (int half = 0; half < kSTile / 32; ++half) {
      const int row = lane + 32 * half;
      const int id = tids[row];
      bool first = id != 0;
      for (int j = 0; j < row && first; ++j) first = tids[j] != id;
      const unsigned m = __ballot_sync(0xffffffffu, first);
      if (first) list[nl + __popc(m & ((1u << lane) - 1))] = id;
      nl += __popc(m);
    }
    if (lane == 0) *count = nl;
  }
  __syncthreads();
  const int nl = *count;  // the same in every block of the cluster
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // the expand's outputs: a thread takes the column pair cbeg + 2 cl,
  // + 1 (then every ncb-th pair) and the rows ph, ph + P, ... of the
  // tile, P threads a pair
  const int cbeg = blockIdx.x * ncols;  // group x cluster size + q; even
  const int cend = min(N, cbeg + ncols);
  const int ncb = min(ncols / 2, kSThreads), P = kSThreads / ncb;
  const int cl = threadIdx.x % ncb, ph = threadIdx.x / ncb;
  const bool expands = ph < P;
  // the B column pairs (raw: 16-bit values, the first column in the low
  // half, one 4-byte load each) and scales of ids li0.. (0: none), loads
  // issued where they stand and not touched until used: the first pair's
  // before the shrink, whose time they overlap. A row past the rank reads
  // row r - 1 again (valid memory, never used); an odd N loads halves.
  uint32_t bp[IB][RB];
  float sc[IB];
  int bid[IB];
  auto load_b = [&](int n, int li0) {
#pragma unroll
    for (int i = 0; i < IB; ++i) {
      bid[i] = li0 + i < nl ? list[li0 + i] : 0;
      sc[i] = scale[bid[i]];
      const T* bc = b + size_t(bid[i]) * r * N + n;
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const T* p = bc + size_t(min(j, r - 1)) * N;
        if (N % 2 == 0)
          bp[i][j] = ld_issue32(p);
        else
          bp[i][j] = ld_issue16(p) |
                     (n + 1 < N ? uint32_t(ld_issue16(p + 1)) << 16 : 0u);
      }
    }
  };
  if (nl > 0 && expands && cbeg + 2 * cl < cend) load_b(cbeg + 2 * cl, 0);

  if (nl > 0) {
    // 1. the warp's partial h over its k slice, for each id's rows; a
    // block of a cluster of 16 / vb takes the slices of vb of the 16
    // parts of K in turn (the arithmetic of each part is the same)
    int kbeg = 0, kend = 0, nch = 0;
    const bool xvec = K % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const bool avec = r % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(a) % 16 == 0;
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(x);
    const uint16_t* as = reinterpret_cast<const uint16_t*>(a);
    unsigned char* slots = stage + warp * nb * slot;
    // this lane's 16-byte pieces of a slot (fixed for every item): of A,
    // rows (i / per) and pieces (i % per) for i = lane, lane + 32, ...; of
    // x, row lane / (CH / 8) (+ 32 / (CH / 8)) and piece lane % (CH / 8)
    constexpr int AU = (CH * RB / 8 + 31) / 32;
    const int per = r / 8;
    int arow[AU], aoff[AU], agl[AU];
#pragma unroll
    for (int u = 0; u < AU; ++u) {
      const int i = lane + 32 * u;
      arow[u] = per ? min(i / per, CH) : CH;  // CH: past the slot, none
      const int pc = per ? i - arow[u] * per : 0;
      aoff[u] = arow[u] * apitch + 16 * pc;
      agl[u] = arow[u] * r + 8 * pc;
    }
    constexpr int XP = CH / 8;  // pieces a row of x
    const int xrow = lane / XP, xpc = lane % XP;
    // item (id, chunk ch of the slice, rows of group mt) into slot s:
    // zeros past the slice and past the tile's rows
    auto copy = [&](int mt, int id, int ch, int s) {
      const int k0 = kbeg + ch * CH;
      unsigned char* dst = slots + s * slot;
      const uint16_t* src = as + (size_t(id) * K + k0) * r;
      if (avec) {
#pragma unroll
        for (int u = 0; u < AU; ++u) {
          if (arow[u] >= CH) break;
          const bool in = k0 + arow[u] < kend;
          cp_async16(dst + aoff[u], src + (in ? agl[u] : 0), in);
        }
      } else {
        for (int i = lane; i < CH * rp; i += 32) {
          const int row = i / rp, col = i - row * rp;
          *reinterpret_cast<uint16_t*>(dst + row * apitch + 2 * col) =
              k0 + row < kend && col < r ? src[row * r + col] : 0;
        }
      }
      unsigned char* xd = dst + CH * apitch;
      const uint16_t* xr = xs + size_t(t0 + 16 * mt) * K + k0;
      if (xvec) {
#pragma unroll
        for (int v = 0; v < 16 / (32 / XP); ++v) {
          const int row = xrow + v * (32 / XP);
          const bool in = 16 * mt + row < rows && k0 + 8 * xpc < kend;
          cp_async16(xd + row * xpitch + 16 * xpc,
                     in ? xr + size_t(row) * K + 8 * xpc : xs, in);
        }
      } else {
        for (int i = lane; i < 16 * CH; i += 32) {
          const int row = i / CH, col = i - row * CH;
          *reinterpret_cast<uint16_t*>(xd + row * xpitch + 2 * col) =
              16 * mt + row < rows && k0 + col < kend
                  ? xr[size_t(row) * K + col]
                  : 0;
        }
      }
      cp_async_commit();
    };
    // ldmatrix row of this lane: mma slot s = lane % 16 of a k step takes
    // A row 4 (s % 8 / 2) + s % 2 + 2 (s / 8), so slots (2tq, 2tq + 1,
    // 2tq + 8, 2tq + 9) hold k step + 4tq + (0, 1, 2, 3), the order of
    // the 8 bytes of x a lane reads
    const int sl = lane & 15;
    const int krow = 4 * ((sl & 7) >> 1) + (sl & 1) + 2 * (sl >> 3);
    int* wl = wlist + warp * kSTile;
    const int cs = kSCluster / vb;  // blocks in the cluster
    for (int v = 0; v < vb; ++v) {
      const int qv = q * vb + v;  // this part of K: the slot it fills
      kbeg = (qv * kSWarps + warp) * kq;
      kend = min(K, kbeg + kq);
      nch = kend > kbeg ? (kend - kbeg + CH - 1) / CH : 0;
      for (int mt = 0; mt * 16 < rows; ++mt) {
        const int r0 = mt * 16 + g, r1 = r0 + 8;
        // the ids with rows in this 16-row group, in list order
        int nlive = 0;
        for (int li = 0; li < nl; ++li)
          if (__any_sync(0xffffffffu, lane < 16 && mt * 16 + lane < rows &&
                                          tids[mt * 16 + lane] == list[li])) {
            if (lane == 0) wl[nlive] = list[li];
            ++nlive;
          }
        __syncwarp();
        float c[NT][4];
  #pragma unroll
        for (int j = 0; j < NT; ++j)
  #pragma unroll
          for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
        auto store_rows = [&](int id) {
  #pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = hh ? r1 : r0;
            if (row < rows && (id == 0 || tids[row] == id)) {
              float* dst = wp + (warp * tm + row) * rp + 2 * tq;
  #pragma unroll
              for (int j = 0; j < NT; ++j) {
                if (j >= nt) break;
                dst[8 * j] = c[j][2 * hh];
                dst[8 * j + 1] = c[j][2 * hh + 1];
              }
            }
          }
        };
        if (nch == 0) {  // a slice past K: zero partials for every row
          store_rows(0);
          continue;
        }
        // the items (a live id, a chunk of the slice) in rounds of nb: a
        // round's copies all in flight together, then its products
        int li = 0, ch = 0;
        for (int it = 0; it < nlive * nch; it += nb) {
          const int cnt = min(nb, nlive * nch - it);
          for (int j = 0, pl = li, pc = ch; j < cnt; ++j) {
            copy(mt, wl[pl], pc, j);
            if (++pc == nch) {
              pc = 0;
              ++pl;
            }
          }
          cp_async_wait_all();
          __syncwarp();
          for (int j = 0; j < cnt; ++j) {
            const unsigned char* sa = slots + j * slot;
            const unsigned char* sx = sa + CH * apitch;
            const int k0 = kbeg + ch * CH;
  #pragma unroll
            for (int st = 0; st < CH / 16; ++st) {
              if (k0 + 16 * st >= kend) break;
              const int xo = 2 * (16 * st + 4 * tq);
              const uint2 u0 = *reinterpret_cast<const uint2*>(
                  sx + g * xpitch + xo);
              const uint2 u1 = *reinterpret_cast<const uint2*>(
                  sx + (g + 8) * xpitch + xo);
              const uint32_t af[4] = {u0.x, u1.x, u0.y, u1.y};
  #pragma unroll
              for (int jp = 0; jp < NT / 2; ++jp) {
                if (2 * jp >= nt) break;
                uint32_t bq[4];
                ldsm_x4_trans(bq, sa + (16 * st + krow) * apitch +
                                      16 * (2 * jp + (lane >> 4)));
                mma16816<T>(c[2 * jp], af, bq);
                if (2 * jp + 1 < nt) mma16816<T>(c[2 * jp + 1], af, bq + 2);
              }
            }
            if (++ch == nch) {
              store_rows(wl[li]);
  #pragma unroll
              for (int jj = 0; jj < NT; ++jj)
  #pragma unroll
                for (int e = 0; e < 4; ++e) c[jj][e] = 0.f;
              ch = 0;
              ++li;
            }
          }
          __syncwarp();  // the slots are read before the next round's copies
        }
      }
      __syncthreads();
      // 2. the part's sum in warp order, stored into slot qv of every block
      // of the cluster; after the barrier each block adds the 16 slots in
      // order
      for (int e = threadIdx.x; e < rows * rp; e += kSThreads) {
        float acc = wp[e];
  #pragma unroll
        for (int w = 1; w < kSWarps; ++w) acc += wp[w * tm * rp + e];
#pragma unroll
        for (int qq = 0; qq < kSCluster; ++qq)
          if (qq < cs)
            cluster.map_shared_rank(recv, qq)[qv * tm * rp + e] = acc;
      }
      __syncthreads();  // the partials are read before the next part's
    }
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n"
        "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    for (int e = threadIdx.x; e < rows * rp; e += kSThreads) {
      float acc = recv[e];
#pragma unroll
      for (int qq = 1; qq < kSCluster; ++qq) acc += recv[qq * tm * rp + e];
      h[e] = acc;
    }
    __syncthreads();
  }

  // 3. this block's columns: a thread holds the B column pairs of IB ids
  // and, id by id, forms its rows' outputs, sum_j h[t, j] B[id, j, n] in
  // order, for both columns at once
  auto put = [&](int row, int n, float v0, float v1, bool two) {
    T* out = y + size_t(t0 + row) * N + n;
    const T d0 = from_f<T>(v0), d1 = from_f<T>(v1);
    if (kAccumulate) {
      out[0] = from_f<T>(to_f(out[0]) + to_f(d0));
      if (two) out[1] = from_f<T>(to_f(out[1]) + to_f(d1));
    } else {
      out[0] = d0;
      if (two) out[1] = d1;
    }
  };
  for (int n = cbeg + 2 * cl; expands && n < cend; n += 2 * ncb) {
    const bool two = n + 1 < cend;
    for (int li0 = 0; li0 < nl; li0 += IB) {
      if (n != cbeg + 2 * cl || li0 != 0) load_b(n, li0);
#pragma unroll
      for (int i = 0; i < IB; ++i) {
        if (bid[i] == 0) continue;
        float b0[RB], b1[RB];
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const float2 f = pair_to_f(bp[i][j], b);
          b0[j] = f.x;
          b1[j] = f.y;
        }
        for (int row = ph; row < rows; row += P) {
          if (tids[row] != bid[i]) continue;
          const float4* hr = reinterpret_cast<const float4*>(h + row * rp);
          float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
          for (int j4 = 0; j4 < RB / 4; ++j4) {
            if (4 * j4 >= r) break;
            const float4 hv = hr[j4];
            const float hj[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (4 * j4 + e < r) {
                acc0 += hj[e] * b0[4 * j4 + e];
                acc1 += hj[e] * b1[4 * j4 + e];
              }
          }
          // __fmul_rn: the product is rounded on its own, never
          // contracted into an FMA with the add of an accumulated y
          put(row, n, __fmul_rn(acc0, sc[i]), __fmul_rn(acc1, sc[i]), two);
        }
      }
    }
    if (!kAccumulate)
      for (int row = ph; row < rows; row += P)
        if (tids[row] == 0) put(row, n, 0.f, 0.f, two);
  }
}

template <typename T, int RB, bool kAccumulate>
cudaError_t launch_sgmv_rb(const void* x, const void* a, const void* b,
                           const float* scale, const int* ids, void* y,
                           int T_, int K, int N, int R, int r,
                           cudaStream_t stream) {
  auto kernel = lora_sgmv_kernel<T, RB, kAccumulate>;
  constexpr int TM = sgmv_tile(RB);
  const int tm = min(T_, TM);
  // staging slots a warp: as many as fit, up to 4 (decode: a call's few
  // items in one round)
  constexpr size_t kMaxSmem = 227 * 1024;
  int nb = 4;
  while (nb > 1 && sgmv_smem(tm, (r + 7) & ~7, RB, nb) > kMaxSmem) --nb;
  const size_t bytes = sgmv_smem(tm, (r + 7) & ~7, RB, nb);
  {
    // the shared-memory ceiling and the cluster size past 8, once per
    // device (internal linkage: one flag set per library)
    static bool opted[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && (dev >= 64 || !opted[dev])) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kMaxSmem));
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err == cudaSuccess && dev < 64) opted[dev] = true;
    }
    if (err != cudaSuccess) {
      cudaGetLastError();  // reported here, not at the next launch
      return err;
    }
  }
  const int tiles = (T_ + TM - 1) / TM;
  // a cluster of 16 blocks for one tile (decode: the shrink's bytes over
  // 16 SMs), of 8 taking two parts of K each for more (admission: half the
  // blocks to schedule and to sum); the same arithmetic
  const int vb = tiles > 1 ? 2 : 1, cs = kSCluster / vb;
  // column groups: a block for each of the card's 132 SMs at decode, at
  // least kSCols columns a block
  const int by_cols = (N + cs * kSCols - 1) / (cs * kSCols);
  const int by_sms = (132 + cs * tiles - 1) / (cs * tiles);
  const int groups = max(1, min(by_cols, by_sms));
  // an even count, so that every block's columns start on a pair
  const int ncols = 2 * ((N + 2 * cs * groups - 1) / (2 * cs * groups));
  const int kq = 16 * ((K + 16 * kSCluster * kSWarps - 1) /
                       (16 * kSCluster * kSWarps));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * groups, tiles);
  cfg.blockDim = dim3(kSThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = cs;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(b), scale, ids, static_cast<T*>(y), T_, K, N, R,
      r, kq, ncols, tm, nb, vb);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, bool kAccumulate>
cudaError_t launch_sgmv(const void* x, const void* a, const void* b,
                        const float* scale, const int* ids, void* y, int T_,
                        int K, int N, int R, int r, cudaStream_t stream) {
  if (r <= 16)
    return launch_sgmv_rb<T, 16, kAccumulate>(x, a, b, scale, ids, y, T_, K,
                                              N, R, r, stream);
  if (r <= 32)
    return launch_sgmv_rb<T, 32, kAccumulate>(x, a, b, scale, ids, y, T_, K,
                                              N, R, r, stream);
  return launch_sgmv_rb<T, 64, kAccumulate>(x, a, b, scale, ids, y, T_, K, N,
                                            R, r, stream);
}

template <typename T>
cudaError_t run_sgmv(const void* x, const void* a, const void* b,
                     const float* scale, const int* ids, void* y, int T_,
                     int K, int N, int R, int r, bool accumulate,
                     cudaStream_t stream) {
  return accumulate ? launch_sgmv<T, true>(x, a, b, scale, ids, y, T_, K, N,
                                           R, r, stream)
                    : launch_sgmv<T, false>(x, a, b, scale, ids, y, T_, K, N,
                                            R, r, stream);
}

}  // namespace

// The BGMV design. dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, A,
// B and y share it). h: f32 scratch of T * ceil(K / kchunk) * r values.
// accumulate: 0 writes the delta into y, 1 adds it into y.
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

// The SGMV design: dtype 1 = bfloat16, 2 = float16; rank 1..64; no
// scratch. accumulate as above.
extern "C" int pdt_lora_sgmv(const void* x, const void* a, const void* b,
                             const void* scale, const void* ids, void* y,
                             int T, int K, int N, int R, int r, int dtype,
                             int accumulate, void* stream) {
  if (T <= 0 || N <= 0) return 0;
  if (K <= 0 || R <= 0 || r <= 0 || r > kSMaxRank ||
      (dtype != 1 && dtype != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const int* id = static_cast<const int*>(ids);
  return static_cast<int>(
      dtype == 1 ? run_sgmv<__nv_bfloat16>(x, a, b, sc, id, y, T, K, N, R, r,
                                           accumulate != 0, s)
                 : run_sgmv<__half>(x, a, b, sc, id, y, T, K, N, R, r,
                                    accumulate != 0, s));
}
