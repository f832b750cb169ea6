// Packed (varlen) flash attention for Hopper (sm_90a) on wgmma and TMA: the
// segment tile plan, the forward (o and the row log-sum-exp), the dQ and the
// dK/dV backward of GQA attention confined to pairs of one segment, bf16 and
// f16, head dims 64 and 128.
//
// Replaces, at those dtypes and head dims: paddle_tpu/ops/flash_varlen.py
// _fwd_kernel (:60, pallas_call at :212), _bwd_dq_kernel (:106, at :254)
// and _bwd_dkv_kernel (:149, at :285). Every other input takes the mma.sync
// kernels of flash_varlen.cu. The Hopper building blocks (sm90.cuh) and the
// masks, tensor maps and online softmax (flash_sm90.cuh) are those of the
// dense wgmma kernels (flash_fwd_sm90.cu, flash_bwd_sm90.cu).
//
// Semantics, as the JAX kernels: q (B, Sq, H, D), k and v (B, Sk, HK, D)
// read in place, int32 segment ids seg_q (B, Sq) and seg_k (B, Sk); q row i
// and key j pair iff seg_q[i] == seg_k[j] >= 0 (any negative id is padding)
// and, causal, i + Sk - Sq >= j (global end-aligned order, any Sq and Sk);
// ids need not be sorted or contiguous. A row with no live key (a padding
// row among them) gets o = 0, lse -1e30 and zero dQ; a padding key zero dK
// and dV. lse and delta are (B, H, Sq) f32; dK and dV are summed over the G
// query heads of their KV head in a fixed order (bitwise the same from run
// to run, no float atomics).
//
// What bounds them on this card: operations (4D, 6D and 8D flops a live
// (q row, key) pair). Under packing most (q tile, key tile) pairs of the
// causal band hold no live pair: the design visits only the tiles where
// some pair can be live and keeps the dense kernels' tensor-core pipeline
// on those.
// - The segment tile plan (varlen_plan, one launch a call, a single block
//   of 1024 threads, no host read, so a CUDA graph can capture it): for each
//   batch row and 64-row tile of seg_q and of seg_k, [lo, hi] of its
//   non-padding ids and a flag "one segment, no padding, no tail"
//   (uniform); per batch row whether the ids are sorted (non-decreasing over
//   a prefix, negative only as a tail); per 128-row q block the key tiles
//   [first, last] it walks and their count, per 128-key block the q tiles
//   likewise: two binary searches over the other side's [lo, hi] under
//   sorted ids (the meeting tiles are then one range), a walk of the causal
//   band otherwise; and the blocks' launch order, the most visited tiles
//   first (a stable rank by count, ties in index order). A launch takes
//   its blocks in that order or in the dense kernels' (`order`); the
//   wrappers pick per kernel the one that measured faster
//   (ops/flash_varlen.py SM90_ORDER).
// - Kernels: a block owns 128 q rows (forward, dQ) or 128 keys (dK/dV) of
//   one head, two consumer warpgroups of 64 rows and a producer warp, as the
//   dense kernels. The producer TMA-loads only the tiles of [first, last]
//   whose id range meets the block's (all of them under sorted ids; on
//   others one 8-byte read of the plan skips a tile) and copies the tile's
//   ids (normalised: padding -1) into the stage beside it; the ids of a
//   consumer's own rows live in registers (padding -2, which no staged id
//   equals). A warpgroup whose own 64-row tile does not meet a stage skips
//   its products. The per-element segment mask is applied only on tiles
//   that the flags show cut (a boundary, padding, a tail, or the causal
//   band), as a select after the arithmetic, never a branch around an
//   exponential.
// - Forward: 128 keys a stage, Q by TMA into shared memory (no register A
//   operand lives across the key loop), the dense forward's straight-line
//   online softmax (online_softmax). dQ: 64 keys a stage; Q and dO by TMA
//   into shared memory, read as shared-memory A operands of S = Q.K^T and
//   dP = dO.V^T (no register A operand lives across the loop); given o, it
//   forms delta = rowsum(o dO) of its rows and writes it for dK/dV (as the
//   dense dQ kernel; else it reads delta). dK/dV: K and V resident in
//   shared memory, the G query heads and their q tiles walked in a fixed
//   order; where blocks are fewer than SMs, `splits` blocks share the heads
//   and write f32 partials added in split order (flash_dkv_sum_sm90).
// - Precision as the dense wgmma kernels: S and row sums in f32, P and dS
//   rounded once to T for the products, f32 accumulation.
//
// C interface: device pointers on the caller's current stream; each entry
// returns cudaErrorInvalidValue for an input it does not take (a dtype other
// than bf16 / f16, a head dim other than 64 / 128, a pointer not 16-byte
// aligned) or a tensor map the driver refuses, else cudaGetLastError() after
// its launch. The plan is an int32 buffer of PlanLayout::words words
// (ops/flash_varlen.py `_plan_layout`); the three kernels read the plan of
// the same seg_q, seg_k and causal flag.

#include "flash_sm90.cuh"

namespace pdt_sm90 {

constexpr int kBlockRows = 2 * kRows;  // q rows (keys) of a block
constexpr int kEmptyLo = 0x7fffffff;   // lo of a tile without an id
constexpr int kPlanThreads = 1024;

// ---------------------------------------------------------------------------
// the plan: int32 words
// ---------------------------------------------------------------------------
struct PlanLayout {
  int nqt, nkt;  // 64-row tiles of seg_q, of seg_k
  int nqb, nkb;  // 128-row q blocks, 128-key blocks
  // word offsets: tile [lo, hi] (int2), block [first, last] (int2), then
  // uniform flags, block counts, launch orders, sorted flags (q, k per
  // row) and non-empty tile counts (q, k per row)
  int qt, kt, qb, kb, qu, ku, qn, kn, qo, ko, sorted, ne, words;
  __host__ __device__ PlanLayout(int B, int Sq, int Sk) {
    nqt = (Sq + kRows - 1) / kRows;
    nkt = (Sk + kRows - 1) / kRows;
    nqb = (Sq + kBlockRows - 1) / kBlockRows;
    nkb = (Sk + kBlockRows - 1) / kBlockRows;
    qt = 0;
    kt = qt + 2 * B * nqt;
    qb = kt + 2 * B * nkt;
    kb = qb + 2 * B * nqb;
    qu = kb + 2 * B * nkb;
    ku = qu + B * nqt;
    qn = ku + B * nkt;
    kn = qn + B * nqb;
    qo = kn + B * nkb;
    ko = qo + B * nqb;
    sorted = ko + B * nkb;
    ne = sorted + 2 * B;
    words = ne + 2 * B;
  }
};

__device__ __forceinline__ int2 tile_rec(const int* plan, int off, int i) {
  return reinterpret_cast<const int2*>(plan + off)[i];
}

// ranges a and b of ids overlap: an id of one may equal an id of the other
__device__ __forceinline__ bool meets(int2 a, int2 b) {
  return a.x <= b.y && b.x <= a.y;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// the ids of a block: [lo, hi] over its two tiles t0 and t0 + 1 (n tiles)
__device__ __forceinline__ int2 block_range(const int2* tiles, int n,
                                            int t0) {
  int2 r = tiles[t0];
  if (t0 + 1 < n) {
    r.x = min(r.x, tiles[t0 + 1].x);
    r.y = max(r.y, tiles[t0 + 1].y);
  }
  return r;
}

// The tiles of the other side that block `blk` of batch row b walks: those
// whose id range meets the block's, within [tmin, tmax] (the causal band).
// Under sorted ids the other side's ranges are non-decreasing over its `ne`
// non-empty tiles, and two binary searches find them; otherwise a walk.
__device__ void block_walk(const int2* other, int n_other, int ne,
                           bool sorted, int2 range, int tmin, int tmax,
                           int& first, int& last, int& count) {
  first = 0;
  last = -1;
  count = 0;
  if (range.y < 0 || tmin > tmax) return;
  if (sorted) {
    int a = 0, z = ne;  // the first tile with hi >= lo of the block
    while (a < z) {
      const int m = (a + z) / 2;
      if (other[m].y >= range.x) z = m; else a = m + 1;
    }
    const int f = max(a, tmin);
    a = 0;
    z = ne;  // the first tile with lo > hi of the block
    while (a < z) {
      const int m = (a + z) / 2;
      if (other[m].x > range.y) z = m; else a = m + 1;
    }
    const int l = min(a - 1, tmax);
    if (f <= l) {
      first = f;
      last = l;
      count = l - f + 1;
    }
    return;
  }
  for (int t = tmin; t <= min(tmax, n_other - 1); ++t)
    if (meets(other[t], range)) {
      if (count == 0) first = t;
      last = t;
      ++count;
    }
}

__global__ void __launch_bounds__(kPlanThreads, 1)
    varlen_plan(const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                int* __restrict__ plan, int B, int Sq, int Sk, int causal) {
  const PlanLayout P(B, Sq, Sk);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int i = tid; i < 2 * B; i += kPlanThreads) {
    plan[P.sorted + i] = 1;
    plan[P.ne + i] = 0;
  }
  __syncthreads();
  // tiles: every q tile, then every key tile, a warp each
  const int ntq = B * P.nqt, nt = ntq + B * P.nkt;
  for (int i = warp; i < nt; i += kPlanThreads / 32) {
    const int isk = i >= ntq;
    const int ti = isk ? i - ntq : i;
    const int ntile = isk ? P.nkt : P.nqt, S = isk ? Sk : Sq;
    const int b = ti / ntile, tile = ti % ntile;
    const int* seg = (isk ? seg_k : seg_q) + size_t(b) * S;
    int lo = kEmptyLo, hi = -1;
    bool pad = false, ordered = true;
    for (int r = lane; r < kRows; r += 32) {
      const int p = tile * kRows + r;
      const int x = p < S ? seg[p] : -1;
      if (x >= 0) {
        lo = min(lo, x);
        hi = max(hi, x);
      } else {
        pad = true;
      }
      if (p + 1 < S) {
        const int y = seg[p + 1];
        ordered &= x < 0 ? y < 0 : (y < 0 || x <= y);
      }
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    pad = __any_sync(~0u, pad);
    ordered = __all_sync(~0u, ordered);
    if (lane == 0) {
      reinterpret_cast<int2*>(plan + (isk ? P.kt : P.qt))[ti] =
          make_int2(lo, hi);
      plan[(isk ? P.ku : P.qu) + ti] = !pad && lo == hi;
      if (!ordered) plan[P.sorted + 2 * b + isk] = 0;
      if (hi >= 0) atomicMax(plan + P.ne + 2 * b + isk, tile + 1);
    }
  }
  __syncthreads();
  // blocks: the tiles each walks
  const int nbq = B * P.nqb, nb = nbq + B * P.nkb;
  const int off = Sk - Sq;
  for (int e = tid; e < nb; e += kPlanThreads) {
    const int isk = e >= nbq;  // a key block, walking q tiles
    const int ei = isk ? e - nbq : e;
    const int nblk = isk ? P.nkb : P.nqb;
    const int b = ei / nblk, blk = ei % nblk;
    const int own_n = isk ? P.nkt : P.nqt, n_other = isk ? P.nqt : P.nkt;
    const int2* own = reinterpret_cast<const int2*>(plan + (isk ? P.kt : P.qt))
                      + size_t(b) * own_n;
    const int2* other = reinterpret_cast<const int2*>(
                            plan + (isk ? P.qt : P.kt)) + size_t(b) * n_other;
    const int2 range = block_range(own, own_n, 2 * blk);
    int tmin = 0, tmax = n_other - 1;
    if (causal && !isk) {
      // q rows [r0, r1] see keys up to r1 + Sk - Sq
      const int r1 = min(blk * kBlockRows + kBlockRows, Sq) - 1;
      const int kmax = r1 + off;
      tmax = kmax < 0 ? -1 : min(tmax, kmax / kRows);
    } else if (causal) {
      // q rows from j0 - (Sk - Sq) on see key j0
      const int qmin = max(0, blk * kBlockRows - off);
      tmin = qmin / kRows;
    }
    const int oside = isk ? 0 : 1;  // the other side: 0 q, 1 keys
    int first, last, count;
    block_walk(other, n_other, plan[P.ne + 2 * b + oside],
               plan[P.sorted + 2 * b + oside] != 0, range, tmin, tmax, first,
               last, count);
    reinterpret_cast<int2*>(plan + (isk ? P.kb : P.qb))[ei] =
        make_int2(first, last);
    plan[(isk ? P.kn : P.qn) + ei] = count;
  }
  __syncthreads();
  // launch orders: the most walked tiles first, ties in index order
  for (int e = tid; e < nb; e += kPlanThreads) {
    const int isk = e >= nbq;
    const int ei = isk ? e - nbq : e;
    const int n = isk ? nb - nbq : nbq;
    const int* cnt = plan + (isk ? P.kn : P.qn);
    const int c = cnt[ei];
    int pos = 0;
    for (int j = 0; j < n; ++j) {
      const int cj = cnt[j];
      pos += (cj > c) | ((cj == c) & (j < ei));
    }
    plan[(isk ? P.ko : P.qo) + pos] = ei;
  }
}

// The block entry (b * nblk + blk) that launch rank `rank` takes: the
// plan's order, or the dense kernels' (q blocks from the last, key blocks
// from the first, every batch row of a block together)
__device__ __forceinline__ int block_entry(const int* plan, int order_off,
                                           int use_plan, int rank, int B,
                                           int nblk, bool last_first) {
  if (use_plan) return plan[order_off + rank];
  const int blk = last_first ? nblk - 1 - rank / B : rank / B;
  return (rank % B) * nblk + blk;
}

// the ids of a staged tile: n ids from position j0 of `seg` (S of them),
// padding and positions past S as -1; by the lanes of one warp
__device__ __forceinline__ void stage_ids(int* dst, const int* seg, int S,
                                          int j0, int n, int lane) {
  for (int i = lane; i < n; i += 32) {
    const int j = j0 + i;
    const int x = j < S ? seg[j] : -1;
    dst[i] = x >= 0 ? x : -1;
  }
}

// the id of one of a consumer's own rows: padding and rows past S as -2,
// which no staged id equals
__device__ __forceinline__ int own_id(const int* seg, int S, int i) {
  const int x = i < S ? seg[i] : -1;
  return x >= 0 ? x : -2;
}

// ---------------------------------------------------------------------------
// forward: a block owns 128 q rows of one query head; kVfKeys keys a stage
// ---------------------------------------------------------------------------
// keys a stage: two plan tiles (tools/varlen_key_tile.py times 64 against
// 128)
constexpr int kVfKeys = 128;
constexpr int kVfTiles = kVfKeys / kRows;

template <int D, int NS>
struct VfLayout {
  static constexpr int kChunk = kVfKeys * 128;     // the keys x 64 columns
  static constexpr int kTile = (D / 64) * kChunk;  // K or V
  static constexpr int kStage = 2 * kTile;         // K, then V
  static constexpr int kQ = NS * kStage;
  static constexpr int kQWg = (D / 64) * kBox;  // a warpgroup's Q
  static constexpr int kIds = kQ + kConsumers * kQWg;  // NS x kVfKeys ids
  static constexpr int kBars = kIds + NS * kVfKeys * 4;
  static constexpr int kBytes = kBars + 8 * (2 * NS + 1) + 1024;
};

// ring stages: four, or as many as fit beside Q in 227 KB (three at D 128)
template <int D>
constexpr int vf_stages() {
  constexpr int n = (227 * 1024 - VfLayout<D, 0>::kBytes) /
                    (VfLayout<D, 1>::kStage + kVfKeys * 4 + 16);
  return n < 4 ? n : 4;
}

template <typename T, int D, int NS>
__global__ void __launch_bounds__(kThreads, 1)
    varlen_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const int* __restrict__ seg_q,
                    const int* __restrict__ seg_k,
                    const int* __restrict__ plan, u16* __restrict__ o,
                    float* __restrict__ lse, int use_order, Shape s) {
  using L = VfLayout<D, NS>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  unsigned char* const gbase = smem + (base - smem_addr(smem));
  const uint32_t full = base + L::kBars, empty = full + 8 * NS;
  const uint32_t qfull = empty + 8 * NS;
  const PlanLayout P(s.B, s.Sq, s.Sk);
  const int rank = blockIdx.x / s.H, h = blockIdx.x % s.H;
  const int e = block_entry(plan, P.qo, use_order, rank, s.B, P.nqb, true);
  const int b = e / P.nqb, qb = e % P.nqb;
  const int kh = h / (s.H / s.HK);
  const int q0 = qb * kBlockRows;
  const int2* qt = reinterpret_cast<const int2*>(plan + P.qt) + b * P.nqt;
  const int2* kt = reinterpret_cast<const int2*>(plan + P.kt) + b * P.nkt;
  const int* ku = plan + P.ku + b * P.nkt;
  const int2 walk = tile_rec(plan, P.qb, e);  // key tiles [first, last]
  const int2 range = block_range(qt, P.nqt, 2 * qb);
  // stage p (tiles kVfTiles p ..) is loaded when one of its tiles lies in
  // [first, last] and meets the block's ids
  const auto wanted = [&](int p) {
    bool any = false;
#pragma unroll
    for (int i = 0; i < kVfTiles; ++i) {
      const int t = kVfTiles * p + i;
      any |= t >= walk.x && t <= walk.y && meets(kt[t], range);
    }
    return any;
  };
  const int p0 = walk.x / kVfTiles;
  const int p1 = walk.y >= walk.x ? walk.y / kVfTiles : p0 - 1;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + 8 * i, 32);               // the producer warp
      mbar_init(empty + 8 * i, 4 * kConsumers);  // a warp each
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: its first warp stages the key ids, its lane 0 issues the
    // copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x / 32 == 4 * kConsumers) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(qfull, kConsumers * L::kQWg);
        for (int w = 0; w < kConsumers; ++w)
          for (int c = 0; c < D / 64; ++c)
            tma_load(base + L::kQ + w * L::kQWg + c * kBox, &tq, qfull,
                     64 * c, h, q0 + kRows * w, b);
      }
      const int* sk = seg_k + size_t(b) * s.Sk;
      int it = 0;
      for (int p = p0; p <= p1; ++p) {
        if (!wanted(p)) continue;
        const int st = it % NS;
        mbar_wait(empty + 8 * st, ((it / NS) & 1) ^ 1);
        const int k0 = p * kVfKeys;
        stage_ids(reinterpret_cast<int*>(gbase + L::kIds) + st * kVfKeys, sk,
                  s.Sk, k0, kVfKeys, lane);
        if (lane == 0) {
          mbar_expect_tx(full + 8 * st, L::kStage);
          const uint32_t kst = base + st * L::kStage;
          for (int c = 0; c < D / 64; ++c)
            for (int r = 0; r < kVfKeys / kRows; ++r) {
              const uint32_t off = c * L::kChunk + r * kBox;
              tma_load(kst + off, &tk, full + 8 * st, 64 * c, kh,
                       k0 + kRows * r, b);
              tma_load(kst + L::kTile + off, &tv, full + 8 * st, 64 * c, kh,
                       k0 + kRows * r, b);
            }
        } else {
          mbar_arrive(full + 8 * st);
        }
        ++it;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = q0 + kRows * wg;  // this warpgroup's rows [r0, r0 + 64)
    const int my = 2 * qb + wg;      // and its plan tile
    const int2 mine = my < P.nqt ? qt[my] : make_int2(kEmptyLo, -1);
    const bool mine_uni = my < P.nqt && plan[P.qu + b * P.nqt + my] != 0;
    int wlo = 0, whi = -1;
    if (r0 < s.Sq) key_band(s, r0, min(r0 + kRows, s.Sq) - 1, wlo, whi);
    const float sl2 = fabsf(s.scale) * kLog2e;
    const size_t rs = size_t(s.H) * D;  // elements between rows
    const int row0 = r0 + 16 * warp + g;  // this thread's rows: +0, +8
    const size_t roff = ((size_t(b) * s.Sq + row0) * s.H + h) * D;
    const int* sq = seg_q + size_t(b) * s.Sq;
    const int ids[2] = {own_id(sq, s.Sq, row0), own_id(sq, s.Sq, row0 + 8)};
    const uint32_t qs = base + L::kQ + wg * L::kQWg;  // this warpgroup's Q
    mbar_wait(qfull, 0);
    if (s.scale < 0.f) {
      // -Q, exact, as the dense forward
      for (int i = tid; i < L::kQWg / 4; i += 128) {
        const uint32_t a = qs + 4 * i;
        asm volatile(
            "{\n.reg .b32 x;\nld.shared.b32 x, [%0];\n"
            "xor.b32 x, x, 0x80008000;\nst.shared.b32 [%0], x;\n}\n" ::"r"(a)
            : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    int it = 0;
    for (int p = p0; p <= p1; ++p) {
      if (!wanted(p)) continue;
      const int st = it % NS;
      const int k0 = p * kVfKeys;
      mbar_wait(full + 8 * st, (it / NS) & 1);
      // hit: a tile of the stage meets this warpgroup's ids; one: every
      // tile is its one segment, whole
      bool hit = false, one = mine_uni;
#pragma unroll
      for (int i = 0; i < kVfTiles; ++i) {
        const int tt = kVfTiles * p + i;
        const bool in = tt < P.nkt;
        const int2 r = in ? kt[tt] : make_int2(kEmptyLo, -1);
        hit |= meets(r, mine);
        one &= in && ku[tt] != 0 && r.x == mine.x;
      }
      if (k0 <= whi && k0 + kVfKeys - 1 >= wlo && hit) {
        const uint32_t kst = base + st * L::kStage;
        const uint32_t vst = kst + L::kTile;
        const int* kid = reinterpret_cast<const int*>(gbase + L::kIds) +
                         st * kVfKeys;
        // S = Q K^T: 64 rows x kVfKeys keys
        float sc[kVfKeys / 2];
        wg_fence();
        wg_ss<T, kVfKeys, 0, 0>(sc, desc_kmajor(qs, 0),
                                desc_kmajor(kst, 0, L::kChunk));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wg_ss<T, kVfKeys, 0>(sc, desc_kmajor(qs, kk),
                               desc_kmajor(kst, kk, L::kChunk));
        wg_commit();
        wg_wait_all();
        reg_fence(sc);
        // one segment over the whole stage and the band not cutting it:
        // no mask
        const bool whole =
            one && tile_full(s, r0, r0 + kRows - 1, k0, k0 + kVfKeys - 1);
        const auto live = [&](int i) {
          const int r = (i >> 1) & 1;
          const int c = 2 * t + 8 * (i >> 2) + (i & 1);
          return is_live(s, row0 + 8 * r, k0 + c) & (ids[r] == kid[c]);
        };
        if (whole)
          online_softmax<false, kVfKeys, D>(sc, acc, m, l, sl2, live);
        else
          online_softmax<true, kVfKeys, D>(sc, acc, m, l, sl2, live);
        // O += P (rounded to T) V, V read MN-major
        uint32_t pa[kVfKeys / 16][4];
        to_a<T, kVfKeys / 16>(pa, sc);
        reg_fence(acc);
        reg_fence(pa);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kVfKeys / 16; ++kk)
          wg_rs<T, D, 1>(acc, pa[kk], desc_mnmajor(vst, kk, L::kChunk));
        wg_commit();
        wg_wait_all();
        reg_fence(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
      ++it;
    }
    constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (row >= s.Sq) continue;
      const bool any = l[r] > 0.f;
      const float inv = any ? 1.f / l[r] : 0.f;
      u16* out = o + roff + size_t(8 * r) * rs + 2 * t;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(out + 8 * c) = pack2<T>(
            acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
      if (t == 0)
        lse[(size_t(b) * s.H + h) * s.Sq + row] =
            any ? (m[r] + log2f(l[r])) * kLn2 : kNegInf;
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: a block owns 128 q rows of one query head; 64 keys a stage
// ---------------------------------------------------------------------------
template <int D, int NS>
struct VdqLayout {
  static constexpr int kTile = (D / 64) * kBox;  // 64 rows x D
  static constexpr int kStage = 2 * kTile;       // K, then V
  static constexpr int kQ = NS * kStage;         // Q of both warpgroups
  static constexpr int kDo = kQ + kConsumers * kTile;  // dO of both
  static constexpr int kIds = kDo + kConsumers * kTile;  // NS x 64 key ids
  static constexpr int kBars = kIds + NS * kRows * 4;
  static constexpr int kBytes = kBars + 8 * (2 * NS + 1) + 1024;
};

constexpr int kVdqStages = 4;

template <typename T, int D, int NS>
__global__ void __launch_bounds__(kThreads, 1)
    varlen_dq_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const int* __restrict__ seg_q,
                   const int* __restrict__ seg_k,
                   const int* __restrict__ plan,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   const u16* __restrict__ o, const u16* __restrict__ dout,
                   u16* __restrict__ dq, int use_order, Shape s) {
  using L = VdqLayout<D, NS>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  unsigned char* const gbase = smem + (base - smem_addr(smem));
  const uint32_t full = base + L::kBars, empty = full + 8 * NS;
  const uint32_t qfull = empty + 8 * NS;
  const PlanLayout P(s.B, s.Sq, s.Sk);
  const int rank = blockIdx.x / s.H, h = blockIdx.x % s.H;
  const int e = block_entry(plan, P.qo, use_order, rank, s.B, P.nqb, true);
  const int b = e / P.nqb, qb = e % P.nqb;
  const int bh = b * s.H + h;
  const int kh = h / (s.H / s.HK);
  const int q0 = qb * kBlockRows;
  const int2* qt = reinterpret_cast<const int2*>(plan + P.qt) + b * P.nqt;
  const int2* kt = reinterpret_cast<const int2*>(plan + P.kt) + b * P.nkt;
  const int* ku = plan + P.ku + b * P.nkt;
  const int2 walk = tile_rec(plan, P.qb, e);
  const int2 range = block_range(qt, P.nqt, 2 * qb);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + 8 * i, 32);               // the producer warp
      mbar_init(empty + 8 * i, 4 * kConsumers);  // a warp each
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x / 32 == 4 * kConsumers) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        // Q and dO of both warpgroups, rows past Sq zero
        mbar_expect_tx(qfull, 2 * kConsumers * L::kTile);
        for (int w = 0; w < kConsumers; ++w)
          for (int c = 0; c < D / 64; ++c) {
            tma_load(base + L::kQ + w * L::kTile + c * kBox, &tq, qfull,
                     64 * c, h, q0 + kRows * w, b);
            tma_load(base + L::kDo + w * L::kTile + c * kBox, &tdo, qfull,
                     64 * c, h, q0 + kRows * w, b);
          }
      }
      const int* sk = seg_k + size_t(b) * s.Sk;
      int it = 0;
      for (int kt0 = walk.x; kt0 <= walk.y; ++kt0) {
        if (!meets(kt[kt0], range)) continue;
        const int st = it % NS;
        mbar_wait(empty + 8 * st, ((it / NS) & 1) ^ 1);
        const int k0 = kt0 * kRows;
        stage_ids(reinterpret_cast<int*>(gbase + L::kIds) + st * kRows, sk,
                  s.Sk, k0, kRows, lane);
        if (lane == 0) {
          mbar_expect_tx(full + 8 * st, L::kStage);
          const uint32_t kst = base + st * L::kStage;
          for (int c = 0; c < D / 64; ++c) {
            tma_load(kst + c * kBox, &tk, full + 8 * st, 64 * c, kh, k0, b);
            tma_load(kst + L::kTile + c * kBox, &tv, full + 8 * st, 64 * c,
                     kh, k0, b);
          }
        } else {
          mbar_arrive(full + 8 * st);
        }
        ++it;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = q0 + kRows * wg;
    const int my = 2 * qb + wg;
    const int2 mine = my < P.nqt ? qt[my] : make_int2(kEmptyLo, -1);
    const bool mine_uni = my < P.nqt && plan[P.qu + b * P.nqt + my] != 0;
    int wlo = 0, whi = -1;
    if (r0 < s.Sq) key_band(s, r0, min(r0 + kRows, s.Sq) - 1, wlo, whi);
    const float sl2 = s.scale * kLog2e;
    const size_t rs = size_t(s.H) * D;
    const int row0 = r0 + 16 * warp + g;
    const int* sq = seg_q + size_t(b) * s.Sq;
    const int ids[2] = {own_id(sq, s.Sq, row0), own_id(sq, s.Sq, row0 + 8)};
    // this thread's rows: lse in base 2 (+inf for a row with no live key,
    // so its P is 0) and delta
    float lr[2], dr[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const float lv = row < s.Sq ? lse[size_t(bh) * s.Sq + row] : kNegInf;
      lr[r] = lv == kNegInf ? INFINITY : lv * kLog2e;
    }
    if (o != nullptr) {
      // delta = rowsum(o dO) of the warp's 16 rows, a row by the whole
      // warp, written out for the dK/dV kernel (as the dense dQ kernel)
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        const int row = r0 + 16 * warp + rr;
        float v = 0.f;
        if (row < s.Sq) {
          const size_t off =
              ((size_t(b) * s.Sq + row) * s.H + h) * D + lane * (D / 32);
          v = warp_sum(row_dot<T, D>(o + off, dout + off));
          if (lane == 0) delta[size_t(bh) * s.Sq + row] = v;
        }
        if (rr == g) dr[0] = v;
        if (rr == g + 8) dr[1] = v;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        dr[r] = row < s.Sq ? delta[size_t(bh) * s.Sq + row] : 0.f;
      }
    }
    const float drs[2] = {dr[0] * s.scale, dr[1] * s.scale};
    const uint32_t qs = base + L::kQ + wg * L::kTile;
    const uint32_t dos = base + L::kDo + wg * L::kTile;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(qfull, 0);
    int it = 0;
    for (int kt0 = walk.x; kt0 <= walk.y; ++kt0) {
      if (!meets(kt[kt0], range)) continue;
      const int st = it % NS;
      const int k0 = kt0 * kRows;
      mbar_wait(full + 8 * st, (it / NS) & 1);
      if (k0 <= whi && k0 + kRows - 1 >= wlo && meets(kt[kt0], mine)) {
        const uint32_t kst = base + st * L::kStage;
        const uint32_t vst = kst + L::kTile;
        const int* kid = reinterpret_cast<const int*>(gbase + L::kIds) +
                         st * kRows;
        // S = Q K^T, dP = dO V^T, every operand from shared memory
        float sc[32], dp[32];
        wg_fence();
        wg_ss<T, 64, 0, 0>(sc, desc_kmajor(qs, 0), desc_kmajor(kst, 0));
        wg_ss<T, 64, 0, 0>(dp, desc_kmajor(dos, 0), desc_kmajor(vst, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk) {
          wg_ss<T, 64, 0>(sc, desc_kmajor(qs, kk), desc_kmajor(kst, kk));
          wg_ss<T, 64, 0>(dp, desc_kmajor(dos, kk), desc_kmajor(vst, kk));
        }
        wg_commit();
        wg_wait_all();
        reg_fence(sc);
        reg_fence(dp);
        // dS = P (dP - delta) scale, P = 2^(S scale log2e - lse log2e); 0
        // where masked (a select after the arithmetic)
        const bool whole = mine_uni && ku[kt0] != 0 && kt[kt0].x == mine.x &&
                           tile_full(s, r0, r0 + kRows - 1, k0,
                                     k0 + kRows - 1);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          sc[i] = fast_exp2(sc[i] * sl2 - lr[r]) * (dp[i] * s.scale - drs[r]);
        }
        if (!whole) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1;
            const int c = 8 * (i >> 2) + 2 * t + (i & 1);
            const bool live =
                is_live(s, row0 + 8 * r, k0 + c) & (ids[r] == kid[c]);
            sc[i] = live ? sc[i] : 0.f;
          }
        }
        // dQ += dS (rounded to T) K, K read MN-major
        uint32_t a[4][4];
        to_a<T, 4>(a, sc);
        reg_fence(acc);
        reg_fence(a);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wg_rs<T, D, 1>(acc, a[kk], desc_mnmajor(kst, kk));
        wg_commit();
        wg_wait_all();
        reg_fence(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
      ++it;
    }
    const size_t roff = ((size_t(b) * s.Sq + row0) * s.H + h) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= s.Sq) continue;
      u16* out = dq + roff + size_t(8 * r) * rs + 2 * t;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(out + 8 * c) =
            pack2<T>(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV: a block owns 128 keys of one KV head, K and V resident in shared
// memory, and walks the G query heads of its group and their q tiles in order
// ---------------------------------------------------------------------------
template <int D, int NS>
struct VdkvLayout {
  static constexpr int kTile = (D / 64) * kBox;
  static constexpr int kK = 0;                      // K of both warpgroups
  static constexpr int kV = kConsumers * kTile;     // V of both
  static constexpr int kRing = 2 * kConsumers * kTile;
  // a stage: Q, dO, then 64 each of lse (base 2), delta and q ids
  static constexpr int kRowData = 2 * kTile;
  static constexpr int kStage = 2 * kTile + 1024;
  static constexpr int kBars = kRing + NS * kStage;  // full, empty, kv
  static constexpr int kBytes = kBars + 8 * (2 * NS + 1) + 1024;
};

template <int D>
constexpr int vdkv_stages() {
  return D == 128 ? 3 : 4;
}

template <typename T, int D, int NS>
__global__ void __launch_bounds__(kThreads, 1)
    varlen_dkv_sm90(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const int* __restrict__ seg_q,
                    const int* __restrict__ seg_k,
                    const int* __restrict__ plan,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, u16* __restrict__ dk,
                    u16* __restrict__ dv, float* __restrict__ ws, int splits,
                    int use_order, Shape s) {
  using L = VdkvLayout<D, NS>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  unsigned char* const gbase = smem + (base - smem_addr(smem));
  const uint32_t full = base + L::kBars, empty = full + 8 * NS;
  const uint32_t kvbar = empty + 8 * NS;
  const PlanLayout P(s.B, s.Sq, s.Sk);
  // launch rank -> (batch row, key block); within a rank, (KV head, split)
  const int per = s.HK * splits;
  const int rank = blockIdx.x / per, rem = blockIdx.x % per;
  const int split = rem % splits, kh = rem / splits;
  const int e = block_entry(plan, P.ko, use_order, rank, s.B, P.nkb, false);
  const int b = e / P.nkb, kb = e % P.nkb;
  const int k0 = kb * kBlockRows;
  const int G = s.H / s.HK;
  const int h0 = kh * G + G * split / splits;
  const int nh = kh * G + G * (split + 1) / splits - h0;
  const int2* qt = reinterpret_cast<const int2*>(plan + P.qt) + b * P.nqt;
  const int2* kt = reinterpret_cast<const int2*>(plan + P.kt) + b * P.nkt;
  const int* qu = plan + P.qu + b * P.nqt;
  const int2 walk = tile_rec(plan, P.kb, e);  // q tiles [first, last]
  const int2 range = block_range(kt, P.nkt, 2 * kb);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + 8 * i, 32);               // the producer warp
      mbar_init(empty + 8 * i, 4 * kConsumers);  // a warp each
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: its first warp stages lse, delta and the q ids, its lane 0
    // issues the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x / 32 == 4 * kConsumers) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        const int nk = min(kConsumers, (s.Sk - k0 + kRows - 1) / kRows);
        mbar_expect_tx(kvbar, 2 * nk * L::kTile);
        for (int w = 0; w < nk; ++w)
          for (int c = 0; c < D / 64; ++c) {
            const int off = w * L::kTile + c * kBox;
            tma_load(base + L::kK + off, &tk, kvbar, 64 * c, kh,
                     k0 + kRows * w, b);
            tma_load(base + L::kV + off, &tv, kvbar, 64 * c, kh,
                     k0 + kRows * w, b);
          }
      }
      const int* sq = seg_q + size_t(b) * s.Sq;
      int it = 0;
      for (int hh = 0; hh < nh; ++hh) {
        const int h = h0 + hh;
        for (int qt0 = walk.x; qt0 <= walk.y; ++qt0) {
          if (!meets(qt[qt0], range)) continue;
          const int q0 = qt0 * kRows;
          const int st = it % NS;
          mbar_wait(empty + 8 * st, ((it / NS) & 1) ^ 1);
          const uint32_t qs = base + L::kRing + st * L::kStage;
          float* rows = reinterpret_cast<float*>(gbase + L::kRing +
                                                 st * L::kStage + L::kRowData);
          const float* lh = lse + (size_t(b) * s.H + h) * s.Sq;
          const float* dh = delta + (size_t(b) * s.H + h) * s.Sq;
          for (int i = lane; i < kRows; i += 32) {
            const int row = q0 + i;
            const float lv = row < s.Sq ? lh[row] : kNegInf;
            rows[i] = lv == kNegInf ? INFINITY : lv * kLog2e;
            rows[kRows + i] = row < s.Sq ? dh[row] : 0.f;
          }
          stage_ids(reinterpret_cast<int*>(rows + 2 * kRows), sq, s.Sq, q0,
                    kRows, lane);
          if (lane == 0) {
            mbar_expect_tx(full + 8 * st, 2 * L::kTile);
            for (int c = 0; c < D / 64; ++c) {
              tma_load(qs + c * kBox, &tq, full + 8 * st, 64 * c, h, q0, b);
              tma_load(qs + L::kTile + c * kBox, &tdo, full + 8 * st, 64 * c,
                       h, q0, b);
            }
          } else {
            mbar_arrive(full + 8 * st);
          }
          ++it;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int kw = k0 + kRows * wg;  // this warpgroup's keys [kw, kw + 64)
    const int my = 2 * kb + wg;
    const int2 mine = my < P.nkt ? kt[my] : make_int2(kEmptyLo, -1);
    const bool mine_uni = my < P.nkt && plan[P.ku + b * P.nkt + my] != 0;
    int wlo = 0, whi = -1;
    if (kw < s.Sk) query_band(s, kw, min(kw + kRows, s.Sk) - 1, wlo, whi);
    const float sl2 = s.scale * kLog2e;
    const int key0 = kw + 16 * warp + g;  // this thread's keys: +0, +8
    const int* sk = seg_k + size_t(b) * s.Sk;
    const int ids[2] = {own_id(sk, s.Sk, key0), own_id(sk, s.Sk, key0 + 8)};
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    const uint32_t kst = base + L::kK + wg * L::kTile;
    const uint32_t vst = base + L::kV + wg * L::kTile;
    mbar_wait(kvbar, 0);
    int it = 0;
    for (int hh = 0; hh < nh; ++hh) {
      for (int qt0 = walk.x; qt0 <= walk.y; ++qt0) {
        if (!meets(qt[qt0], range)) continue;
        const int q0 = qt0 * kRows;
        const int st = it % NS;
        mbar_wait(full + 8 * st, (it / NS) & 1);
        if (q0 <= whi && q0 + kRows - 1 >= wlo && meets(qt[qt0], mine)) {
          const uint32_t qs = base + L::kRing + st * L::kStage;
          const uint32_t dos = qs + L::kTile;
          const float* rows = reinterpret_cast<const float*>(
              gbase + L::kRing + st * L::kStage + L::kRowData);
          const int* qid = reinterpret_cast<const int*>(rows + 2 * kRows);
          // S^T = K Q^T, dP^T = V dO^T: 64 keys x 64 q rows
          float sc[32], dp[32];
          wg_fence();
          wg_ss<T, 64, 0, 0>(sc, desc_kmajor(kst, 0), desc_kmajor(qs, 0));
          wg_ss<T, 64, 0, 0>(dp, desc_kmajor(vst, 0), desc_kmajor(dos, 0));
#pragma unroll
          for (int kk = 1; kk < D / 16; ++kk) {
            wg_ss<T, 64, 0>(sc, desc_kmajor(kst, kk), desc_kmajor(qs, kk));
            wg_ss<T, 64, 0>(dp, desc_kmajor(vst, kk), desc_kmajor(dos, kk));
          }
          wg_commit();
          wg_wait_all();
          reg_fence(sc);
          reg_fence(dp);
          // P^T and dS^T = P^T (dP^T - delta) scale; 0 where masked (a
          // select after the arithmetic)
          float lq[16], dls[16];  // lse (base 2), delta scale: 16 q columns
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float2 l2 =
                *reinterpret_cast<const float2*>(rows + 8 * c + 2 * t);
            const float2 d2 = *reinterpret_cast<const float2*>(
                rows + kRows + 8 * c + 2 * t);
            lq[2 * c] = l2.x;
            lq[2 * c + 1] = l2.y;
            dls[2 * c] = d2.x * s.scale;
            dls[2 * c + 1] = d2.y * s.scale;
          }
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = 2 * (i >> 2) + (i & 1);  // of lq, dls
            const float p = fast_exp2(sc[i] * sl2 - lq[col]);
            dp[i] = p * (dp[i] * s.scale - dls[col]);
            sc[i] = p;
          }
          const bool whole = mine_uni && qu[qt0] != 0 &&
                             qt[qt0].x == mine.x &&
                             tile_full(s, q0, q0 + kRows - 1, kw,
                                       kw + kRows - 1);
          if (!whole) {
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int r = (i >> 1) & 1;
              const int qi = 8 * (i >> 2) + 2 * t + (i & 1);
              const bool live =
                  is_live(s, q0 + qi, key0 + 8 * r) & (qid[qi] == ids[r]);
              sc[i] = live ? sc[i] : 0.f;
              dp[i] = live ? dp[i] : 0.f;
            }
          }
          // dV += P^T dO, dK += dS^T Q: P and dS rounded to T, dO and Q
          // read MN-major
          uint32_t pa[4][4], sa[4][4];
          to_a<T, 4>(pa, sc);
          to_a<T, 4>(sa, dp);
          reg_fence(dva);
          reg_fence(dka);
          reg_fence(pa);
          reg_fence(sa);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wg_rs<T, D, 1>(dva, pa[kk], desc_mnmajor(dos, kk));
            wg_rs<T, D, 1>(dka, sa[kk], desc_mnmajor(qs, kk));
          }
          wg_commit();
          wg_wait_all();
          reg_fence(dva);
          reg_fence(dka);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * st);
        ++it;
      }
    }
    const size_t n = size_t(s.B) * s.Sk * s.HK * D;  // elements of dK
    float* pk = ws + split * n;                       // this split's partials
    float* pv = ws + (splits + split) * n;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= s.Sk) continue;
      const size_t off = ((size_t(b) * s.Sk + key) * s.HK + kh) * D + 2 * t;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const float2 x =
            make_float2(dka[4 * c + 2 * r], dka[4 * c + 2 * r + 1]);
        const float2 y =
            make_float2(dva[4 * c + 2 * r], dva[4 * c + 2 * r + 1]);
        if (splits == 1) {
          *reinterpret_cast<uint32_t*>(dk + off + 8 * c) = pack2<T>(x.x, x.y);
          *reinterpret_cast<uint32_t*>(dv + off + 8 * c) = pack2<T>(y.x, y.y);
        } else {
          *reinterpret_cast<float2*>(pk + off + 8 * c) = x;
          *reinterpret_cast<float2*>(pv + off + 8 * c) = y;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------
template <typename K>
int allow_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T, int D>
int launch_vfwd(const CUtensorMap* m, const int* sq, const int* sk,
                const int* plan, void* o, float* lse, int use_order,
                const Shape& s, cudaStream_t st) {
  constexpr int NS = vf_stages<D>();
  constexpr int bytes = VfLayout<D, NS>::kBytes;
  if (int err = allow_smem(varlen_fwd_sm90<T, D, NS>, bytes)) return err;
  const PlanLayout P(s.B, s.Sq, s.Sk);
  varlen_fwd_sm90<T, D, NS><<<P.nqb * s.B * s.H, kThreads, bytes, st>>>(
      m[0], m[1], m[2], sq, sk, plan, static_cast<u16*>(o), lse, use_order,
      s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_vdq(const CUtensorMap* m, const int* sq, const int* sk,
               const int* plan, const float* lse, float* delta,
               const void* o, const void* dout, void* dq, int use_order,
               const Shape& s, cudaStream_t st) {
  constexpr int NS = kVdqStages;
  constexpr int bytes = VdqLayout<D, NS>::kBytes;
  if (int err = allow_smem(varlen_dq_sm90<T, D, NS>, bytes)) return err;
  const PlanLayout P(s.B, s.Sq, s.Sk);
  varlen_dq_sm90<T, D, NS><<<P.nqb * s.B * s.H, kThreads, bytes, st>>>(
      m[0], m[1], m[2], m[3], sq, sk, plan, lse, delta,
      static_cast<const u16*>(o), static_cast<const u16*>(dout),
      static_cast<u16*>(dq), use_order, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_vdkv(const CUtensorMap* m, const int* sq, const int* sk,
                const int* plan, const float* lse, const float* delta,
                void* dk, void* dv, float* ws, int splits, int use_order,
                const Shape& s, cudaStream_t st) {
  constexpr int NS = vdkv_stages<D>();
  constexpr int bytes = VdkvLayout<D, NS>::kBytes;
  if (int err = allow_smem(varlen_dkv_sm90<T, D, NS>, bytes)) return err;
  const PlanLayout P(s.B, s.Sq, s.Sk);
  varlen_dkv_sm90<T, D, NS>
      <<<P.nkb * s.B * s.HK * splits, kThreads, bytes, st>>>(
          m[0], m[1], m[2], m[3], sq, sk, plan, lse, delta,
          static_cast<u16*>(dk), static_cast<u16*>(dv), ws, splits,
          use_order, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = size_t(s.B) * s.Sk * s.HK * D;
  const size_t want = (n / 2 + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  flash_dkv_sum_sm90<T><<<blocks, 256, 0, st>>>(
      ws, splits, n, static_cast<u16*>(dk), static_cast<u16*>(dv));
  return static_cast<int>(cudaGetLastError());
}

// the maps of q, k, v and (given) dO, or false
inline bool varlen_maps(CUtensorMap* m, const void* q, const void* k,
                        const void* v, const void* dout, const Shape& s,
                        int D, int dtype) {
  return make_map(&m[0], q, s.B, s.Sq, s.H, D, dtype) &&
         make_map(&m[1], k, s.B, s.Sk, s.HK, D, dtype) &&
         make_map(&m[2], v, s.B, s.Sk, s.HK, D, dtype) &&
         (dout == nullptr || make_map(&m[3], dout, s.B, s.Sq, s.H, D, dtype));
}

}  // namespace pdt_sm90

// The plan of (B, Sq) / (B, Sk) segment ids into `plan` (PlanLayout(B, Sq,
// Sk).words int32 words): one block.
extern "C" int pdt_varlen_plan(const void* seg_q, const void* seg_k,
                               void* plan, int B, int Sq, int Sk, int causal,
                               void* stream) {
  using namespace pdt_sm90;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || !bind_device(seg_q))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  varlen_plan<<<1, kPlanThreads, 0, st>>>(static_cast<const int*>(seg_q),
                                          static_cast<const int*>(seg_k),
                                          static_cast<int*>(plan), B, Sq, Sk,
                                          causal);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 1 = bfloat16, 2 = float16 (q, k, v and o share it). order: 1 runs
// the blocks in the plan's order, 0 in the dense kernels'.
extern "C" int pdt_varlen_fwd_sm90(const void* q, const void* k,
                                   const void* v, const void* seg_q,
                                   const void* seg_k, const void* plan,
                                   void* o, void* lse, int order, int B,
                                   int Sq, int Sk, int H, int HK, int D,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  using namespace pdt_sm90;
  if (!takes(B, Sq, Sk, H, HK, D, dtype) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o) || !bind_device(q))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(B, Sq, Sk, H, HK, scale, causal, 0);
  CUtensorMap m[4];
  if (!varlen_maps(m, q, k, v, nullptr, s, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_k);
  const int* p = static_cast<const int*>(plan);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D == 64 ? launch_vfwd<bf16, 64>(m, sq, sk, p, o, l, order, s, st)
                   : launch_vfwd<bf16, 128>(m, sq, sk, p, o, l, order, s, st);
  return D == 64 ? launch_vfwd<f16, 64>(m, sq, sk, p, o, l, order, s, st)
                 : launch_vfwd<f16, 128>(m, sq, sk, p, o, l, order, s, st);
}

// delta = rowsum(o dO) (B, H, Sq) f32: with o null the kernel reads it;
// with o it computes it for its rows and writes it for the dK/dV kernel,
// which runs after it on the stream.
extern "C" int pdt_varlen_bwd_dq_sm90(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, void* delta,
                                      const void* o, const void* seg_q,
                                      const void* seg_k, const void* plan,
                                      void* dq, int order, int B, int Sq,
                                      int Sk, int H, int HK, int D,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  using namespace pdt_sm90;
  if (!takes(B, Sq, Sk, H, HK, D, dtype) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout) || !aligned16(dq) || !aligned16(o) ||
      !bind_device(q))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(B, Sq, Sk, H, HK, scale, causal, 0);
  CUtensorMap m[4];
  if (!varlen_maps(m, q, k, v, dout, s, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_k);
  const int* p = static_cast<const int*>(plan);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D == 64 ? launch_vdq<bf16, 64>(m, sq, sk, p, l, dl, o, dout, dq,
                                          order, s, st)
                   : launch_vdq<bf16, 128>(m, sq, sk, p, l, dl, o, dout, dq,
                                           order, s, st);
  return D == 64 ? launch_vdq<f16, 64>(m, sq, sk, p, l, dl, o, dout, dq,
                                       order, s, st)
                 : launch_vdq<f16, 128>(m, sq, sk, p, l, dl, o, dout, dq,
                                        order, s, st);
}

// splits: how many blocks share a KV head's query heads (1..H / HK); past 1,
// ws holds 2 * splits * (B * Sk * HK * D) f32 partial sums, added in order
// by a second kernel.
extern "C" int pdt_varlen_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    const void* plan, void* dk, void* dv, void* ws, int splits, int order,
    int B, int Sq, int Sk, int H, int HK, int D, float scale, int causal,
    int dtype, void* stream) {
  using namespace pdt_sm90;
  if (!takes(B, Sq, Sk, H, HK, D, dtype) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout) || !aligned16(dk) || !aligned16(dv) ||
      splits < 1 || splits > H / HK ||
      (splits > 1 && (ws == nullptr || !aligned16(ws))) || !bind_device(q))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(B, Sq, Sk, H, HK, scale, causal, 0);
  CUtensorMap m[4];
  if (!varlen_maps(m, q, k, v, dout, s, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_k);
  const int* p = static_cast<const int*>(plan);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D == 64 ? launch_vdkv<bf16, 64>(m, sq, sk, p, l, dl, dk, dv, w,
                                           splits, order, s, st)
                   : launch_vdkv<bf16, 128>(m, sq, sk, p, l, dl, dk, dv, w,
                                            splits, order, s, st);
  return D == 64 ? launch_vdkv<f16, 64>(m, sq, sk, p, l, dl, dk, dv, w,
                                        splits, order, s, st)
                 : launch_vdkv<f16, 128>(m, sq, sk, p, l, dl, dk, dv, w,
                                         splits, order, s, st);
}
