// Flash attention backward for Hopper (sm_90a) on wgmma and TMA: the dQ and
// the dK/dV kernels of dense GQA attention (end-aligned causal mask, optional
// sliding window), bf16 and f16, head dims 64 and 128.
//
// Replaces, at those dtypes and head dims: paddle_tpu/ops/flash_attention.py
// _bwd_dq_kernel (:223, pallas_call at :333) and _bwd_dkv_kernel (:270,
// pallas_call at :361). Every other input takes the mma.sync kernels of
// flash_kernels.cuh (flash_attention.cu). The Hopper building blocks
// (sm90.cuh) and the shapes, masks and tensor maps (flash_sm90.cuh) are
// shared with the wgmma forward (flash_fwd_sm90.cu).
//
// Semantics, layouts and results are those of flash_kernels.cuh: (B, S, H,
// D) tensors read in place, lse and delta (B, H, Sq) f32, query head h reads
// KV head h / (H / HK), q row i sees key j iff j <= i + Sk - Sq when causal
// and j > i + Sk - Sq - w under a window w; a row with no live key (lse
// -1e30) gets zero gradient; any Sq, Sk (TMA's zero fill takes the tails,
// the masks drop them).
//
// What bounds them on this card: operations (10D to 14D flops a (q row,
// key) pair against a few bytes a row). The design keeps the tensor cores
// fed:
// - Products on wgmma, 64 rows a warpgroup. S = Q.K^T and dP = dO.V^T
//   (dQ) take the block's Q and dO tiles, landed once by TMA, and the K
//   and V tiles, all from shared memory, K-major. S^T = K.Q^T and dP^T =
//   V.dO^T (dK/dV) take the resident K and V and the streamed Q and dO
//   tiles from shared memory, K-major. dS (dQ) and P^T, dS^T (dK/dV) are
//   formed in the accumulator registers, rounded once to T and fed back
//   as the register A operand of dQ += dS.K, dV += P^T.dO and dK +=
//   dS^T.Q, whose B operand is the same shared tile read MN-major through
//   the descriptor's transpose bit: no tile is ever transposed or copied.
//   No register A operand lives across the key or q loop: ptxas has given
//   such loop-invariant fragments' registers to other values of the loop
//   with no warning (the forward's Q once), so every A operand that
//   outlives one product is a shared-memory descriptor.
// - Tiles arrive by TMA: 4-D tensor maps over (D, H, S, B) with a 64 x 64
//   box (128 bytes a row) and the 128-byte swizzle that wgmma reads; D 128
//   takes two boxes a row. A producer warp keeps a ring of NS stages in
//   flight, tracked by mbarriers (full: the bytes landed; empty: both
//   consumer warpgroups are done with the stage).
// - Warp specialisation: two consumer warpgroups and one producer
//   warpgroup; setmaxnreg moves registers from the producer (24) to the
//   consumers (240), which hold up to two f32 accumulators of 64 x D
//   beside S and dP. Each warpgroup waits for its products before it
//   forms dS: the element work of one warpgroup overlaps the other's
//   products.
// - The element work (32 exponentials a thread a tile) is straight-line:
//   the causal and window masks are selects after the arithmetic, never
//   branches around it, so the exponentials interleave. (With a branch
//   per element, each element's exp2 latency was exposed in turn, and
//   the element work took most of each tile: tools/flash_bwd_timeline.py
//   times the phases.)
// - dQ: a block owns 128 q rows of one head, its Q and dO tiles resident;
//   K and V tiles of 64 keys stream through the ring. The dQ kernel also forms delta = rowsum(o dO)
//   of its rows (given o) and writes it for the dK/dV kernel. Blocks run
//   the longest causal q tiles first.
// - dK/dV: a block owns 128 keys of one KV head, K and V resident; it walks
//   the G query heads of its group and their live q tiles in a fixed order,
//   Q, dO, lse and delta streaming through the ring, so dK and dV are
//   deterministic with no atomics. Blocks run the key tiles with the most
//   live q rows first. When there are fewer blocks than SMs (G 7 at S
//   4096: 128), `splits` blocks share a KV head's query heads and write
//   f32 partials that a second kernel adds in split order.
// - Precision: f32 accumulation; P and dS rounded once to T for the dV, dK
//   and dQ products (as FlashAttention and SDPA do; the TPU's MXU multiplies
//   bf16 too); exponentials in base 2 with scale.log2(e) folded in and lse
//   converted once a row.
//
// C interface: device pointers on the caller's current stream; each entry
// returns a CUDA error code: cudaErrorInvalidValue for an input it does not
// take (a dtype other than bf16 / f16, a head dim other than 64 / 128, a
// pointer not 16-byte aligned) or a tensor map the driver refuses, else
// cudaGetLastError() after its launch.

#include "flash_sm90.cuh"

namespace pdt_sm90 {

// ---------------------------------------------------------------------------
// dQ: a block owns 128 q rows of one query head
// ---------------------------------------------------------------------------
template <int D, int NS>
struct DqLayout {
  static constexpr int kTile = (D / 64) * kBox;  // one 64-row tile
  static constexpr int kRing = 0;                // NS x (K, V)
  static constexpr int kStage = 2 * kTile;
  static constexpr int kQ = kRing + NS * kStage;       // Q of both warpgroups
  static constexpr int kDo = kQ + kConsumers * kTile;  // dO of both
  static constexpr int kBars = kDo + kConsumers * kTile;  // full, empty, q
  static constexpr int kBytes = kBars + 8 * (2 * NS + 1) + 1024;  // + align
};

template <typename T, int D, int NS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_sm90(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const u16* __restrict__ dout,
                  const u16* __restrict__ o, const float* __restrict__ lse,
                  float* __restrict__ delta, u16* __restrict__ dq, Shape s) {
  using L = DqLayout<D, NS>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t full = base + L::kBars, empty = full + 8 * NS;
  const uint32_t qfull = empty + 8 * NS;
  // blocks in launch order take the q tiles from the last (the most live
  // keys under a causal mask) back to the first, all heads of a tile
  // together
  const int nbh = s.B * s.H;
  const int nqb = (s.Sq + 2 * kRows - 1) / (2 * kRows);
  const int qb = nqb - 1 - int(blockIdx.x) / nbh;
  const int bh = blockIdx.x % nbh, b = bh / s.H, h = bh % s.H;
  const int kh = h / (s.H / s.HK);
  const int q0 = qb * 2 * kRows;
  int klo, khi;
  key_band(s, q0, min(q0 + 2 * kRows, s.Sq) - 1, klo, khi);
  const int kt0 = klo / kRows;
  const int ntiles = khi >= klo ? khi / kRows - kt0 + 1 : 0;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * kConsumers);  // a warp each
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      // Q and dO of both warpgroups, rows past Sq zero
      mbar_expect_tx(qfull, 2 * kConsumers * L::kTile);
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < D / 64; ++c) {
          tma_load(base + L::kQ + w * L::kTile + c * kBox, &tq, qfull, 64 * c,
                   h, q0 + kRows * w, b);
          tma_load(base + L::kDo + w * L::kTile + c * kBox, &tdo, qfull,
                   64 * c, h, q0 + kRows * w, b);
        }
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % NS;
        mbar_wait(empty + 8 * st, ((it / NS) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, L::kStage);
        const uint32_t kt = base + L::kRing + st * L::kStage;
        const int k0 = (kt0 + it) * kRows;
        for (int c = 0; c < D / 64; ++c) {
          tma_load(kt + c * kBox, &tk, full + 8 * st, 64 * c, kh, k0, b);
          tma_load(kt + L::kTile + c * kBox, &tv, full + 8 * st, 64 * c, kh,
                   k0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = q0 + kRows * wg;  // this warpgroup's rows [r0, r0 + 64)
    int wlo = 0, whi = -1;
    if (r0 < s.Sq) key_band(s, r0, min(r0 + kRows, s.Sq) - 1, wlo, whi);
    const float sl2 = s.scale * kLog2e;
    const size_t rs = size_t(s.H) * D;  // elements between rows
    // this thread's rows g and g + 8 of its warp's 16: lse in base 2 (+inf
    // for a row with no live key, so its P is 0) and delta
    const int row0 = r0 + 16 * warp + g;
    float lr[2], dr[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const float l = row < s.Sq ? lse[size_t(bh) * s.Sq + row] : kNegInf;
      lr[r] = l == kNegInf ? INFINITY : l * kLog2e;
    }
    if (o != nullptr) {
      // delta = rowsum(o dO) of the warp's 16 rows, a row by the whole
      // warp, written out for the dK/dV kernel
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
    const size_t roff = ((size_t(b) * s.Sq + row0) * s.H + h) * D;
    const uint32_t qs = base + L::kQ + wg * L::kTile;
    const uint32_t dos = base + L::kDo + wg * L::kTile;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(qfull, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % NS;
      const int k0 = (kt0 + it) * kRows;
      mbar_wait(full + 8 * st, (it / NS) & 1);
      if (k0 <= whi && k0 + kRows - 1 >= wlo) {
        const uint32_t kt = base + L::kRing + st * L::kStage;
        const uint32_t vt = kt + L::kTile;
        // S = Q K^T, dP = dO V^T, every operand from shared memory
        float sc[32], dp[32];
        wg_fence();
        wg_ss<T, 64, 0, 0>(sc, desc_kmajor(qs, 0), desc_kmajor(kt, 0));
        wg_ss<T, 64, 0, 0>(dp, desc_kmajor(dos, 0), desc_kmajor(vt, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk) {
          wg_ss<T, 64, 0>(sc, desc_kmajor(qs, kk), desc_kmajor(kt, kk));
          wg_ss<T, 64, 0>(dp, desc_kmajor(dos, kk), desc_kmajor(vt, kk));
        }
        wg_commit();
        wg_wait_all();
        reg_fence(sc);
        reg_fence(dp);
        // dS = P (dP - delta) scale, P = 2^(S scale log2e - lse log2e); 0
        // where masked. The mask is a select after the arithmetic (never a
        // branch around it), so the 32 elements' exponentials interleave;
        // a tile the mask keeps whole skips it.
        if (tile_full(s, r0, r0 + kRows - 1, k0, k0 + kRows - 1)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1;
            sc[i] = fast_exp2(sc[i] * sl2 - lr[r]) *
                    (dp[i] * s.scale - drs[r]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1;
            const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            const float ds = fast_exp2(sc[i] * sl2 - lr[r]) *
                             (dp[i] * s.scale - drs[r]);
            sc[i] = is_live(s, row0 + 8 * r, col) ? ds : 0.f;
          }
        }
        // dQ += dS (rounded to T) K, K read MN-major
        uint32_t a[4][4];
        to_a<T, 4>(a, sc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wg_rs<T, D, 1>(acc, a[kk], desc_mnmajor(kt, kk));
        wg_commit();
        wg_wait_all();
        reg_fence(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
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
// dK/dV: a block owns 128 keys of one KV head and walks the G query heads
// of its group and their live q tiles in order
// ---------------------------------------------------------------------------
// K and V of both warpgroups' keys stay resident in shared memory, read as
// wgmma's shared-memory A operands at every q tile
template <int D, int NS>
struct DkvLayout {
  static constexpr int kTile = (D / 64) * kBox;
  // K, then V, of both warpgroups
  static constexpr int kKv = kConsumers * kTile;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKv;
  // NS x (Q, dO, then lse in base 2 and delta: 64 f32 each)
  static constexpr int kRing = kV + kKv;
  static constexpr int kRowData = 2 * kTile;
  static constexpr int kStage = 2 * kTile + 1024;
  static constexpr int kBars = kRing + NS * kStage;  // full, empty, kv
  static constexpr int kBytes = kBars + 8 * (2 * NS + 1) + 1024;
};

template <typename T, int D, int NS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, u16* __restrict__ dk,
                   u16* __restrict__ dv, float* __restrict__ ws, int splits,
                   Shape s) {
  using L = DkvLayout<D, NS>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  unsigned char* const gbase = smem + (base - smem_addr(smem));
  const uint32_t full = base + L::kBars, empty = full + 8 * NS;
  const uint32_t kvbar = empty + 8 * NS;
  // blocks in launch order take the key tiles from the first (the most
  // live q rows under a causal mask) on, all KV heads of a tile together;
  // with `splits` > 1, `splits` blocks share a KV head's G query heads
  // (heads [h0, h1) each) and write f32 partial sums to `ws`
  const int nbh = s.B * s.HK * splits;
  const int k0 = int(blockIdx.x) / nbh * 2 * kRows;
  const int rem = blockIdx.x % nbh, split = rem % splits;
  const int bhk = rem / splits, b = bhk / s.HK, kh = bhk % s.HK;
  const int G = s.H / s.HK;
  const int h0 = kh * G + G * split / splits;
  const int nh = kh * G + G * (split + 1) / splits - h0;
  int qlo, qhi;
  query_band(s, k0, min(k0 + 2 * kRows, s.Sk) - 1, qlo, qhi);
  const int qt0 = qlo / kRows;
  const int nqt = qhi >= qlo ? qhi / kRows - qt0 + 1 : 0;  // q tiles a head
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
    // producer: its first warp stages lse and delta, its lane 0 issues the
    // copies
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
      for (int it = 0; it < nh * nqt; ++it) {
        const int h = h0 + it / nqt;
        const int q0 = (qt0 + it % nqt) * kRows;
        const int st = it % NS;
        mbar_wait(empty + 8 * st, ((it / NS) & 1) ^ 1);
        const uint32_t qs = base + L::kRing + st * L::kStage;
        float* rows = reinterpret_cast<float*>(gbase + L::kRing +
                                               st * L::kStage + L::kRowData);
        const float* lh = lse + (size_t(b) * s.H + h) * s.Sq;
        const float* dh = delta + (size_t(b) * s.H + h) * s.Sq;
        for (int i = lane; i < kRows; i += 32) {
          const int row = q0 + i;
          const float l = row < s.Sq ? lh[row] : kNegInf;
          rows[i] = l == kNegInf ? INFINITY : l * kLog2e;
          rows[kRows + i] = row < s.Sq ? dh[row] : 0.f;
        }
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
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int kw = k0 + kRows * wg;  // this warpgroup's keys [kw, kw + 64)
    int wlo = 0, whi = -1;
    if (kw < s.Sk) query_band(s, kw, min(kw + kRows, s.Sk) - 1, wlo, whi);
    const float sl2 = s.scale * kLog2e;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    const uint32_t kt = base + L::kK + wg * L::kTile;
    const uint32_t vt = base + L::kV + wg * L::kTile;
    mbar_wait(kvbar, 0);
    for (int it = 0; it < nh * nqt; ++it) {
      const int q0 = (qt0 + it % nqt) * kRows;
      const int st = it % NS;
      mbar_wait(full + 8 * st, (it / NS) & 1);
      if (q0 <= whi && q0 + kRows - 1 >= wlo) {
        const uint32_t qs = base + L::kRing + st * L::kStage;
        const uint32_t dos = qs + L::kTile;
        const float* rows = reinterpret_cast<const float*>(
            gbase + L::kRing + st * L::kStage + L::kRowData);
        // S^T = K Q^T, dP^T = V dO^T: 64 keys x 64 q rows
        float sc[32], dp[32];
        wg_fence();
        wg_ss<T, 64, 0, 0>(sc, desc_kmajor(kt, 0), desc_kmajor(qs, 0));
        wg_ss<T, 64, 0, 0>(dp, desc_kmajor(vt, 0), desc_kmajor(dos, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk) {
          wg_ss<T, 64, 0>(sc, desc_kmajor(kt, kk), desc_kmajor(qs, kk));
          wg_ss<T, 64, 0>(dp, desc_kmajor(vt, kk), desc_kmajor(dos, kk));
        }
        wg_commit();
        wg_wait_all();
        reg_fence(sc);
        reg_fence(dp);
        // P^T and dS^T = P^T (dP^T - delta) scale; 0 where masked (a select
        // after the arithmetic, as in the dQ kernel)
        float lq[16], dls[16];  // lse (base 2), delta scale: 16 q columns
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(rows + 8 * c + 2 * t);
          const float2 d2 =
              *reinterpret_cast<const float2*>(rows + kRows + 8 * c + 2 * t);
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
        if (!tile_full(s, q0, q0 + kRows - 1, kw, kw + kRows - 1)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int key = kw + 16 * warp + g + 8 * ((i >> 1) & 1);
            const int qi = 8 * (i >> 2) + 2 * t + (i & 1);
            const bool live = is_live(s, q0 + qi, key);
            sc[i] = live ? sc[i] : 0.f;
            dp[i] = live ? dp[i] : 0.f;
          }
        }
        // dV += P^T dO, dK += dS^T Q: P and dS rounded to T, dO and Q read
        // MN-major
        uint32_t pa[4][4], sa[4][4];
        to_a<T, 4>(pa, sc);
        to_a<T, 4>(sa, dp);
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
    }
    const size_t n = size_t(s.B) * s.Sk * s.HK * D;  // elements of dK
    float* pk = ws + split * n;                       // this split's partials
    float* pv = ws + (splits + split) * n;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kw + 16 * warp + g + 8 * r;
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
// host: tensor maps and launches
// ---------------------------------------------------------------------------
struct Maps {
  CUtensorMap q, k, v, dout;
};

inline bool make_maps(Maps* m, const void* q, const void* k, const void* v,
                      const void* dout, const Shape& s, int D, int dtype) {
  return make_map(&m->q, q, s.B, s.Sq, s.H, D, dtype) &&
         make_map(&m->k, k, s.B, s.Sk, s.HK, D, dtype) &&
         make_map(&m->v, v, s.B, s.Sk, s.HK, D, dtype) &&
         make_map(&m->dout, dout, s.B, s.Sq, s.H, D, dtype);
}

// ring stages: three at D 128 (160 KB of shared memory a block), four at 64
template <int D>
constexpr int stages() {
  return D == 128 ? 3 : 4;
}

template <typename T, int D>
int launch_dq(const Maps& m, const void* dout, const void* o,
              const float* lse, float* delta, void* dq, const Shape& s,
              cudaStream_t st) {
  constexpr int NS = stages<D>();
  constexpr int bytes = DqLayout<D, NS>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_sm90<T, D, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nqb = (s.Sq + 2 * kRows - 1) / (2 * kRows);
  flash_dq_sm90<T, D, NS><<<nqb * s.B * s.H, kThreads, bytes, st>>>(
      m.q, m.k, m.v, m.dout, static_cast<const u16*>(dout),
      static_cast<const u16*>(o), lse, delta, static_cast<u16*>(dq), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Maps& m, const float* lse, const float* delta, void* dk,
               void* dv, float* ws, int splits, const Shape& s,
               cudaStream_t st) {
  constexpr int NS = stages<D>();
  constexpr int bytes = DkvLayout<D, NS>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_sm90<T, D, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nkb = (s.Sk + 2 * kRows - 1) / (2 * kRows);
  flash_dkv_sm90<T, D, NS>
      <<<nkb * s.B * s.HK * splits, kThreads, bytes, st>>>(
          m.q, m.k, m.v, m.dout, lse, delta, static_cast<u16*>(dk),
          static_cast<u16*>(dv), ws, splits, s);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = size_t(s.B) * s.Sk * s.HK * D;
  const size_t want = (n / 2 + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  flash_dkv_sum_sm90<T><<<blocks, 256, 0, st>>>(
      ws, splits, n, static_cast<u16*>(dk), static_cast<u16*>(dv));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pdt_sm90

// dtype: 1 = bfloat16, 2 = float16 (q, k, v, dO, o and the outputs share
// it); window <= 0: no window (a window needs causal). Head dims 64 and 128.
// With o null the dQ kernel reads delta; with o it computes delta =
// rowsum(o dO) of its rows and writes it for the dK/dV kernel, which runs
// after it on the stream.
extern "C" int pdt_flash_bwd_dq_sm90(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, void* delta,
                                     const void* o, void* dq, int B, int Sq,
                                     int Sk, int H, int HK, int D,
                                     float scale, int causal, int window,
                                     int dtype, void* stream) {
  using namespace pdt_sm90;
  if (!takes(B, Sq, Sk, H, HK, D, dtype) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout) || !aligned16(dq) || !aligned16(o) ||
      !bind_device(q))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(B, Sq, Sk, H, HK, scale, causal, window);
  Maps m;
  if (!make_maps(&m, q, k, v, dout, s, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D == 64 ? launch_dq<bf16, 64>(m, dout, o, l, dl, dq, s, st)
                   : launch_dq<bf16, 128>(m, dout, o, l, dl, dq, s, st);
  return D == 64 ? launch_dq<f16, 64>(m, dout, o, l, dl, dq, s, st)
                 : launch_dq<f16, 128>(m, dout, o, l, dl, dq, s, st);
}

// splits: how many blocks share a KV head's query heads (1..H / HK); past 1,
// ws holds 2 * splits * (B * Sk * HK * D) f32 partial sums, added in order
// by a second kernel.
extern "C" int pdt_flash_bwd_dkv_sm90(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, void* ws,
                                      int splits, int B, int Sq, int Sk,
                                      int H, int HK, int D, float scale,
                                      int causal, int window, int dtype,
                                      void* stream) {
  using namespace pdt_sm90;
  if (!takes(B, Sq, Sk, H, HK, D, dtype) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout) || !aligned16(dk) || !aligned16(dv) ||
      splits < 1 || splits > H / HK ||
      (splits > 1 && (ws == nullptr || !aligned16(ws))) || !bind_device(q))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(B, Sq, Sk, H, HK, scale, causal, window);
  Maps m;
  if (!make_maps(&m, q, k, v, dout, s, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D == 64 ? launch_dkv<bf16, 64>(m, l, dl, dk, dv, w, splits, s, st)
                   : launch_dkv<bf16, 128>(m, l, dl, dk, dv, w, splits, s, st);
  return D == 64 ? launch_dkv<f16, 64>(m, l, dl, dk, dv, w, splits, s, st)
                 : launch_dkv<f16, 128>(m, l, dl, dk, dv, w, splits, s, st);
}
