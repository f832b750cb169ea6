// Flash attention forward for Hopper (sm_90a) on wgmma and TMA: o and the
// row log-sum-exp of dense GQA attention (end-aligned causal mask, optional
// sliding window), bf16 and f16, head dims 64 and 128.
//
// Replaces, at those dtypes and head dims: paddle_tpu/ops/flash_attention.py
// _fwd_kernel (:127, launched by _flash_fwd, pallas_call at :190). Every
// other input takes the mma.sync forward of flash_kernels.cuh
// (flash_attention.cu). Semantics as flash_sm90.cuh states them; o in the
// inputs' dtype, lse (B, H, Sq) f32 in natural-log units (what the backward
// reads), 0 and -1e30 for a row with no live key.
//
// What bounds it on this card: operations (4D flops a live (q row, key)
// pair against a few bytes a row; 0.07 ms of bf16 tensor-core time at the
// Llama-3-8B training slice). The design:
// - A block owns the q rows of one query head for its consumer
//   warpgroups, 64 rows each: three at D 64 (192 rows; 160 registers a
//   thread), two at D 128 (128 rows; 240), and one producer warp;
//   setmaxnreg moves registers from the producer (24) to the consumers.
//   Blocks in launch order take the q tiles with the most live keys (the
//   last, under a causal mask) first.
// - The block's Q tile arrives once by TMA into shared memory; K and V
//   tiles of BN = kFwdKeys keys arrive by TMA from 4-D maps over (D, H, S,
//   B), 128-byte swizzle, through a ring of NS stages (full: the bytes
//   landed; empty: every consumer warpgroup is done with the stage). S =
//   Q.K^T reads Q and K from shared memory, K-major; P is rounded once to
//   T into register A fragments and O += P.V reads V MN-major through the
//   descriptor's transpose bit: no tile is transposed or copied. Q is not
//   a register A operand: ptxas gave the registers of such an operand,
//   loop-invariant, to the softmax's values inside the key loop when the
//   key tile was as wide as the head dim (the next tile's S then read P
//   in place of Q; no warning), so no A operand lives across a loop here.
// - The element work is straight-line: exponentials in base 2 with
//   |scale| log2(e) folded into one FMA (a negative scale flips the sign
//   bits of Q in shared memory, exact, so the row max of the raw scores
//   is the row max of the scaled ones); the causal and window masks are
//   selects, computed only on tiles the band cuts; a row's max and sum go
//   across the 4 lanes that share it (the sum once, at the end); O is
//   rescaled by exp2(m_old - m_new); a row that has seen no live key yet
//   takes 0 as its reference so that no exp2 reads inf - inf.
// - Precision as the JAX kernel: S and the row sums in f32, P rounded to T
//   for P.V (p.astype(v.dtype)), f32 accumulation, o = acc / l rounded once.
//
// C interface: device pointers on the caller's current stream; the entry
// returns cudaErrorInvalidValue for an input it does not take (a dtype other
// than bf16 / f16, a head dim other than 64 / 128, a pointer not 16-byte
// aligned) or a tensor map the driver refuses, else cudaGetLastError()
// after its launch.

#include "flash_sm90.cuh"

namespace pdt_sm90 {

constexpr float kLn2 = 0.6931471805599453f;

// consumer warpgroups of 64 q rows a block: three at D 64 (160 registers
// a thread; a third warpgroup's element work overlaps the other two's
// products, faster than two on the H100), two at D 128 (240 registers:
// S, O and P do not fit 160)
template <int D>
__host__ __device__ constexpr int fwd_consumers() {
  return D == 64 ? 3 : 2;
}

// Keys a tile, at both head dims: against 64 on the H100, faster at D 64
// and at D 128 level or faster (tools/fwd_key_tile.py; PERF.md, Findings)
constexpr int kFwdKeys = 128;

// Shared memory: the ring's NS stages (K then V, BN keys x D each), Q (64
// rows x D a consumer warpgroup), then the mbarriers (full and empty a
// stage, Q's).
template <int D, int BN, int NS>
struct FwdLayout {
  static constexpr int kChunk = BN * 128;          // BN keys x 64 columns
  static constexpr int kTile = (D / 64) * kChunk;  // BN keys x D: K or V
  static constexpr int kStage = 2 * kTile;         // K, then V
  static constexpr int kQ = NS * kStage;           // Q: chunks of 64 rows
  static constexpr int kQWg = (D / 64) * kBox;     // a warpgroup's Q
  static constexpr int kBars = kQ + fwd_consumers<D>() * kQWg;
  static constexpr int kBytes = kBars + 8 * (2 * NS + 1) + 1024;
};

// ring stages: four, or as many as fit beside Q in 227 KB (three at D 128)
template <int D, int BN>
constexpr int fwd_stages() {
  using L = FwdLayout<D, BN, 0>;
  constexpr int n = (227 * 1024 - L::kBytes) / L::kStage;
  return n < 4 ? n : 4;
}

template <typename T, int D, int BN, int NS>
__global__ void __launch_bounds__(128 * (fwd_consumers<D>() + 1), 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   u16* __restrict__ o, float* __restrict__ lse, Shape s) {
  using L = FwdLayout<D, BN, NS>;
  constexpr int C = fwd_consumers<D>();
  constexpr int kRegs = C == 3 ? 160 : kConsumerRegs;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t full = base + L::kBars, empty = full + 8 * NS;
  const uint32_t qfull = empty + 8 * NS;
  // blocks in launch order take the q tiles from the last (the most live
  // keys under a causal mask) back to the first, all heads of a tile
  // together
  const int nbh = s.B * s.H;
  const int nqb = (s.Sq + C * kRows - 1) / (C * kRows);
  const int qb = nqb - 1 - int(blockIdx.x) / nbh;
  const int bh = blockIdx.x % nbh, b = bh / s.H, h = bh % s.H;
  const int kh = h / (s.H / s.HK);
  const int q0 = qb * C * kRows;
  int klo, khi;
  key_band(s, q0, min(q0 + C * kRows, s.Sq) - 1, klo, khi);
  const int kt0 = klo / BN;
  const int ntiles = khi >= klo ? khi / BN - kt0 + 1 : 0;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * C);  // a warp each
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == C) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * C) {
      // Q: 64 rows x 64 columns a box, rows past Sq zero
      mbar_expect_tx(qfull, C * L::kQWg);
      for (int w = 0; w < C; ++w)
        for (int c = 0; c < D / 64; ++c)
          tma_load(base + L::kQ + w * L::kQWg + c * kBox, &tq, qfull, 64 * c,
                   h, q0 + kRows * w, b);
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % NS;
        mbar_wait(empty + 8 * st, ((it / NS) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, L::kStage);
        const uint32_t kt = base + st * L::kStage;
        const int k0 = (kt0 + it) * BN;
        for (int c = 0; c < D / 64; ++c)
          for (int r = 0; r < BN / kRows; ++r) {
            const uint32_t off = c * L::kChunk + r * kBox;
            tma_load(kt + off, &tk, full + 8 * st, 64 * c, kh,
                     k0 + kRows * r, b);
            tma_load(kt + L::kTile + off, &tv, full + 8 * st, 64 * c, kh,
                     k0 + kRows * r, b);
          }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = q0 + kRows * wg;  // this warpgroup's rows [r0, r0 + 64)
    int wlo = 0, whi = -1;
    if (r0 < s.Sq) key_band(s, r0, min(r0 + kRows, s.Sq) - 1, wlo, whi);
    const float sl2 = fabsf(s.scale) * kLog2e;
    const size_t rs = size_t(s.H) * D;  // elements between rows
    const int row0 = r0 + 16 * warp + g;  // this thread's rows: +0, +8
    const size_t roff = ((size_t(b) * s.Sq + row0) * s.H + h) * D;
    const uint32_t qs = base + L::kQ + wg * L::kQWg;  // this warpgroup's Q
    mbar_wait(qfull, 0);
    if (s.scale < 0.f) {
      // -Q, exact: flip every sign bit of this warpgroup's Q, then make
      // the writes visible to wgmma's (async proxy) reads
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
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % NS;
      const int k0 = (kt0 + it) * BN;
      mbar_wait(full + 8 * st, (it / NS) & 1);
      if (k0 <= whi && k0 + BN - 1 >= wlo) {
        const uint32_t kt = base + st * L::kStage;
        const uint32_t vt = kt + L::kTile;
        // S = Q K^T: 64 rows x BN keys
        float sc[BN / 2];
        wg_fence();
        wg_ss<T, BN, 0, 0>(sc, desc_kmajor(qs, 0),
                           desc_kmajor(kt, 0, L::kChunk));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wg_ss<T, BN, 0>(sc, desc_kmajor(qs, kk),
                          desc_kmajor(kt, kk, L::kChunk));
        wg_commit();
        wg_wait_all();
        reg_fence(sc);
        const auto live = [&](int i) {
          return is_live(s, row0 + 8 * ((i >> 1) & 1),
                         k0 + 2 * t + 8 * (i >> 2) + (i & 1));
        };
        if (tile_full(s, r0, r0 + kRows - 1, k0, k0 + BN - 1))
          online_softmax<false, BN, D>(sc, acc, m, l, sl2, live);
        else
          online_softmax<true, BN, D>(sc, acc, m, l, sl2, live);
        // O += P (rounded to T) V, V read MN-major
        uint32_t pa[BN / 16][4];
        to_a<T, BN / 16>(pa, sc);
        reg_fence(acc);
        reg_fence(pa);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wg_rs<T, D, 1>(acc, pa[kk], desc_mnmajor(vt, kk, L::kChunk));
        wg_commit();
        wg_wait_all();
        reg_fence(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
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
        lse[size_t(bh) * s.Sq + row] =
            any ? (m[r] + log2f(l[r])) * kLn2 : kNegInf;
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------
template <typename T, int D>
int launch_fwd(const CUtensorMap& tq, const CUtensorMap& tk,
               const CUtensorMap& tv, void* o, float* lse, const Shape& s,
               cudaStream_t st) {
  constexpr int BN = kFwdKeys;
  constexpr int NS = fwd_stages<D, BN>();
  constexpr int bytes = FwdLayout<D, BN, NS>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90<T, D, BN, NS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int C = fwd_consumers<D>();
  const int nqb = (s.Sq + C * kRows - 1) / (C * kRows);
  flash_fwd_sm90<T, D, BN, NS>
      <<<nqb * s.B * s.H, 128 * (C + 1), bytes, st>>>(
      tq, tk, tv, static_cast<u16*>(o), lse, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pdt_sm90

// dtype: 1 = bfloat16, 2 = float16 (q, k, v and o share it); window <= 0:
// no window (a window needs causal). Head dims 64 and 128.
extern "C" int pdt_flash_fwd_sm90(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int Sq, int Sk,
                                  int H, int HK, int D, float scale,
                                  int causal, int window, int dtype,
                                  void* stream) {
  using namespace pdt_sm90;
  if (!takes(B, Sq, Sk, H, HK, D, dtype) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o) || !bind_device(q))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(B, Sq, Sk, H, HK, scale, causal, window);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, H, D, dtype) ||
      !make_map(&tk, k, B, Sk, HK, D, dtype) ||
      !make_map(&tv, v, B, Sk, HK, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D == 64 ? launch_fwd<bf16, 64>(tq, tk, tv, o, l, s, st)
                   : launch_fwd<bf16, 128>(tq, tk, tv, o, l, s, st);
  return D == 64 ? launch_fwd<f16, 64>(tq, tk, tv, o, l, s, st)
                 : launch_fwd<f16, 128>(tq, tk, tv, o, l, s, st);
}
