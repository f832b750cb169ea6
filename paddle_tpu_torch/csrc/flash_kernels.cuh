// Flash attention kernels for Hopper (sm_90a), shared by flash_attention.cu
// (dense GQA attention with an end-aligned causal mask and an optional
// sliding window) and flash_varlen.cu (the same with a segment-id mask:
// packed sequences). Each source instantiates its own kernels from this
// header and exports its own C entries.
//
// Layout: the JAX package's public one, (B, S, H, D), read in place: q, dO
// and o are (B, Sq, H, D), k, v, dK and dV (B, Sk, HK, D), all contiguous;
// lse and delta are (B, H, Sq) f32; segment ids (B, Sq) and (B, Sk) int32.
// Query head h reads KV head h / (H / HK) (the JAX grid's `b // group` on
// the (B*H) axis), so K and V are never repeated in memory. No transposes
// around the kernels.
//
// Semantics, as the JAX kernels: s = (q . k) * scale in f32; q row i (of Sq)
// sees key j (of Sk) iff j <= i + Sk - Sq when causal and, with a window w,
// j > i + Sk - Sq - w; with segments, also iff seg_q[i] == seg_k[j] and
// seg_q[i] >= 0 (-1 marks padding). A row with no live key outputs 0, lse
// -1e30 and zero gradient; masked entries give p = 0 exactly, never
// exp(-1e30 + 1e30). Any Sq, Sk: tails of the tiles are masked and
// zero-filled.
//
// What bounds it on this card: operations. At the training shape (S = 2048,
// D = 64 or 128) a (q row, key) pair costs 4D flops forward and 10D to 14D
// backward against a few bytes per row, far past the card's ~295 flops per
// byte. So the bf16 and f16 paths run on tensor cores: mma.sync.m16n8k16
// with bf16 or f16 operands and f32 accumulation, 64-row q tiles (16 rows a
// warp) and 64-key tiles staged in shared memory, tiles outside the
// causal/window band skipped (_tile_live). The online softmax lives in the
// accumulator registers; P feeds the PV product straight from them.
// Precision follows the JAX kernels: P is rounded to the input type for P.V
// (the JAX p.astype(v.dtype)), dS likewise for dS.K (ds.astype(k.dtype));
// the dK/dV kernel keeps P and dS at ~16 (bf16) or ~22 (f16) significant
// bits by splitting each into a high and a low part (two mma), where JAX
// multiplies them in f32. Exponentials use __expf (ex2.approx): a few ulp of
// f32, far inside the rounding of P.
//
// Head dims: any D up to 256 (the reference's own limit). The kernels are
// templated on the tile width DP (16, 32, 48, 64, 80, 96, 112, 128, 160,
// 192, 256) and run a head dim at the smallest width that holds it, D
// itself a template constant or given at run time (which instances exist:
// the launchers below). Columns D..DP-1 are zero in shared memory (the loads
// fill them with zeros, which change neither q.k nor the first D columns
// of P.V), and the stores of o, dQ, dK and dV skip them. So D = 72
// (DiT-XL/2) runs at 80 and D = 136 at 160. A D that is not a multiple of
// 8 (its rows off the 16-byte chunks) is staged element by element, and an
// odd D stores its last column alone.
// Widths past 128 hold one block a SM (255 registers a thread); at 256 the
// accumulators (2 x 128 f32 a thread in dK/dV) spill to local memory.

// Segments (the varlen kernels): the segment test joins the per-element
// live predicate, and a (q tile, key tile) pair is skipped when the tiles'
// ranges [min, max] of non-padding segment ids do not meet. The ranges are
// computed in the tile loop by every warp from the ids in device memory
// (one or two loads a lane and a warp reduction), so the skip is
// block-uniform, needs no pre-pass and no host read, and is right for any
// ids, sorted or not. This is the one place where the design departs from
// the TPU kernel, which visits every tile of the causal band.
//
// dK/dV is deterministic: one block owns a 64-key tile of one KV head and
// walks the G query heads of its group and their q tiles in a fixed order,
// accumulating in registers. No float atomics anywhere.
//
// f32 inputs take a CUDA-core path (one warp per row, warp-shuffle dots),
// exact f32 as the JAX kernels' f32 instance; it exists for the f32 models
// of the tests and the tiny configs, not for speed.
//
// Simple first: tiles are staged row-major and synchronously (no cp.async /
// TMA ring); A and B fragments load from them with plain 32-bit loads, and
// the B operands that need the transposed tile (V for P.V, K for dS.K, dO
// and Q for dK/dV) with ldmatrix.trans, so no tile is ever transposed in
// shared memory; the products use mma.sync, not wgmma. Those are the next
// steps (ROADMAP, "making the ported kernels fast").
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace pdt_flash {

using bf16 = __nv_bfloat16;
using f16 = __half;
using u16 = uint16_t;  // a bf16 or f16 element in memory

// the JAX kernel's NEG_INF: the lse of a row that attends no key
constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // 4 warps
constexpr int kPad = 8;        // 16-bit elements of row padding in smem

struct Shape {
  int B, Sq, Sk, H, HK;
  int D;              // head dim; the kernels' tile width DP >= D
  float scale;
  int causal;
  int window;         // <= 0: no window
  const int* seg_q;   // (B, Sq) segment ids; the varlen kernels only
  const int* seg_k;   // (B, Sk)
};

__device__ __forceinline__ bool is_live(const Shape& s, int i, int j) {
  if (i >= s.Sq || j >= s.Sk) return false;
  if (!s.causal) return true;
  const int p = i + s.Sk - s.Sq;
  return j <= p && (s.window <= 0 || j > p - s.window);
}

// every (q row, key) of rows [i0, i1] x keys [j0, j1] passes the position
// mask: the tile needs no per-element mask (segments aside)
__device__ __forceinline__ bool tile_full(const Shape& s, int i0, int i1,
                                          int j0, int j1) {
  if (i1 >= s.Sq || j1 >= s.Sk) return false;
  if (!s.causal) return true;
  const int off = s.Sk - s.Sq;
  return j1 <= i0 + off && (s.window <= 0 || j0 > i1 + off - s.window);
}

// live keys of q rows [i0, i1]: [lo, hi] (empty when hi < lo)
__device__ __forceinline__ void key_band(const Shape& s, int i0, int i1,
                                         int& lo, int& hi) {
  const int off = s.Sk - s.Sq;
  lo = 0;
  hi = s.Sk - 1;
  if (s.causal) {
    hi = min(hi, i1 + off);
    if (s.window > 0) lo = max(0, i0 + off - s.window + 1);
  }
}

// q rows that see some key of [j0, j1]: [lo, hi]
__device__ __forceinline__ void query_band(const Shape& s, int j0, int j1,
                                           int& lo, int& hi) {
  const int off = s.Sk - s.Sq;
  lo = 0;
  hi = s.Sq - 1;
  if (s.causal) {
    lo = max(0, j0 - off);
    if (s.window > 0) hi = min(hi, j1 - off + s.window - 1);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// segment ranges
// ---------------------------------------------------------------------------
// [lo, hi] of the non-padding ids of rows [r0, r0 + R) (rows at or past S
// ignored); hi = -1 when there is none. `one` says every row is in range,
// none is padding and all share one id: the tile needs no segment mask.
// Every lane of the warp returns the same values.
struct SegRange {
  int lo, hi;
  bool one;
};

template <int R>
__device__ __forceinline__ SegRange seg_range(const int* seg, int r0, int S,
                                              int lane) {
  int lo = INT_MAX, hi = -1;
  bool bad = false;  // a padding row or a row past S
#pragma unroll
  for (int r = lane; r < R; r += 32) {
    const int i = r0 + r;
    const int x = i < S ? seg[i] : -1;
    if (x >= 0) {
      lo = min(lo, x);
      hi = max(hi, x);
    } else {
      bad = true;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  bad = __any_sync(0xffffffffu, bad);
  return {lo, hi, !bad && lo == hi};
}

__device__ __forceinline__ bool ranges_meet(const SegRange& a,
                                            const SegRange& b) {
  return a.hi >= 0 && b.hi >= 0 && a.lo <= b.hi && b.lo <= a.hi;
}

__device__ __forceinline__ bool same_segment(const SegRange& a,
                                             const SegRange& b) {
  return a.one && b.one && a.lo == b.lo;
}

// ---------------------------------------------------------------------------
// tensor-core building blocks, by input type
// ---------------------------------------------------------------------------
template <typename T>
struct Tc;

template <>
struct Tc<bf16> {
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  }
};

template <>
struct Tc<f16> {
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<__half2*>(&u));
  }
};

// x ~= hi + lo, both pairs of T: ~16 (bf16) or ~22 (f16) significant bits
// of x in two mma inputs
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = Tc<T>::pack(x0, x1);
  const float2 hf = Tc<T>::unpack(hi);
  lo = Tc<T>::pack(x0 - hf.x, x1 - hf.y);
}

// Fragments of mma.m16n8k16 (g = lane / 4, t = lane % 4). A (16 x 16,
// row-major at s[m * ld + k]): {row g, cols 2t..2t+1}, {row g+8, ...},
// {row g, cols 2t+8..}, {row g+8, cols 2t+8..}.
__device__ __forceinline__ void load_a(uint32_t* a, const u16* s, int ld,
                                       int m0, int k0, int g, int t) {
  const u16* p = s + (m0 + g) * ld + k0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// B (16 x 8, element (k, n) at s[n * ld + k]): {k 2t..2t+1, n g},
// {k 2t+8.., n g}
__device__ __forceinline__ void load_b(uint32_t* b, const u16* s, int ld,
                                       int n0, int k0, int g, int t) {
  const u16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B (16 x 8) where element (k, n) is at s[k * ld + n] (a row-major tile
// whose rows are the k axis): ldmatrix.trans of the two 8 x 8 blocks at
// rows k0.. and k0+8.., columns n0..; lanes 0-15 give the row addresses.
__device__ __forceinline__ void load_b_trans(uint32_t* b, const u16* s,
                                             int ld, int n0, int k0,
                                             int lane) {
  const u16* p = s + (k0 + (lane & 15)) * ld + n0;
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(addr));
}

// The A fragment of the 16 x 16 block kk of a 16-row accumulator tile
// c[n][4] (C layout: c[n][0..1] row g cols 8n+2t.., c[n][2..3] row g+8).
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*c)[4],
                                         int kk) {
  a[0] = Tc<T>::pack(c[2 * kk][0], c[2 * kk][1]);
  a[1] = Tc<T>::pack(c[2 * kk][2], c[2 * kk][3]);
  a[2] = Tc<T>::pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = Tc<T>::pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

template <typename T>
__device__ __forceinline__ void acc_to_a_split(uint32_t* hi, uint32_t* lo,
                                               const float (*c)[4], int kk) {
  split2<T>(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
  split2<T>(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
  split2<T>(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
  split2<T>(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
}

// rows [r0, r0 + R) of one head into shared memory [R][DP + kPad]; rows at
// or past S, and columns d..DP-1, are zero. `base` points at (row 0, this
// head, 0); rows are `stride` elements apart. A d that is not a multiple of
// 8 leaves the rows off 16-byte boundaries: those load element by element.
template <int DP, int R>
__device__ __forceinline__ void stage_rows(u16* dst, const u16* base, int r0,
                                           int S, size_t stride, int d) {
  constexpr int C = DP / 8;  // 16-byte chunks per (padded) row
  for (int c = threadIdx.x; c < R * C; c += kThreads) {
    const int r = c / C, col = (c % C) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < S && col < d) {
      const u16* src = base + size_t(r0 + r) * stride + col;
      if (d % 8 == 0) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t lo = col + 2 * i < d ? src[2 * i] : 0u;
          const uint32_t hi = col + 2 * i + 1 < d ? src[2 * i + 1] : 0u;
          w[i] = lo | hi << 16;
        }
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * (DP + kPad) + col) = v;
  }
}

// columns c and c + 1 of a row of d elements (c < d, c even): one 32-bit
// store, or for an odd d (rows then start off 4-byte boundaries) one 16-bit
// store each, the last column alone
template <typename T>
__device__ __forceinline__ void store_pair(u16* row, int c, int d, float x0,
                                           float x1) {
  const uint32_t v = Tc<T>::pack(x0, x1);
  if (d % 2 == 0) {
    *reinterpret_cast<uint32_t*>(row + c) = v;
  } else {
    row[c] = static_cast<u16>(v & 0xffffu);
    if (c + 1 < d) row[c + 1] = static_cast<u16>(v >> 16);
  }
}

// segment ids of rows [r0, r0 + R) into shared memory (-1 past S)
template <int R>
__device__ __forceinline__ void stage_seg(int* dst, const int* seg, int r0,
                                          int S) {
  for (int r = threadIdx.x; r < R; r += kThreads)
    dst[r] = r0 + r < S ? seg[r0 + r] : -1;
}

// ---------------------------------------------------------------------------
// tensor-core forward: one block per (64 q rows, query head)
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;     // q rows per block (fwd, dQ)
constexpr int kBK = 64;     // keys per tile (fwd, dQ) and per block (dK/dV)
constexpr int kBQdkv = 32;  // q rows per tile of the dK/dV walk

template <int DP, bool SEG>
constexpr size_t fwd_smem() {
  return sizeof(u16) * (kBQ + 2 * kBK) * (DP + kPad) +
         (SEG ? sizeof(int) * kBK : 0);
}

// Blocks an SM keeps resident, which caps the registers a thread: the
// forward's 52 KB of shared memory (D = 128) allows 4 a SM, the dQ
// kernel's 70 KB 3; a register count past 128 / 168 drops one. Measured
// on the H100 at D = 128, each pair in one run: dQ 0.75 ms at 172
// registers against 0.63 at 168, the forward 0.58 against 0.51 at 128,
// the segment forward 0.53 uncapped against 0.47 capped (a few spills).
constexpr int kFwdBlocksPerSm = 4;
constexpr int kDqBlocksPerSm = 3;

template <typename T, int DP, int DK, bool SEG>
__global__ void __launch_bounds__(kThreads, DP <= 128 ? kFwdBlocksPerSm : 1)
flash_fwd_tc(const u16* __restrict__ q, const u16* __restrict__ k,
             const u16* __restrict__ v, u16* __restrict__ o,
             float* __restrict__ lse, Shape s) {
  constexpr int LD = DP + kPad, NK = kBK / 8, ND = DP / 8;
  const int D = DK ? DK : s.D;
  extern __shared__ __align__(16) unsigned char smem[];
  u16* Qs = reinterpret_cast<u16*>(smem);  // [kBQ][LD]
  u16* Ks = Qs + kBQ * LD;                 // [kBK][LD]
  u16* Vs = Ks + kBK * LD;                 // [kBK][LD]
  int* Sk = reinterpret_cast<int*>(Vs + kBK * LD);  // [kBK], SEG only
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int kh = h / (s.H / s.HK);
  const int q0 = blockIdx.x * kBQ;
  const size_t qs = size_t(s.H) * D, ks = size_t(s.HK) * D;
  const u16* qb = q + (size_t(b) * s.Sq * s.H + h) * D;
  const u16* kb = k + (size_t(b) * s.Sk * s.HK + kh) * D;
  const u16* vb = v + (size_t(b) * s.Sk * s.HK + kh) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;

  stage_rows<DP, kBQ>(Qs, qb, q0, s.Sq, qs, D);
  int klo, khi;
  key_band(s, q0, min(q0 + kBQ, s.Sq) - 1, klo, khi);
  const int* sgk = SEG ? s.seg_k + size_t(b) * s.Sk : nullptr;
  SegRange qr{0, 0, true};
  int sq_r[2] = {0, 0};
  if (SEG) {
    const int* sgq = s.seg_q + size_t(b) * s.Sq;
    qr = seg_range<kBQ>(sgq, q0, s.Sq, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + g + 8 * r;
      sq_r[r] = row < s.Sq ? sgq[row] : -1;
    }
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = klo / kBK; khi >= klo && kt <= khi / kBK; ++kt) {
    const int k0 = kt * kBK;
    bool one = true;
    if (SEG) {
      // block-uniform: every warp reduces the same ids
      const SegRange kr = seg_range<kBK>(sgk, k0, s.Sk, lane);
      if (!ranges_meet(qr, kr)) continue;
      one = same_segment(qr, kr);
    }
    __syncthreads();  // the previous tile's readers are done
    stage_rows<DP, kBK>(Ks, kb, k0, s.Sk, ks, D);
    stage_rows<DP, kBK>(Vs, vb, k0, s.Sk, ks, D);
    if (SEG) stage_seg<kBK>(Sk, sgk, k0, s.Sk);
    __syncthreads();

    float sc[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      load_a(a, Qs, LD, r0, 16 * kk, g, t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t bb[2];
        load_b(bb, Ks, LD, 8 * n, 16 * kk, g, t);
        Tc<T>::mma(sc[n], a, bb);
      }
    }
    // scale, mask, row max over the tile (4 lanes share a row)
    const bool full =
        one && tile_full(s, q0, q0 + kBQ - 1, k0, k0 + kBK - 1);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + g + 8 * (e >> 1);
        const int c = 8 * n + 2 * t + (e & 1);
        const bool live =
            full || (is_live(s, row, k0 + c) &&
                     (!SEG || (sq_r[e >> 1] >= 0 && sq_r[e >> 1] == Sk[c])));
        if (live) {
          sc[n][e] *= s.scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
        } else {
          sc[n][e] = -INFINITY;
        }
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // no live key yet: nothing to rescale (l and acc are 0)
      alpha[r] = mx[r] == -INFINITY ? 1.f : __expf(m[r] - mx[r]);
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p =
            sc[n][e] == -INFINITY ? 0.f : __expf(sc[n][e] - mx[r]);
        sc[n][e] = p;
        rs[r] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // acc += P (rounded to T) . V
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a<T>(a, sc, kk);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bb[2];
        load_b_trans(bb, Vs, LD, 8 * n, 16 * kk, lane);
        Tc<T>::mma(acc[n], a, bb);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= s.Sq) continue;
    const bool any = l[r] > 0.f;
    u16* orow = o + ((size_t(b) * s.Sq + row) * s.H + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (DP != D && 8 * n + 2 * t >= D) continue;
      const float x0 = any ? acc[n][2 * r] / l[r] : 0.f;
      const float x1 = any ? acc[n][2 * r + 1] / l[r] : 0.f;
      store_pair<T>(orow, 8 * n + 2 * t, D, x0, x1);
    }
    if (t == 0) lse[size_t(bh) * s.Sq + row] = any ? m[r] + logf(l[r])
                                                   : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// tensor-core dQ: one block per (64 q rows, query head), walking the live
// key tiles
// ---------------------------------------------------------------------------
template <int DP, bool SEG>
constexpr size_t dq_smem() {
  return sizeof(u16) * (2 * kBQ + 2 * kBK) * (DP + kPad) +
         (SEG ? sizeof(int) * kBK : 0);
}

template <typename T, int DP, int DK, bool SEG>
__global__ void __launch_bounds__(kThreads, DP <= 128 ? kDqBlocksPerSm : 1)
flash_dq_tc(const u16* __restrict__ q, const u16* __restrict__ k,
            const u16* __restrict__ v, const u16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            u16* __restrict__ dq, Shape s) {
  constexpr int LD = DP + kPad, NK = kBK / 8, ND = DP / 8;
  const int D = DK ? DK : s.D;
  extern __shared__ __align__(16) unsigned char smem[];
  u16* Qs = reinterpret_cast<u16*>(smem);  // [kBQ][LD]
  u16* dOs = Qs + kBQ * LD;                // [kBQ][LD]
  u16* Ks = dOs + kBQ * LD;                // [kBK][LD]
  u16* Vs = Ks + kBK * LD;                 // [kBK][LD]
  int* Sk = reinterpret_cast<int*>(Vs + kBK * LD);  // [kBK], SEG only
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int kh = h / (s.H / s.HK);
  const int q0 = blockIdx.x * kBQ;
  const size_t qs = size_t(s.H) * D, ks = size_t(s.HK) * D;
  const size_t qoff = (size_t(b) * s.Sq * s.H + h) * D;
  const size_t koff = (size_t(b) * s.Sk * s.HK + kh) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;

  stage_rows<DP, kBQ>(Qs, q + qoff, q0, s.Sq, qs, D);
  stage_rows<DP, kBQ>(dOs, dout + qoff, q0, s.Sq, qs, D);
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    lr[r] = row < s.Sq ? lse[size_t(bh) * s.Sq + row] : 0.f;
    dr[r] = row < s.Sq ? delta[size_t(bh) * s.Sq + row] : 0.f;
  }
  int klo, khi;
  key_band(s, q0, min(q0 + kBQ, s.Sq) - 1, klo, khi);
  const int* sgk = SEG ? s.seg_k + size_t(b) * s.Sk : nullptr;
  SegRange qr{0, 0, true};
  int sq_r[2] = {0, 0};
  if (SEG) {
    const int* sgq = s.seg_q + size_t(b) * s.Sq;
    qr = seg_range<kBQ>(sgq, q0, s.Sq, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + g + 8 * r;
      sq_r[r] = row < s.Sq ? sgq[row] : -1;
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = klo / kBK; khi >= klo && kt <= khi / kBK; ++kt) {
    const int k0 = kt * kBK;
    bool one = true;
    if (SEG) {
      const SegRange kr = seg_range<kBK>(sgk, k0, s.Sk, lane);
      if (!ranges_meet(qr, kr)) continue;
      one = same_segment(qr, kr);
    }
    __syncthreads();
    stage_rows<DP, kBK>(Ks, k + koff, k0, s.Sk, ks, D);
    stage_rows<DP, kBK>(Vs, v + koff, k0, s.Sk, ks, D);
    if (SEG) stage_seg<kBK>(Sk, sgk, k0, s.Sk);
    __syncthreads();

    float sc[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4], ad[4];
      load_a(a, Qs, LD, r0, 16 * kk, g, t);
      load_a(ad, dOs, LD, r0, 16 * kk, g, t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t bb[2];
        load_b(bb, Ks, LD, 8 * n, 16 * kk, g, t);
        Tc<T>::mma(sc[n], a, bb);
        load_b(bb, Vs, LD, 8 * n, 16 * kk, g, t);
        Tc<T>::mma(dp[n], ad, bb);
      }
    }
    // dS = P * (dP - delta) * scale, P = exp(s - lse), 0 where masked
    const bool full =
        one && tile_full(s, q0, q0 + kBQ - 1, k0, k0 + kBK - 1);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int row = q0 + r0 + g + 8 * r;
        const int c = 8 * n + 2 * t + (e & 1);
        float ds = 0.f;
        if (full || (is_live(s, row, k0 + c) &&
                     (!SEG || (sq_r[r] >= 0 && sq_r[r] == Sk[c])))) {
          const float p = __expf(sc[n][e] * s.scale - lr[r]);
          ds = p * (dp[n][e] - dr[r]) * s.scale;
        }
        sc[n][e] = ds;
      }
    // dQ += dS (rounded to T) . K
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a<T>(a, sc, kk);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bb[2];
        load_b_trans(bb, Ks, LD, 8 * n, 16 * kk, lane);
        Tc<T>::mma(acc[n], a, bb);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= s.Sq) continue;
    u16* drow = dq + qoff + size_t(row) * qs;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (DP != D && 8 * n + 2 * t >= D) continue;
      store_pair<T>(drow, 8 * n + 2 * t, D, acc[n][2 * r],
                    acc[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core dK/dV: one block per (64 keys, KV head); each warp owns 16
// keys and walks the group's query heads and their live q tiles in order
// ---------------------------------------------------------------------------
template <int DP, bool SEG>
constexpr size_t dkv_smem() {
  return sizeof(u16) * (2 * kBK + 2 * kBQdkv) * (DP + kPad) +
         sizeof(float) * 2 * kBQdkv + (SEG ? sizeof(int) * kBQdkv : 0);
}

template <typename T, int DP, int DK, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_dkv_tc(const u16* __restrict__ q, const u16* __restrict__ k,
             const u16* __restrict__ v, const u16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             u16* __restrict__ dk, u16* __restrict__ dv, Shape s) {
  constexpr int LD = DP + kPad, NQ = kBQdkv / 8, ND = DP / 8;
  const int D = DK ? DK : s.D;
  extern __shared__ __align__(16) unsigned char smem[];
  u16* Ks = reinterpret_cast<u16*>(smem);  // [kBK][LD]
  u16* Vs = Ks + kBK * LD;                 // [kBK][LD]
  u16* Qs = Vs + kBK * LD;                 // [kBQdkv][LD]
  u16* dOs = Qs + kBQdkv * LD;             // [kBQdkv][LD]
  float* ls = reinterpret_cast<float*>(dOs + kBQdkv * LD);  // [kBQdkv]
  float* dl = ls + kBQdkv;                                  // [kBQdkv]
  int* Sq = reinterpret_cast<int*>(dl + kBQdkv);  // [kBQdkv], SEG only
  const int bhk = blockIdx.y, b = bhk / s.HK, kh = bhk % s.HK;
  const int G = s.H / s.HK;
  const int k0 = blockIdx.x * kBK;
  const size_t qs = size_t(s.H) * D, ks = size_t(s.HK) * D;
  const size_t koff = (size_t(b) * s.Sk * s.HK + kh) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;

  stage_rows<DP, kBK>(Ks, k + koff, k0, s.Sk, ks, D);
  stage_rows<DP, kBK>(Vs, v + koff, k0, s.Sk, ks, D);
  int qlo, qhi;
  query_band(s, k0, min(k0 + kBK, s.Sk) - 1, qlo, qhi);
  const int* sgq = SEG ? s.seg_q + size_t(b) * s.Sq : nullptr;
  SegRange kr{0, 0, true};
  int sk_r[2] = {0, 0};
  if (SEG) {
    const int* sgk = s.seg_k + size_t(b) * s.Sk;
    kr = seg_range<kBK>(sgk, k0, s.Sk, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + r0 + g + 8 * r;
      sk_r[r] = key < s.Sk ? sgk[key] : -1;
    }
  }

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const size_t qoff = (size_t(b) * s.Sq * s.H + h) * D;
    const float* lh = lse + (size_t(b) * s.H + h) * s.Sq;
    const float* dh = delta + (size_t(b) * s.H + h) * s.Sq;
    for (int qt = qlo / kBQdkv; qhi >= qlo && qt <= qhi / kBQdkv; ++qt) {
      const int q0 = qt * kBQdkv;
      bool one = true;
      if (SEG) {
        const SegRange qr = seg_range<kBQdkv>(sgq, q0, s.Sq, lane);
        if (!ranges_meet(qr, kr)) continue;
        one = same_segment(qr, kr);
      }
      __syncthreads();
      stage_rows<DP, kBQdkv>(Qs, q + qoff, q0, s.Sq, qs, D);
      stage_rows<DP, kBQdkv>(dOs, dout + qoff, q0, s.Sq, qs, D);
      for (int i = threadIdx.x; i < kBQdkv; i += kThreads) {
        const bool in = q0 + i < s.Sq;
        ls[i] = in ? lh[q0 + i] : 0.f;
        dl[i] = in ? dh[q0 + i] : 0.f;
      }
      if (SEG) stage_seg<kBQdkv>(Sq, sgq, q0, s.Sq);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x kBQdkv q rows per warp
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4], av[4];
        load_a(a, Ks, LD, r0, 16 * kk, g, t);
        load_a(av, Vs, LD, r0, 16 * kk, g, t);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          uint32_t bb[2];
          load_b(bb, Qs, LD, 8 * n, 16 * kk, g, t);
          Tc<T>::mma(st[n], a, bb);
          load_b(bb, dOs, LD, 8 * n, 16 * kk, g, t);
          Tc<T>::mma(dpt[n], av, bb);
        }
      }
      const bool full =
          one && tile_full(s, q0, q0 + kBQdkv - 1, k0, k0 + kBK - 1);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + r0 + g + 8 * (e >> 1);
          const int qi = 8 * n + 2 * t + (e & 1);
          float p = 0.f, ds = 0.f;
          if (full || (is_live(s, q0 + qi, key) &&
                       (!SEG || (Sq[qi] >= 0 && Sq[qi] == sk_r[e >> 1])))) {
            p = __expf(st[n][e] * s.scale - ls[qi]);
            ds = p * (dpt[n][e] - dl[qi]) * s.scale;
          }
          st[n][e] = p;
          dpt[n][e] = ds;
        }
      // dV += P^T dO and dK += dS^T Q, P and dS as high + low parts
#pragma unroll
      for (int kk = 0; kk < kBQdkv / 16; ++kk) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        acc_to_a_split<T>(ph, pl, st, kk);
        acc_to_a_split<T>(sh, sl, dpt, kk);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bb[2];
          load_b_trans(bb, dOs, LD, 8 * n, 16 * kk, lane);
          Tc<T>::mma(dva[n], ph, bb);
          Tc<T>::mma(dva[n], pl, bb);
          load_b_trans(bb, Qs, LD, 8 * n, 16 * kk, lane);
          Tc<T>::mma(dka[n], sh, bb);
          Tc<T>::mma(dka[n], sl, bb);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + g + 8 * r;
    if (key >= s.Sk) continue;
    u16* krow = dk + koff + size_t(key) * ks;
    u16* vrow = dv + koff + size_t(key) * ks;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (DP != D && 8 * n + 2 * t >= D) continue;
      store_pair<T>(krow, 8 * n + 2 * t, D, dka[n][2 * r],
                    dka[n][2 * r + 1]);
      store_pair<T>(vrow, 8 * n + 2 * t, D, dva[n][2 * r],
                    dva[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, one warp per row; lane holds elements lane + 32 e
// (lanes past D hold none: their loads read 0, they store nothing, and they
// add 0 to every warp sum). With segments a row of id -1 sees no key, and a
// key of another id is passed over (warp-uniform: the warp shares the row).
// Products and sums are explicit fma / round-to-nearest intrinsics, so
// nvcc contracts nothing on its own and the segment and plain instances
// round alike, bit for bit.
// ---------------------------------------------------------------------------
constexpr int kRowsF32 = kThreads / 32;

template <int DP, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, Shape s) {
  constexpr int E = (DP + 31) / 32;
  const int lane = threadIdx.x & 31, D = s.D;
  auto in = [lane, D](int e) { return lane + 32 * e < D; };
  const int i = blockIdx.x * kRowsF32 + (threadIdx.x >> 5);
  if (i >= s.Sq) return;  // warp-uniform
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int kh = h / (s.H / s.HK);
  const float* qr = q + ((size_t(b) * s.Sq + i) * s.H + h) * D;
  const float* kb = k + (size_t(b) * s.Sk * s.HK + kh) * D;
  const float* vb = v + (size_t(b) * s.Sk * s.HK + kh) * D;
  const size_t ks = size_t(s.HK) * D;
  float qv[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qv[e] = (in(e) ? qr[lane + 32 * e] : 0.f);
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  int lo, hi;
  key_band(s, i, i, lo, hi);
  const int* sgk = SEG ? s.seg_k + size_t(b) * s.Sk : nullptr;
  const int sg = SEG ? s.seg_q[size_t(b) * s.Sq + i] : 0;
  if (SEG && sg < 0) hi = lo - 1;
  for (int j = lo; j <= hi; ++j) {
    if (SEG && sgk[j] != sg) continue;
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e)
      dot = __fmaf_rn(qv[e], in(e) ? kb[j * ks + lane + 32 * e] : 0.f, dot);
    const float x = __fmul_rn(warp_sum(dot), s.scale);
    const float mn = fmaxf(m, x);
    const float alpha = expf(m - mn), p = expf(x - mn);
    l = __fmaf_rn(l, alpha, p);
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc[e] = __fmaf_rn(p, in(e) ? vb[j * ks + lane + 32 * e] : 0.f,
                         __fmul_rn(acc[e], alpha));
    m = mn;
  }
  float* orow = o + ((size_t(b) * s.Sq + i) * s.H + h) * D;
  const bool any = l > 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (in(e)) orow[lane + 32 * e] = any ? acc[e] / l : 0.f;
  if (lane == 0) lse[size_t(bh) * s.Sq + i] = any ? m + logf(l) : kNegInf;
}

template <int DP, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, Shape s) {
  constexpr int E = (DP + 31) / 32;
  const int lane = threadIdx.x & 31, D = s.D;
  auto in = [lane, D](int e) { return lane + 32 * e < D; };
  const int i = blockIdx.x * kRowsF32 + (threadIdx.x >> 5);
  if (i >= s.Sq) return;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int kh = h / (s.H / s.HK);
  const size_t roff = ((size_t(b) * s.Sq + i) * s.H + h) * D;
  const float* kb = k + (size_t(b) * s.Sk * s.HK + kh) * D;
  const float* vb = v + (size_t(b) * s.Sk * s.HK + kh) * D;
  const size_t ks = size_t(s.HK) * D;
  const float lr = lse[size_t(bh) * s.Sq + i];
  const float dr = delta[size_t(bh) * s.Sq + i];
  float qv[E], dov[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qv[e] = (in(e) ? q[roff + lane + 32 * e] : 0.f);
    dov[e] = (in(e) ? dout[roff + lane + 32 * e] : 0.f);
    acc[e] = 0.f;
  }
  int lo, hi;
  key_band(s, i, i, lo, hi);
  const int* sgk = SEG ? s.seg_k + size_t(b) * s.Sk : nullptr;
  const int sg = SEG ? s.seg_q[size_t(b) * s.Sq + i] : 0;
  if (SEG && sg < 0) hi = lo - 1;
  for (int j = lo; j <= hi; ++j) {
    if (SEG && sgk[j] != sg) continue;
    float dot = 0.f, dpp = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dot = __fmaf_rn(qv[e], in(e) ? kb[j * ks + lane + 32 * e] : 0.f, dot);
      dpp = __fmaf_rn(dov[e], in(e) ? vb[j * ks + lane + 32 * e] : 0.f,
                      dpp);
    }
    const float p = expf(__fmul_rn(warp_sum(dot), s.scale) - lr);
    const float ds = __fmul_rn(p * (warp_sum(dpp) - dr), s.scale);
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc[e] = __fmaf_rn(ds, in(e) ? kb[j * ks + lane + 32 * e] : 0.f,
                         acc[e]);
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (in(e)) dq[roff + lane + 32 * e] = acc[e];
}

template <int DP, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dk,
              float* __restrict__ dv, Shape s) {
  constexpr int E = (DP + 31) / 32;
  const int lane = threadIdx.x & 31, D = s.D;
  auto in = [lane, D](int e) { return lane + 32 * e < D; };
  const int j = blockIdx.x * kRowsF32 + (threadIdx.x >> 5);
  if (j >= s.Sk) return;
  const int bhk = blockIdx.y, b = bhk / s.HK, kh = bhk % s.HK;
  const int G = s.H / s.HK;
  const size_t koff = ((size_t(b) * s.Sk + j) * s.HK + kh) * D;
  const size_t qs = size_t(s.H) * D;
  float kv[E], vv[E], dka[E], dva[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    kv[e] = (in(e) ? k[koff + lane + 32 * e] : 0.f);
    vv[e] = (in(e) ? v[koff + lane + 32 * e] : 0.f);
    dka[e] = dva[e] = 0.f;
  }
  int lo, hi;
  query_band(s, j, j, lo, hi);
  const int* sgq = SEG ? s.seg_q + size_t(b) * s.Sq : nullptr;
  const int sg = SEG ? s.seg_k[size_t(b) * s.Sk + j] : 0;
  if (SEG && sg < 0) hi = lo - 1;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const float* qb = q + (size_t(b) * s.Sq * s.H + h) * D;
    const float* db = dout + (size_t(b) * s.Sq * s.H + h) * D;
    const float* lh = lse + (size_t(b) * s.H + h) * s.Sq;
    const float* dh = delta + (size_t(b) * s.H + h) * s.Sq;
    for (int i = lo; i <= hi; ++i) {
      if (SEG && sgq[i] != sg) continue;
      float dot = 0.f, dpp = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dot = __fmaf_rn(in(e) ? qb[i * qs + lane + 32 * e] : 0.f, kv[e],
                        dot);
        dpp = __fmaf_rn(in(e) ? db[i * qs + lane + 32 * e] : 0.f, vv[e],
                        dpp);
      }
      const float p = expf(__fmul_rn(warp_sum(dot), s.scale) - lh[i]);
      const float ds = __fmul_rn(p * (warp_sum(dpp) - dh[i]), s.scale);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dva[e] = __fmaf_rn(p, in(e) ? db[i * qs + lane + 32 * e] : 0.f,
                           dva[e]);
        dka[e] = __fmaf_rn(ds, in(e) ? qb[i * qs + lane + 32 * e] : 0.f,
                           dka[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (in(e)) dk[koff + lane + 32 * e] = dka[e];
    if (in(e)) dv[koff + lane + 32 * e] = dva[e];
  }
}

// ---------------------------------------------------------------------------
// launchers. dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, dO
// and the outputs share it).
// ---------------------------------------------------------------------------
// Instances: DK > 0 builds the tensor-core kernels for head dim DK (a
// compile-time constant) at width DP; DK = 0 takes D at run time. The
// tensor-core kernels take every multiple of 8 up to 128 and 160, 192, 256
// at compile time (a runtime D cost the D = 128 forward 20% and dK/dV at
// D = 72-80 25-30% on the H100: `tools/time_flash.py`), every other D at
// run time at the width that holds it; the f32 kernels take D at run time
// at every width.

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int DP, int DK, bool SEG>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, void* o,
                   float* lse, const Shape& s, cudaStream_t st) {
  const size_t sm = fwd_smem<DP, SEG>();
  cudaError_t err = allow_smem(flash_fwd_tc<T, DP, DK, SEG>, sm);
  if (err != cudaSuccess) return err;
  dim3 grid((s.Sq + kBQ - 1) / kBQ, s.B * s.H);
  flash_fwd_tc<T, DP, DK, SEG><<<grid, kThreads, sm, st>>>(
      static_cast<const u16*>(q), static_cast<const u16*>(k),
      static_cast<const u16*>(v), static_cast<u16*>(o), lse, s);
  return cudaGetLastError();
}

template <int DP, int DK, bool SEG>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, const Shape& s, int dtype, cudaStream_t st) {
  if (dtype == 1) return fwd_tc<bf16, DP, DK, SEG>(q, k, v, o, lse, s, st);
  if (dtype == 2) return fwd_tc<f16, DP, DK, SEG>(q, k, v, o, lse, s, st);
  dim3 grid((s.Sq + kRowsF32 - 1) / kRowsF32, s.B * s.H);
  flash_fwd_f32<DP, SEG><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, s);
  return cudaGetLastError();
}

template <typename T, int DP, int DK, bool SEG>
cudaError_t dq_tc(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, const Shape& s, cudaStream_t st) {
  const size_t sm = dq_smem<DP, SEG>();
  cudaError_t err = allow_smem(flash_dq_tc<T, DP, DK, SEG>, sm);
  if (err != cudaSuccess) return err;
  dim3 grid((s.Sq + kBQ - 1) / kBQ, s.B * s.H);
  flash_dq_tc<T, DP, DK, SEG><<<grid, kThreads, sm, st>>>(
      static_cast<const u16*>(q), static_cast<const u16*>(k),
      static_cast<const u16*>(v), static_cast<const u16*>(dout), lse, delta,
      static_cast<u16*>(dq), s);
  return cudaGetLastError();
}

template <int DP, int DK, bool SEG>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, const Shape& s, int dtype, cudaStream_t st) {
  if (dtype == 1)
    return dq_tc<bf16, DP, DK, SEG>(q, k, v, dout, lse, delta, dq, s, st);
  if (dtype == 2)
    return dq_tc<f16, DP, DK, SEG>(q, k, v, dout, lse, delta, dq, s, st);
  dim3 grid((s.Sq + kRowsF32 - 1) / kRowsF32, s.B * s.H);
  flash_dq_f32<DP, SEG><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), s);
  return cudaGetLastError();
}

template <typename T, int DP, int DK, bool SEG>
cudaError_t dkv_tc(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, const Shape& s, cudaStream_t st) {
  const size_t sm = dkv_smem<DP, SEG>();
  cudaError_t err = allow_smem(flash_dkv_tc<T, DP, DK, SEG>, sm);
  if (err != cudaSuccess) return err;
  dim3 grid((s.Sk + kBK - 1) / kBK, s.B * s.HK);
  flash_dkv_tc<T, DP, DK, SEG><<<grid, kThreads, sm, st>>>(
      static_cast<const u16*>(q), static_cast<const u16*>(k),
      static_cast<const u16*>(v), static_cast<const u16*>(dout), lse, delta,
      static_cast<u16*>(dk), static_cast<u16*>(dv), s);
  return cudaGetLastError();
}

template <int DP, int DK, bool SEG>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, const Shape& s, int dtype,
                    cudaStream_t st) {
  if (dtype == 1)
    return dkv_tc<bf16, DP, DK, SEG>(q, k, v, dout, lse, delta, dk, dv, s,
                                     st);
  if (dtype == 2)
    return dkv_tc<f16, DP, DK, SEG>(q, k, v, dout, lse, delta, dk, dv, s,
                                    st);
  dim3 grid((s.Sk + kRowsF32 - 1) / kRowsF32, s.B * s.HK);
  flash_dkv_f32<DP, SEG><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), s);
  return cudaGetLastError();
}

inline Shape make_shape(int B, int Sq, int Sk, int H, int HK, int D,
                        float scale, int causal, int window,
                        const void* seg_q, const void* seg_k) {
  Shape s;
  s.B = B;
  s.Sq = Sq;
  s.Sk = Sk;
  s.H = H;
  s.HK = HK;
  s.D = D;
  s.scale = scale;
  s.causal = causal;
  s.window = causal ? window : 0;
  s.seg_q = static_cast<const int*>(seg_q);
  s.seg_k = static_cast<const int*>(seg_k);
  return s;
}

// the tile widths the kernels are built for; a head dim runs at the
// smallest that holds it, its columns past D zero in shared memory
inline int tile_width(int d) {
  for (int w : {16, 32, 48, 64, 80, 96, 112, 128, 160, 192, 256})
    if (d <= w) return w;
  return 0;
}

// any D up to 256 in every dtype
inline bool shape_ok(int B, int Sq, int Sk, int H, int HK, int D, int dtype) {
  return B > 0 && Sq > 0 && Sk > 0 && H > 0 && HK > 0 && H % HK == 0 &&
         dtype >= 0 && dtype <= 2 && D > 0 && D <= 256;
}

#define PDT_FLASH_DISPATCH(D, CALL)                          \
  switch (D) {                                               \
    case 8: return CALL(16, 8);                              \
    case 16: return CALL(16, 16);                            \
    case 24: return CALL(32, 24);                            \
    case 32: return CALL(32, 32);                            \
    case 40: return CALL(48, 40);                            \
    case 48: return CALL(48, 48);                            \
    case 56: return CALL(64, 56);                            \
    case 64: return CALL(64, 64);                            \
    case 72: return CALL(80, 72);                            \
    case 80: return CALL(80, 80);                            \
    case 88: return CALL(96, 88);                            \
    case 96: return CALL(96, 96);                            \
    case 104: return CALL(112, 104);                         \
    case 112: return CALL(112, 112);                         \
    case 120: return CALL(128, 120);                         \
    case 128: return CALL(128, 128);                         \
    case 160: return CALL(160, 160);                         \
    case 192: return CALL(192, 192);                         \
    case 256: return CALL(256, 256);                         \
    default: break;                                          \
  }                                                          \
  switch (tile_width(D)) {                                   \
    case 16: return CALL(16, 0);                             \
    case 32: return CALL(32, 0);                             \
    case 48: return CALL(48, 0);                             \
    case 64: return CALL(64, 0);                             \
    case 80: return CALL(80, 0);                             \
    case 96: return CALL(96, 0);                             \
    case 112: return CALL(112, 0);                           \
    case 128: return CALL(128, 0);                           \
    case 160: return CALL(160, 0);                           \
    case 192: return CALL(192, 0);                           \
    case 256: return CALL(256, 0);                           \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

template <bool SEG>
int run_fwd(const void* q, const void* k, const void* v, const void* seg_q,
            const void* seg_k, void* o, void* lse, int B, int Sq, int Sk,
            int H, int HK, int D, float scale, int causal, int window,
            int dtype, void* stream) {
  if (!shape_ok(B, Sq, Sk, H, HK, D, dtype) || (SEG && !(seg_q && seg_k)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(B, Sq, Sk, H, HK, D, scale, causal, window,
                             seg_q, seg_k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define PDT_CALL(DP, DK) fwd<DP, DK, SEG>(q, k, v, o, l, s, dtype, st)
  PDT_FLASH_DISPATCH(D, PDT_CALL)
#undef PDT_CALL
}

template <bool SEG>
int run_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* seg_q,
           const void* seg_k, void* dq, int B, int Sq, int Sk, int H, int HK,
           int D, float scale, int causal, int window, int dtype,
           void* stream) {
  if (!shape_ok(B, Sq, Sk, H, HK, D, dtype) || (SEG && !(seg_q && seg_k)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(B, Sq, Sk, H, HK, D, scale, causal, window,
                             seg_q, seg_k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define PDT_CALL(DP, DK) \
  bwd_dq<DP, DK, SEG>(q, k, v, dout, l, dl, dq, s, dtype, st)
  PDT_FLASH_DISPATCH(D, PDT_CALL)
#undef PDT_CALL
}

template <bool SEG>
int run_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, const void* seg_q,
            const void* seg_k, void* dk, void* dv, int B, int Sq, int Sk,
            int H, int HK, int D, float scale, int causal, int window,
            int dtype, void* stream) {
  if (!shape_ok(B, Sq, Sk, H, HK, D, dtype) || (SEG && !(seg_q && seg_k)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(B, Sq, Sk, H, HK, D, scale, causal, window,
                             seg_q, seg_k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define PDT_CALL(DP, DK) \
  bwd_dkv<DP, DK, SEG>(q, k, v, dout, l, dl, dk, dv, s, dtype, st)
  PDT_FLASH_DISPATCH(D, PDT_CALL)
#undef PDT_CALL
}

}  // namespace pdt_flash
