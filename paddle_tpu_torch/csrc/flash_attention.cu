// Flash attention for Hopper (sm_90a): the forward (o and the row
// log-sum-exp), the dQ backward and the dK/dV backward of GQA attention with
// an end-aligned causal mask and an optional sliding window.
//
// Replaces: paddle_tpu/ops/flash_attention.py:_fwd_kernel (:127, launched by
// _flash_fwd, pallas_call at :190), _bwd_dq_kernel (:223, pallas_call at
// :333) and _bwd_dkv_kernel (:270, pallas_call at :361).
//
// Layout: the JAX package's public one, (B, S, H, D), read in place: q, dO
// and o are (B, Sq, H, D), k, v, dK and dV (B, Sk, HK, D), all contiguous;
// lse and delta are (B, H, Sq) f32. Query head h reads KV head h / (H / HK)
// (the JAX grid's `b // group` on the (B*H) axis), so K and V are never
// repeated in memory. No transposes around the kernels.
//
// Semantics, as the JAX kernels: s = (q . k) * scale in f32; q row i (of Sq)
// sees key j (of Sk) iff j <= i + Sk - Sq when causal and, with a window w,
// j > i + Sk - Sq - w. A row with no live key outputs 0, lse -1e30 and zero
// gradient; masked entries give p = 0 exactly, never exp(-1e30 + 1e30).
// Any Sq, Sk: tails of the tiles are masked and zero-filled.
//
// What bounds it on this card: operations. At the training shape (S = 2048,
// D = 64 or 128) a (q row, key) pair costs 4D flops forward and 10D to 14D
// backward against a few bytes per row, far past the card's ~295 flops per
// byte. So the bf16 path runs on tensor cores: mma.sync.m16n8k16 with bf16
// operands and f32 accumulation, 64-row q tiles (16 rows a warp) and 64-key
// tiles staged in shared memory, tiles outside the causal/window band
// skipped (_tile_live). The online softmax lives in the accumulator
// registers; P feeds the PV product straight from them. Precision follows
// the JAX kernels: P is rounded to bf16 for P.V (the JAX p.astype(v.dtype)),
// dS to bf16 for dS.K (ds.astype(k.dtype)); the dK/dV kernel keeps P and dS
// at ~16 significant bits by splitting each into a bf16 high and low part
// (two mma), where JAX multiplies them in f32. Exponentials use __expf
// (ex2.approx): a few ulp of f32, far inside the bf16 rounding of P.
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
//
// C interface: device pointers on the caller's current stream; each entry
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// the JAX kernel's NEG_INF: the lse of a row that attends no key
constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // 4 warps
constexpr int kPad = 8;        // bf16 elements of row padding in shared memory

struct Shape {
  int B, Sq, Sk, H, HK;
  float scale;
  int causal;
  int window;  // <= 0: no window
};

__device__ __forceinline__ bool is_live(const Shape& s, int i, int j) {
  if (i >= s.Sq || j >= s.Sk) return false;
  if (!s.causal) return true;
  const int p = i + s.Sk - s.Sq;
  return j <= p && (s.window <= 0 || j > p - s.window);
}

// every (q row, key) of rows [i0, i1] x keys [j0, j1] is live: the tile
// needs no per-element mask
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
// tensor-core building blocks
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x ~= hi + lo, both bf16 pairs: ~16 significant bits of x in two mma inputs
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// Fragments of mma.m16n8k16 (g = lane / 4, t = lane % 4). A (16 x 16,
// row-major at s[m * ld + k]): {row g, cols 2t..2t+1}, {row g+8, ...},
// {row g, cols 2t+8..}, {row g+8, cols 2t+8..}.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* s, int ld,
                                       int m0, int k0, int g, int t) {
  const bf16* p = s + (m0 + g) * ld + k0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// B (16 x 8, element (k, n) at s[n * ld + k]): {k 2t..2t+1, n g},
// {k 2t+8.., n g}
__device__ __forceinline__ void load_b(uint32_t* b, const bf16* s, int ld,
                                       int n0, int k0, int g, int t) {
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B (16 x 8) where element (k, n) is at s[k * ld + n] (a row-major tile
// whose rows are the k axis): ldmatrix.trans of the two 8 x 8 blocks at
// rows k0.. and k0+8.., columns n0..; lanes 0-15 give the row addresses.
__device__ __forceinline__ void load_b_trans(uint32_t* b, const bf16* s,
                                             int ld, int n0, int k0,
                                             int lane) {
  const bf16* p = s + (k0 + (lane & 15)) * ld + n0;
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(addr));
}

// The A fragment of the 16 x 16 block kk of a 16-row accumulator tile
// c[n][4] (C layout: c[n][0..1] row g cols 8n+2t.., c[n][2..3] row g+8).
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*c)[4],
                                         int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

__device__ __forceinline__ void acc_to_a_split(uint32_t* hi, uint32_t* lo,
                                               const float (*c)[4], int kk) {
  split_bf16(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
  split_bf16(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
  split_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
  split_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
}

// rows [r0, r0 + R) of one head into shared memory [R][D + kPad]; rows at
// or past S are zero. `base` points at (row 0, this head, 0); rows are
// `stride` elements apart.
template <int D, int R>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* base,
                                           int r0, int S, size_t stride) {
  constexpr int C = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < R * C; c += kThreads) {
    const int r = c / C, col = (c % C) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < S)
      v = *reinterpret_cast<const uint4*>(base + size_t(r0 + r) * stride +
                                          col);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + col) = v;
  }
}

// ---------------------------------------------------------------------------
// bf16 forward: one block per (64 q rows, query head)
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;     // q rows per block (fwd, dQ)
constexpr int kBK = 64;     // keys per tile (fwd, dQ) and per block (dK/dV)
constexpr int kBQdkv = 32;  // q rows per tile of the dK/dV walk

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(bf16) * (kBQ + 2 * kBK) * (D + kPad);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, Shape s) {
  constexpr int LD = D + kPad, NK = kBK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [kBQ][LD]
  bf16* Ks = Qs + kBQ * LD;                  // [kBK][LD]
  bf16* Vs = Ks + kBK * LD;                  // [kBK][LD]
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int kh = h / (s.H / s.HK);
  const int q0 = blockIdx.x * kBQ;
  const size_t qs = size_t(s.H) * D, ks = size_t(s.HK) * D;
  const bf16* qb = q + (size_t(b) * s.Sq * s.H + h) * D;
  const bf16* kb = k + (size_t(b) * s.Sk * s.HK + kh) * D;
  const bf16* vb = v + (size_t(b) * s.Sk * s.HK + kh) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;

  stage_rows<D, kBQ>(Qs, qb, q0, s.Sq, qs);
  int klo, khi;
  key_band(s, q0, min(q0 + kBQ, s.Sq) - 1, klo, khi);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = klo / kBK; khi >= klo && kt <= khi / kBK; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    stage_rows<D, kBK>(Ks, kb, k0, s.Sk, ks);
    stage_rows<D, kBK>(Vs, vb, k0, s.Sk, ks);
    __syncthreads();

    float sc[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, Qs, LD, r0, 16 * kk, g, t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t bb[2];
        load_b(bb, Ks, LD, 8 * n, 16 * kk, g, t);
        mma_bf16(sc[n], a, bb);
      }
    }
    // scale, mask, row max over the tile (4 lanes share a row)
    const bool full = tile_full(s, q0, q0 + kBQ - 1, k0, k0 + kBK - 1);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + g + 8 * (e >> 1);
        const int col = k0 + 8 * n + 2 * t + (e & 1);
        if (full || is_live(s, row, col)) {
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
    // acc += P (bf16) . V
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, sc, kk);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bb[2];
        load_b_trans(bb, Vs, LD, 8 * n, 16 * kk, lane);
        mma_bf16(acc[n], a, bb);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= s.Sq) continue;
    const bool any = l[r] > 0.f;
    bf16* orow = o + ((size_t(b) * s.Sq + row) * s.H + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float x0 = any ? acc[n][2 * r] / l[r] : 0.f;
      const float x1 = any ? acc[n][2 * r + 1] / l[r] : 0.f;
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) = pack_bf16(x0, x1);
    }
    if (t == 0) lse[size_t(bh) * s.Sq + row] = any ? m[r] + logf(l[r])
                                                   : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// bf16 dQ: one block per (64 q rows, query head), walking the live key tiles
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dq_smem() {
  return sizeof(bf16) * (2 * kBQ + 2 * kBK) * (D + kPad);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dq,
              Shape s) {
  constexpr int LD = D + kPad, NK = kBK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [kBQ][LD]
  bf16* dOs = Qs + kBQ * LD;                 // [kBQ][LD]
  bf16* Ks = dOs + kBQ * LD;                 // [kBK][LD]
  bf16* Vs = Ks + kBK * LD;                  // [kBK][LD]
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int kh = h / (s.H / s.HK);
  const int q0 = blockIdx.x * kBQ;
  const size_t qs = size_t(s.H) * D, ks = size_t(s.HK) * D;
  const size_t qoff = (size_t(b) * s.Sq * s.H + h) * D;
  const size_t koff = (size_t(b) * s.Sk * s.HK + kh) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;

  stage_rows<D, kBQ>(Qs, q + qoff, q0, s.Sq, qs);
  stage_rows<D, kBQ>(dOs, dout + qoff, q0, s.Sq, qs);
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    lr[r] = row < s.Sq ? lse[size_t(bh) * s.Sq + row] : 0.f;
    dr[r] = row < s.Sq ? delta[size_t(bh) * s.Sq + row] : 0.f;
  }
  int klo, khi;
  key_band(s, q0, min(q0 + kBQ, s.Sq) - 1, klo, khi);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = klo / kBK; khi >= klo && kt <= khi / kBK; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    stage_rows<D, kBK>(Ks, k + koff, k0, s.Sk, ks);
    stage_rows<D, kBK>(Vs, v + koff, k0, s.Sk, ks);
    __syncthreads();

    float sc[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], ad[4];
      load_a(a, Qs, LD, r0, 16 * kk, g, t);
      load_a(ad, dOs, LD, r0, 16 * kk, g, t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t bb[2];
        load_b(bb, Ks, LD, 8 * n, 16 * kk, g, t);
        mma_bf16(sc[n], a, bb);
        load_b(bb, Vs, LD, 8 * n, 16 * kk, g, t);
        mma_bf16(dp[n], ad, bb);
      }
    }
    // dS = P * (dP - delta) * scale, P = exp(s - lse), 0 where masked
    const bool full = tile_full(s, q0, q0 + kBQ - 1, k0, k0 + kBK - 1);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int row = q0 + r0 + g + 8 * r;
        const int col = k0 + 8 * n + 2 * t + (e & 1);
        float ds = 0.f;
        if (full || is_live(s, row, col)) {
          const float p = __expf(sc[n][e] * s.scale - lr[r]);
          ds = p * (dp[n][e] - dr[r]) * s.scale;
        }
        sc[n][e] = ds;
      }
    // dQ += dS (bf16) . K
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, sc, kk);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bb[2];
        load_b_trans(bb, Ks, LD, 8 * n, 16 * kk, lane);
        mma_bf16(acc[n], a, bb);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= s.Sq) continue;
    bf16* drow = dq + qoff + size_t(row) * qs;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(drow + 8 * n + 2 * t) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// bf16 dK/dV: one block per (64 keys, KV head); each warp owns 16 keys and
// walks the group's query heads and their live q tiles in order
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(bf16) * (2 * kBK + 2 * kBQdkv) * (D + kPad) +
         sizeof(float) * 2 * kBQdkv;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, Shape s) {
  constexpr int LD = D + kPad, NQ = kBQdkv / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [kBK][LD]
  bf16* Vs = Ks + kBK * LD;                  // [kBK][LD]
  bf16* Qs = Vs + kBK * LD;                  // [kBQdkv][LD]
  bf16* dOs = Qs + kBQdkv * LD;              // [kBQdkv][LD]
  float* ls = reinterpret_cast<float*>(dOs + kBQdkv * LD);  // [kBQdkv]
  float* dl = ls + kBQdkv;                              // [kBQdkv]
  const int bhk = blockIdx.y, b = bhk / s.HK, kh = bhk % s.HK;
  const int G = s.H / s.HK;
  const int k0 = blockIdx.x * kBK;
  const size_t qs = size_t(s.H) * D, ks = size_t(s.HK) * D;
  const size_t koff = (size_t(b) * s.Sk * s.HK + kh) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;

  stage_rows<D, kBK>(Ks, k + koff, k0, s.Sk, ks);
  stage_rows<D, kBK>(Vs, v + koff, k0, s.Sk, ks);
  int qlo, qhi;
  query_band(s, k0, min(k0 + kBK, s.Sk) - 1, qlo, qhi);

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
      __syncthreads();
      stage_rows<D, kBQdkv>(Qs, q + qoff, q0, s.Sq, qs);
      stage_rows<D, kBQdkv>(dOs, dout + qoff, q0, s.Sq, qs);
      for (int i = threadIdx.x; i < kBQdkv; i += kThreads) {
        const bool in = q0 + i < s.Sq;
        ls[i] = in ? lh[q0 + i] : 0.f;
        dl[i] = in ? dh[q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x kBQdkv q rows per warp
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], av[4];
        load_a(a, Ks, LD, r0, 16 * kk, g, t);
        load_a(av, Vs, LD, r0, 16 * kk, g, t);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          uint32_t bb[2];
          load_b(bb, Qs, LD, 8 * n, 16 * kk, g, t);
          mma_bf16(st[n], a, bb);
          load_b(bb, dOs, LD, 8 * n, 16 * kk, g, t);
          mma_bf16(dpt[n], av, bb);
        }
      }
      const bool full = tile_full(s, q0, q0 + kBQdkv - 1, k0, k0 + kBK - 1);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + r0 + g + 8 * (e >> 1);
          const int qi = 8 * n + 2 * t + (e & 1);
          float p = 0.f, ds = 0.f;
          if (full || is_live(s, q0 + qi, key)) {
            p = __expf(st[n][e] * s.scale - ls[qi]);
            ds = p * (dpt[n][e] - dl[qi]) * s.scale;
          }
          st[n][e] = p;
          dpt[n][e] = ds;
        }
      // dV += P^T dO and dK += dS^T Q, P and dS as bf16 high + low parts
#pragma unroll
      for (int kk = 0; kk < kBQdkv / 16; ++kk) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        acc_to_a_split(ph, pl, st, kk);
        acc_to_a_split(sh, sl, dpt, kk);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bb[2];
          load_b_trans(bb, dOs, LD, 8 * n, 16 * kk, lane);
          mma_bf16(dva[n], ph, bb);
          mma_bf16(dva[n], pl, bb);
          load_b_trans(bb, Qs, LD, 8 * n, 16 * kk, lane);
          mma_bf16(dka[n], sh, bb);
          mma_bf16(dka[n], sl, bb);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + g + 8 * r;
    if (key >= s.Sk) continue;
    bf16* krow = dk + koff + size_t(key) * ks;
    bf16* vrow = dv + koff + size_t(key) * ks;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(krow + 8 * n + 2 * t) =
          pack_bf16(dka[n][2 * r], dka[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(vrow + 8 * n + 2 * t) =
          pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, one warp per row; lane holds elements lane + 32 e
// ---------------------------------------------------------------------------
constexpr int kRowsF32 = kThreads / 32;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, Shape s) {
  constexpr int E = D / 32;
  const int lane = threadIdx.x & 31;
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
    qv[e] = qr[lane + 32 * e];
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  int lo, hi;
  key_band(s, i, i, lo, hi);
  for (int j = lo; j <= hi; ++j) {
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) dot += qv[e] * kb[j * ks + lane + 32 * e];
    const float x = warp_sum(dot) * s.scale;
    const float mn = fmaxf(m, x);
    const float alpha = expf(m - mn), p = expf(x - mn);
    l = l * alpha + p;
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc[e] = acc[e] * alpha + p * vb[j * ks + lane + 32 * e];
    m = mn;
  }
  float* orow = o + ((size_t(b) * s.Sq + i) * s.H + h) * D;
  const bool any = l > 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) orow[lane + 32 * e] = any ? acc[e] / l : 0.f;
  if (lane == 0) lse[size_t(bh) * s.Sq + i] = any ? m + logf(l) : kNegInf;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, Shape s) {
  constexpr int E = D / 32;
  const int lane = threadIdx.x & 31;
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
    qv[e] = q[roff + lane + 32 * e];
    dov[e] = dout[roff + lane + 32 * e];
    acc[e] = 0.f;
  }
  int lo, hi;
  key_band(s, i, i, lo, hi);
  for (int j = lo; j <= hi; ++j) {
    float dot = 0.f, dpp = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dot += qv[e] * kb[j * ks + lane + 32 * e];
      dpp += dov[e] * vb[j * ks + lane + 32 * e];
    }
    const float p = expf(warp_sum(dot) * s.scale - lr);
    const float ds = p * (warp_sum(dpp) - dr) * s.scale;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += ds * kb[j * ks + lane + 32 * e];
  }
#pragma unroll
  for (int e = 0; e < E; ++e) dq[roff + lane + 32 * e] = acc[e];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dk,
              float* __restrict__ dv, Shape s) {
  constexpr int E = D / 32;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kRowsF32 + (threadIdx.x >> 5);
  if (j >= s.Sk) return;
  const int bhk = blockIdx.y, b = bhk / s.HK, kh = bhk % s.HK;
  const int G = s.H / s.HK;
  const size_t koff = ((size_t(b) * s.Sk + j) * s.HK + kh) * D;
  const size_t qs = size_t(s.H) * D;
  float kv[E], vv[E], dka[E], dva[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    kv[e] = k[koff + lane + 32 * e];
    vv[e] = v[koff + lane + 32 * e];
    dka[e] = dva[e] = 0.f;
  }
  int lo, hi;
  query_band(s, j, j, lo, hi);
  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const float* qb = q + (size_t(b) * s.Sq * s.H + h) * D;
    const float* db = dout + (size_t(b) * s.Sq * s.H + h) * D;
    const float* lh = lse + (size_t(b) * s.H + h) * s.Sq;
    const float* dh = delta + (size_t(b) * s.H + h) * s.Sq;
    for (int i = lo; i <= hi; ++i) {
      float dot = 0.f, dpp = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dot += qb[i * qs + lane + 32 * e] * kv[e];
        dpp += db[i * qs + lane + 32 * e] * vv[e];
      }
      const float p = expf(warp_sum(dot) * s.scale - lh[i]);
      const float ds = p * (warp_sum(dpp) - dh[i]) * s.scale;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dva[e] += p * db[i * qs + lane + 32 * e];
        dka[e] += ds * qb[i * qs + lane + 32 * e];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    dk[koff + lane + 32 * e] = dka[e];
    dv[koff + lane + 32 * e] = dva[e];
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, const Shape& s, int dtype, cudaStream_t st) {
  const int bh = s.B * s.H;
  if (dtype == 1) {
    const size_t sm = fwd_smem<D>();
    cudaError_t err = allow_smem(flash_fwd_bf16<D>, sm);
    if (err != cudaSuccess) return err;
    dim3 grid((s.Sq + kBQ - 1) / kBQ, bh);
    flash_fwd_bf16<D><<<grid, kThreads, sm, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, s);
  } else {
    dim3 grid((s.Sq + kRowsF32 - 1) / kRowsF32, bh);
    flash_fwd_f32<D><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, s);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, const Shape& s, int dtype, cudaStream_t st) {
  const int bh = s.B * s.H;
  if (dtype == 1) {
    const size_t sm = dq_smem<D>();
    cudaError_t err = allow_smem(flash_dq_bf16<D>, sm);
    if (err != cudaSuccess) return err;
    dim3 grid((s.Sq + kBQ - 1) / kBQ, bh);
    flash_dq_bf16<D><<<grid, kThreads, sm, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dq), s);
  } else {
    dim3 grid((s.Sq + kRowsF32 - 1) / kRowsF32, bh);
    flash_dq_f32<D><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), s);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, const Shape& s, int dtype,
                    cudaStream_t st) {
  const int bhk = s.B * s.HK;
  if (dtype == 1) {
    const size_t sm = dkv_smem<D>();
    cudaError_t err = allow_smem(flash_dkv_bf16<D>, sm);
    if (err != cudaSuccess) return err;
    dim3 grid((s.Sk + kBK - 1) / kBK, bhk);
    flash_dkv_bf16<D><<<grid, kThreads, sm, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), s);
  } else {
    dim3 grid((s.Sk + kRowsF32 - 1) / kRowsF32, bhk);
    flash_dkv_f32<D><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), s);
  }
  return cudaGetLastError();
}

Shape make_shape(int B, int Sq, int Sk, int H, int HK, float scale,
                 int causal, int window) {
  Shape s;
  s.B = B;
  s.Sq = Sq;
  s.Sk = Sk;
  s.H = H;
  s.HK = HK;
  s.scale = scale;
  s.causal = causal;
  s.window = causal ? window : 0;
  return s;
}

bool shape_ok(int B, int Sq, int Sk, int H, int HK, int dtype) {
  return B > 0 && Sq > 0 && Sk > 0 && H > 0 && HK > 0 && H % HK == 0 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs share it);
// window <= 0: no window (a window needs causal). Head dims 32, 64, 128.
extern "C" int pdt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int Sq, int Sk, int H,
                             int HK, int D, float scale, int causal,
                             int window, int dtype, void* stream) {
  if (!shape_ok(B, Sq, Sk, H, HK, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(B, Sq, Sk, H, HK, scale, causal, window);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 32: return fwd<32>(q, k, v, o, l, s, dtype, st);
    case 64: return fwd<64>(q, k, v, o, l, s, dtype, st);
    case 128: return fwd<128>(q, k, v, o, l, s, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int pdt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int Sq,
                                int Sk, int H, int HK, int D, float scale,
                                int causal, int window, int dtype,
                                void* stream) {
  if (!shape_ok(B, Sq, Sk, H, HK, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(B, Sq, Sk, H, HK, scale, causal, window);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (D) {
    case 32: return bwd_dq<32>(q, k, v, dout, l, dl, dq, s, dtype, st);
    case 64: return bwd_dq<64>(q, k, v, dout, l, dl, dq, s, dtype, st);
    case 128: return bwd_dq<128>(q, k, v, dout, l, dl, dq, s, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int pdt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int B, int Sq, int Sk, int H, int HK, int D,
                                 float scale, int causal, int window,
                                 int dtype, void* stream) {
  if (!shape_ok(B, Sq, Sk, H, HK, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(B, Sq, Sk, H, HK, scale, causal, window);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (D) {
    case 32: return bwd_dkv<32>(q, k, v, dout, l, dl, dk, dv, s, dtype, st);
    case 64: return bwd_dkv<64>(q, k, v, dout, l, dl, dk, dv, s, dtype, st);
    case 128:
      return bwd_dkv<128>(q, k, v, dout, l, dl, dk, dv, s, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
