// What the wgmma / TMA flash attention kernels (flash_fwd_sm90.cu, the
// forward; flash_bwd_sm90.cu, dQ and dK/dV; flash_varlen_sm90.cu, the
// packed ones) share: the attention's shape and masks, the block layout
// (two consumer warpgroups and a producer), the dQ kernels' delta rows,
// the forward's online softmax, the ordered sum of dK/dV partials, the
// Q / K / V register operands and the (B, S, H, D) tensor maps.
//
// Semantics, as the JAX kernels and flash_kernels.cuh: (B, S, H, D) tensors
// read in place, lse and delta (B, H, Sq) f32, query head h reads KV head
// h / (H / HK), q row i sees key j iff j <= i + Sk - Sq when causal and
// j > i + Sk - Sq - w under a window w; a row with no live key has lse
// -1e30, output 0 and zero gradient; any Sq, Sk (TMA's zero fill takes the
// tails, the masks drop them).
#pragma once

#include "sm90.cuh"

namespace pdt_sm90 {

constexpr float kNegInf = -1e30f;  // the lse of a row with no live key
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumers = 2;  // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRows = 64;      // rows of a tile: a TMA box, a wgmma M or N
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

struct Shape {
  int B, Sq, Sk, H, HK;
  float scale;
  int causal;
  int window;  // <= 0: none
};

// q row i sees key j; without branches (bitwise &), so the element loops
// that mask with it compile to selects and stay free to interleave
__device__ __forceinline__ bool is_live(const Shape& s, int i, int j) {
  const int p = i + s.Sk - s.Sq;
  const bool band = (j <= p) & ((s.window <= 0) | (j > p - s.window));
  return (i < s.Sq) & (j < s.Sk) & ((s.causal == 0) | band);
}

// every (q row, key) of rows [i0, i1] x keys [j0, j1] is live
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

// rowsum(o dO) of one row, this lane's D / 32 elements (a warp sums)
template <typename T, int D>
__device__ __forceinline__ float row_dot(const u16* o, const u16* dout) {
  float v = 0.f;
  if constexpr (D == 128) {
    const uint2 a = *reinterpret_cast<const uint2*>(o);
    const uint2 c = *reinterpret_cast<const uint2*>(dout);
    const float2 a0 = unpack2<T>(a.x), a1 = unpack2<T>(a.y);
    const float2 c0 = unpack2<T>(c.x), c1 = unpack2<T>(c.y);
    v = a0.x * c0.x + a0.y * c0.y + a1.x * c1.x + a1.y * c1.y;
  } else {
    const float2 a0 = unpack2<T>(*reinterpret_cast<const uint32_t*>(o));
    const float2 c0 = unpack2<T>(*reinterpret_cast<const uint32_t*>(dout));
    v = a0.x * c0.x + a0.y * c0.y;
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One key tile's online softmax for this thread's two rows (g and g + 8 of
// its warp's 16): the raw scores `sc` (64 x BN accumulator layout) become
// P in place; m (running row max, base 2, scaled) and l (this thread's
// share of the row sums) move on, and acc is rescaled. MASK: the tile is
// cut by a mask, and live(i) says whether accumulator element i is live;
// its dead elements leave the max and give P = 0 (selects after the
// arithmetic).
template <bool MASK, int BN, int D, class Live>
__device__ __forceinline__ void online_softmax(float (&sc)[BN / 2],
                                               float (&acc)[D / 2],
                                               float (&m)[2], float (&l)[2],
                                               float sl2, const Live& live) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i >> 1) & 1;
    float x = sc[i];
    if constexpr (MASK) x = live(i) ? x : -INFINITY;
    mx[r] = fmaxf(mx[r], x);
  }
  float mref[2], alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * sl2);
    mref[r] = mn == -INFINITY ? 0.f : mn;
    alpha[r] = fast_exp2(m[r] - mref[r]);
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i >> 1) & 1;
    float p = fast_exp2(fmaf(sc[i], sl2, -mref[r]));
    if constexpr (MASK) p = live(i) ? p : 0.f;
    sc[i] = p;
    l[r] += p;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// dK and dV from the f32 partial sums of `splits` blocks, added in split
// order (deterministic), rounded once to T; n elements each, two a thread
template <typename T>
__global__ void __launch_bounds__(256)
    flash_dkv_sum_sm90(const float* __restrict__ ws, int splits, size_t n,
                       u16* __restrict__ dk, u16* __restrict__ dv) {
  const float2* w = reinterpret_cast<const float2*>(ws);
  const size_t m = n / 2;
  for (size_t i = size_t(blockIdx.x) * 256 + threadIdx.x; i < m;
       i += size_t(gridDim.x) * 256) {
    float2 a = w[i], c = w[splits * m + i];
    for (int sp = 1; sp < splits; ++sp) {
      const float2 x = w[sp * m + i], y = w[(splits + sp) * m + i];
      a.x += x.x;
      a.y += x.y;
      c.x += y.x;
      c.y += y.y;
    }
    reinterpret_cast<uint32_t*>(dk)[i] = pack2<T>(a.x, a.y);
    reinterpret_cast<uint32_t*>(dv)[i] = pack2<T>(c.x, c.y);
  }
}

// The register A fragments of a warp's 16 rows of a (B, S, H, D) tensor,
// every 16-column k step: rows at or past S are zero. `row` points at the
// thread's row g (of the warp's 16); row g + 8 is 8 rows on.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const u16* p,
                                       size_t row_stride, bool in0, bool in1,
                                       int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const u16* c = p + 16 * kk + 2 * t;
    a[kk][0] = in0 ? *reinterpret_cast<const uint32_t*>(c) : 0u;
    a[kk][1] = in1 ? *reinterpret_cast<const uint32_t*>(c + 8 * row_stride)
                   : 0u;
    a[kk][2] = in0 ? *reinterpret_cast<const uint32_t*>(c + 8) : 0u;
    a[kk][3] =
        in1 ? *reinterpret_cast<const uint32_t*>(c + 8 * row_stride + 8) : 0u;
  }
}

// The (B, S, H, D) tensor at `ptr` as a 4-D map over (D, H, S, B): boxes of
// 64 columns x 64 rows of one head, 128-byte swizzle, zero fill past S.
inline bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                     int D, int dtype) {
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(H) * D * 2,
                                 cuuint64_t(S) * H * D * 2};
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  return make_tiled_map(map, ptr, 4, dims, strides, box, dtype);
}

// what the entries take: bf16 (1) or f16 (2), D 64 or 128
inline bool takes(int B, int Sq, int Sk, int H, int HK, int D, int dtype) {
  return B > 0 && Sq > 0 && Sk > 0 && H > 0 && HK > 0 && H % HK == 0 &&
         (dtype == 1 || dtype == 2) && (D == 64 || D == 128);
}

inline Shape make_shape(int B, int Sq, int Sk, int H, int HK, float scale,
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

}  // namespace pdt_sm90
