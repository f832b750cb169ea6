// q=1 paged decode attention for Hopper (sm_90a): for each sequence b and KV
// head hk, the G = H / HK query rows of heads hk*G .. hk*G + G - 1 attend the
// keys [max(0, ctx - window), ctx) of sequence b, ctx = context_lens[b],
// through its row of the block table. Softmax in f32; the output is
// acc / max(l, 1e-30) in q's type, zero when the sequence has no key.
//
// Replaces: paddle_tpu/ops/paged_attention.py:_paged_kernel (:53), launched
// by paged_attention_values, pallas_call at :146 (the
// attention_impl="legacy" engine's decode attention).
//
// Layout (the JAX package's, unchanged): q and o (B, H, D); k/v pages (HK, P,
// page_size, D); context_lens (B,) int32; block_tables (B, pps) int32.
//
// Two designs, two C entries:
// - "split" (pdt_paged_attention_split; the legacy engine's decode): the
//   decode case of ragged attention's split design, one row a sequence,
//   from the same device code (decode_attention.cuh, where what bounds it
//   and how it is built is described): the context split across blocks,
//   pages fed to shared memory in their own type by the copy engine, a warp
//   taking keys with 16-byte slices a lane, the splits merged in order by
//   the last to finish.
// - "serial" (pdt_paged_attention, below; the first design), kept so that the
//   two can be timed in turns on one card, until the split design's numbers
//   stand. It is described here.
//
// The serial design. The TPU grid (b, kv head, page) walks all pps pages of
// the table in order, masks the dead ones, and carries the online-softmax
// state across the page axis in VMEM. Blocks on Hopper run in no order, so
// one block of 8 warps
// takes one (b, kv head) and walks only the LIVE pages, from the window's
// first page to the page of key ctx - 1 (never past pps); warp w takes pages
// lo + w, lo + w + 8, ..., so eight pages are read at once. A warp keeps its
// state in registers: lane l holds elements d = l, l + 32, ... of the G query
// rows and of their running output rows, reads a key's and a value's row as
// 32-element runs (the next two or four keys' rows are loaded before the
// current ones' math), and takes each logit as a warp sum. The running max,
// sum and output are updated key by key. At the end the eight warps' states
// are merged in shared memory, each rescaled to the common max, and the block
// writes its G rows.
//
// What bounds it on this card: bytes. Each live K/V row is read once for G
// query rows, about G / 2 operations a byte in bf16, far below the ~295 where
// the tensor cores become the limit. The serial design is latency-bound:
// B * HK blocks walk their pages serially, so a long context with few
// sequences leaves SMs idle, and lanes load K and V rows element by element.
//
// C interface: device pointers on the caller's stream; each entry returns
// cudaGetLastError() after its launches, or cudaErrorInvalidValue for shapes
// it does not take (head_dim above 256, more than 16 query heads per KV
// head).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "decode_attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic limit

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

// butterfly sum: every lane ends with the same value (each step adds the
// same two operands on both lanes of a pair)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// GM: the most query rows per KV head this instance takes; C: elements of a
// row per lane, ceil(D / 32)
template <typename T, int GM, int C>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ ctxlen,
                       const int* __restrict__ bt, T* __restrict__ o, int H,
                       int HK, int D, int P, int ps, int pps, float scale,
                       int window) {
  // keys whose rows a warp loads together: fewer where the G query rows
  // take more registers
  constexpr int kKeys = GM <= 4 ? 4 : 2;
  // per warp and query row: D accumulator values, then m and l
  extern __shared__ float smem[];
  const int b = blockIdx.x, hk = blockIdx.y;
  const int G = H / HK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ctx = ctxlen[b];
  const int lo = (window > 0 && ctx > window) ? ctx - window : 0;
  const int page_hi = ctx > 0 ? min((ctx - 1) / ps, pps - 1) : -1;

  float qr[GM][C], acc[GM][C], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = lane + 32 * c;
      qr[g][c] = (g < G && d < D)
                     ? to_f(q[(size_t(b) * H + hk * G + g) * D + d])
                     : 0.f;
      acc[g][c] = 0.f;
    }
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  // The warp's keys, kKeys at a time: chunk (i, j) holds keys j .. j +
  // kKeys - 1 of page i that lie in [lo, ctx). The next chunk's rows are
  // loaded before the current one's math, so their loads are in flight
  // while it runs (software pipelining in registers).
  const int* bt_row = bt + size_t(b) * pps;
  const T* k_head = kp + size_t(hk) * P * ps * D;
  const T* v_head = vp + size_t(hk) * P * ps * D;
  float kv[kKeys][C], vv[kKeys][C], kn[kKeys][C], vn[kKeys][C];
  auto load = [&](int i, int j, float (&kd)[kKeys][C],
                  float (&vd)[kKeys][C]) {
    const size_t base = size_t(bt_row[i]) * ps * D;
    const int j1 = min(ctx - i * ps, ps);
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const T* kr = k_head + base + size_t(j + u) * D;
      const T* vr = v_head + base + size_t(j + u) * D;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int d = lane + 32 * c;
        const bool ok = j + u < j1 && d < D;
        kd[u][c] = ok ? to_f(kr[d]) : 0.f;
        vd[u][c] = ok ? to_f(vr[d]) : 0.f;
      }
    }
  };
  int i = lo / ps + warp;
  int j = max(lo - i * ps, 0);
  if (i <= page_hi) load(i, j, kv, vv);
  while (i <= page_hi) {
    const int j1 = min(ctx - i * ps, ps);
    int ni = i, nj = j + kKeys;
    if (nj >= j1) {
      ni = i + kWarps;
      nj = max(lo - ni * ps, 0);
    }
    if (ni <= page_hi) load(ni, nj, kn, vn);
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      // predicated, not branched: a key past the chunk's end leaves the
      // state as it is (alpha 1, weight 0)
      const bool live = j + u < j1;
      // all GM rows, also the zero rows past G: no branch between the rows
      // keeps their shuffle chains free to overlap
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) s += qr[g][c] * kv[u][c];
        s = warp_sum(s) * scale;
        const float m_new = live ? fmaxf(m[g], s) : m[g];
        const float alpha = expf(m[g] - m_new);
        const float p = live ? expf(s - m_new) : 0.f;
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[g][c] = acc[g][c] * alpha + p * vv[u][c];
        m[g] = m_new;
      }
    }
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        kv[u][c] = kn[u][c];
        vv[u][c] = vn[u][c];
      }
    }
    i = ni;
    j = nj;
  }

  const int stride = D + 2;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    float* row = smem + (size_t(warp) * G + g) * stride;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = lane + 32 * c;
      if (d < D) row[d] = acc[g][c];
    }
    if (lane == 0) {
      row[D] = m[g];
      row[D + 1] = l[g];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D, d = e - g * D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, smem[(size_t(w) * G + g) * stride + D]);
    float sum = 0.f, val = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* row = smem + (size_t(w) * G + g) * stride;
      const float f = expf(row[D] - mx);
      sum += row[D + 1] * f;
      val += row[d] * f;
    }
    o[(size_t(b) * H + hk * G + g) * D + d] =
        from_f<T>(val / fmaxf(sum, 1e-30f));
  }
}

template <typename T, int GM, int C>
cudaError_t launch_one(dim3 grid, size_t smem, cudaStream_t stream,
                       const void* q, const void* kp, const void* vp,
                       const int* cl, const int* bt, void* o, int H, int HK,
                       int D, int P, int ps, int pps, float scale,
                       int window) {
  auto kern = paged_attention_kernel<T, GM, C>;
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), cl, bt, static_cast<T*>(o), H, HK, D, P, ps,
      pps, scale, window);
  return cudaGetLastError();
}

template <typename T, int GM>
cudaError_t launch_c(dim3 grid, size_t smem, cudaStream_t stream,
                     const void* q, const void* kp, const void* vp,
                     const int* cl, const int* bt, void* o, int H, int HK,
                     int D, int P, int ps, int pps, float scale, int window) {
#define PDT_PAGED_LAUNCH(C_)                                                \
  return launch_one<T, GM, C_>(grid, smem, stream, q, kp, vp, cl, bt, o, H, \
                               HK, D, P, ps, pps, scale, window)
  if (D <= 32) PDT_PAGED_LAUNCH(1);
  if (D <= 64) PDT_PAGED_LAUNCH(2);
  if (D <= 128) PDT_PAGED_LAUNCH(4);
  PDT_PAGED_LAUNCH(8);
#undef PDT_PAGED_LAUNCH
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* cl, const int* bt, void* o, int B, int H,
                   int HK, int D, int P, int ps, int pps, float scale,
                   int window, cudaStream_t stream) {
  const int G = H / HK;
  const size_t smem = size_t(kWarps) * G * (D + 2) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid(B, HK);
  if (G <= 4)
    return launch_c<T, 4>(grid, smem, stream, q, kp, vp, cl, bt, o, H, HK, D,
                          P, ps, pps, scale, window);
  if (G <= 8)
    return launch_c<T, 8>(grid, smem, stream, q, kp, vp, cl, bt, o, H, HK, D,
                          P, ps, pps, scale, window);
  return launch_c<T, 16>(grid, smem, stream, q, kp, vp, cl, bt, o, H, HK, D,
                         P, ps, pps, scale, window);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, o and the pages share it).
// window <= 0: no sliding window.
extern "C" int pdt_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages,
                                   const void* context_lens,
                                   const void* block_tables, void* o, int B,
                                   int H, int HK, int D, int P, int page_size,
                                   int pps, float scale, int window, int dtype,
                                   void* stream) {
  if (B <= 0 || HK <= 0) return 0;
  if (H % HK != 0 || H / HK > 16 || D <= 0 || D > 256 || page_size <= 0 ||
      pps <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cl = static_cast<const int*>(context_lens);
  const int* bt = static_cast<const int*>(block_tables);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pages, v_pages, cl, bt, o, B, H, HK, D, P,
                           page_size, pps, scale, window, s);
    case 1:
      return launch<__nv_bfloat16>(q, k_pages, v_pages, cl, bt, o, B, H, HK,
                                   D, P, page_size, pps, scale, window, s);
    case 2:
      return launch<__half>(q, k_pages, v_pages, cl, bt, o, B, H, HK, D, P,
                            page_size, pps, scale, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The split design (decode_attention.cuh), the ragged decode case with one
// row a sequence. rows_per_block, split_pages and n_splits: the wrapper's
// split plan (ops/ragged_paged_attention.py:split_plan); partials: its f32
// scratch (B, HK, n_splits, H / HK, D + 2) and tickets: B x HK int32
// counters, zero (the kernel leaves them zero), both null when n_splits is
// 1. dtype and window as pdt_paged_attention's.
extern "C" int pdt_paged_attention_split(
    const void* q, const void* k_pages, const void* v_pages,
    const void* context_lens, const void* block_tables, void* o,
    void* partials, void* tickets, int B, int H, int HK, int D, int P,
    int page_size,
    int pps, int rows_per_block, int split_pages, int n_splits, float scale,
    int window, int dtype, void* stream) {
  if (B <= 0 || HK <= 0) return 0;
  if (H % HK != 0 || H / HK > 16 || D <= 0 || D > 256 || page_size <= 0 ||
      pps <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const pdt_decode::Desc d{
      q, k_pages, v_pages, nullptr, nullptr, nullptr, nullptr,
      static_cast<const int*>(context_lens),
      static_cast<const int*>(block_tables), o,
      static_cast<float*>(partials), static_cast<int*>(tickets), B, H, HK, D,
      P, page_size, B, pps, 1, split_pages, n_splits, scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using pdt_decode::launch_split;
  switch (dtype) {
    case 0:
      return launch_split<float, float, false>(d, rows_per_block, false, s);
    case 1:
      return launch_split<__nv_bfloat16, __nv_bfloat16, false>(
          d, rows_per_block, false, s);
    case 2:
      return launch_split<__half, __half, false>(d, rows_per_block, false,
                                                 s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
