// Ragged paged attention for Hopper (sm_90a): causal GQA attention for a
// packed ragged token axis (decode rows, full prefills, chunk continuations)
// over a block-table paged KV cache, with an optional sliding window.
//
// Replaces: paddle_tpu/ops/ragged_paged_attention.py:_ragged_kernel, both
// branches: full-width pages and quantized int8 pages (quantized=True,
// :296-309, :341-343, :358); launched by _ragged_pallas, pallas_call at :460.
//
// Layout (the JAX package's, unchanged): q and o are (T, H, D); k/v pages
// are (HK, P, page_size, D); query_start / query_len / context_len are (N,)
// int32; block_tables is (N, pps) int32. Row j of sequence s sits at global
// position context_len[s] - query_len[s] + j. Rows that no sequence owns,
// and rows with no valid key, are written as zeros.
//
// Design. The TPU kernel walks a grid of (q block, kv head, page) in order
// and carries the online-softmax state across the page axis in VMEM. Blocks
// on Hopper run in no order, so the page axis becomes a loop inside one
// thread block: one block per (q block, kv head). The block finds its
// owning sequence from the descriptors itself (starts are block_q-aligned,
// so a q block has at most one owner), then walks only the LIVE pages of
// that sequence — from the first page inside the window to the page of its
// last row's causal frontier — so dead pages cost neither loads nor math.
// Each K/V page tile (16 x 128 bf16 = 4 KB at the defaults) is staged in
// shared memory as f32; the block_q*G query rows of the block (4 at decode,
// 32 at admission for G = 4) share it, which is what GQA buys: one KV read
// for G query heads. Running max, sum and the output accumulator stay in
// shared memory in f32 for the whole walk; the output leaves once, as
// acc / l in q's type.
//
// What bounds it on this card: bytes. At decode every live K/V byte is read
// once for 4 query rows (about 1 flop per byte), far below the ~295 flop
// per byte where H100 tensor cores become the limit. This first version
// computes on the CUDA cores and does not overlap a page's load with the
// previous page's math, so it runs well below the memory bound when few
// blocks are in flight (decode: N x HK blocks). Splitting long contexts
// across blocks, cp.async/TMA double buffering and wgmma for admission
// tiles are later changes.
//
// Quantized pages. int8 pools carry two (P, page_size) f32 scale pools, one
// DEQUANT multiplier per page row, shared by the KV heads (written by
// ragged_scatter_quantized). The kernel is templated on the page type apart
// from q's: an int8 page is widened to f32 while it is staged (16 values a
// 16-byte load, sign-extended), the key-row scale multiplies logit column j
// after the softmax scale, and the value-row scale multiplies weight column
// j before p @ v; the denominator l sums the unscaled weights, as the TPU
// kernel does. Page bytes halve against bf16, which is what bounds decode.
// Dead pages are still never read, so trash page 0's scales never reach a
// live row.
//
// C interface: device pointers on the caller's stream; the entry returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic limit

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(int8_t v) {
  return static_cast<float>(v);  // int8_t is signed: sign-extends
}
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

template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) f[i] = to_f(e[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// floats of dynamic shared memory one block needs
__host__ __device__ inline size_t smem_floats(int R, int D, int ps) {
  // q tile + accumulator (R x D), K tile (ps x (D+1), padded against bank
  // conflicts), V tile (ps x D), scores / weights (R x ps), m, l, alpha,
  // and the page's key / value row scales (2 x ps; unused when unquantized)
  return 2 * size_t(R) * D + size_t(ps) * (D + 1) + size_t(ps) * D +
         size_t(R) * ps + 3 * size_t(R) + 2 * size_t(ps);
}

// T: q / o type; KV: page type (T, or int8_t with scale pools ks / vs)
template <typename T, typename KV, bool kVec>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(
    const T* __restrict__ q, const KV* __restrict__ kp,
    const KV* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ qstart,
    const int* __restrict__ qlen, const int* __restrict__ ctxlen,
    const int* __restrict__ bt, T* __restrict__ o, int H, int HK, int D,
    int P, int ps, int N, int pps, int block_q, float scale, int window) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  extern __shared__ float smem[];
  __shared__ int owner;
  const int G = H / HK;
  const int R = block_q * G;
  const int Dp = D + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.y;
  const int row0 = blockIdx.x * block_q;

  float* q_s = smem;
  float* acc_s = q_s + R * D;
  float* k_s = acc_s + R * D;
  float* v_s = k_s + ps * Dp;
  float* p_s = v_s + ps * D;
  float* m_s = p_s + R * ps;
  float* l_s = m_s + R;
  float* a_s = l_s + R;
  float* ks_s = a_s + R;
  float* vs_s = ks_s + ps;

  // the owning sequence of this q block (-1: a padding block)
  if (tid == 0) {
    int s = -1;
    for (int n = 0; n < N; ++n) {
      if (row0 >= qstart[n] && row0 < qstart[n] + qlen[n]) {
        s = n;
        break;
      }
    }
    owner = s;
  }
  __syncthreads();
  const int s = owner;
  int nrows = 0, first_q = 0, page_lo = 0, page_hi = -1;
  if (s >= 0) {
    const int off = row0 - qstart[s];
    first_q = ctxlen[s] - qlen[s] + off;  // global position of row 0
    nrows = min(block_q, qlen[s] - off);  // owned rows of this block
    const int last_q = first_q + nrows - 1;
    if (last_q >= 0) page_hi = min(last_q / ps, pps - 1);
    if (window > 0) {
      const int lo_key = first_q - window + 1;  // first key any row sees
      if (lo_key > 0) page_lo = lo_key / ps;
    }
  }

  // block row r is (token row0 + r / G, query head hk * G + r % G)
  for (int e = tid; e < R * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const size_t t = row0 + r / G;
    const int h = hk * G + r % G;
    q_s[e] = r / G < nrows ? to_f(q[(t * H + h) * D + d]) : 0.f;
    acc_s[e] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int* bt_row = bt + size_t(s < 0 ? 0 : s) * pps;
  for (int i = page_lo; i <= page_hi; ++i) {
    const size_t base = (size_t(hk) * P + bt_row[i]) * ps * D;
    if constexpr (kQuant) {
      for (int j = tid; j < ps; j += kThreads) {
        ks_s[j] = ks[size_t(bt_row[i]) * ps + j];
        vs_s[j] = vs[size_t(bt_row[i]) * ps + j];
      }
    }
    if constexpr (kVec) {
      constexpr int V = Vec<KV>::n;
      float fk[V], fv[V];
      for (int e = tid * V; e < ps * D; e += kThreads * V) {
        load_vec(kp + base + e, fk);
        load_vec(vp + base + e, fv);
        const int j = e / D, d = e - j * D;  // D % V == 0: one row
#pragma unroll
        for (int x = 0; x < V; ++x) {
          k_s[j * Dp + d + x] = fk[x];
          v_s[e + x] = fv[x];
        }
      }
    } else {
      for (int e = tid; e < ps * D; e += kThreads) {
        const int j = e / D, d = e - j * D;
        k_s[j * Dp + d] = to_f(kp[base + e]);
        v_s[e] = to_f(vp[base + e]);
      }
    }
    __syncthreads();

    // masked, scaled logits of this page
    for (int e = tid; e < R * ps; e += kThreads) {
      const int r = e / ps, j = e - r * ps;
      const int qpos = first_q + r / G, kpos = i * ps + j;
      const bool valid = r / G < nrows && kpos <= qpos &&
                         (window <= 0 || kpos > qpos - window);
      float sim = kNegInf;
      if (valid) {
        const float* qr = q_s + r * D;
        const float* kr = k_s + j * Dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        sim = dot * scale;
        if constexpr (kQuant) sim *= ks_s[j];  // key-row dequant
      }
      p_s[e] = sim;
    }
    __syncthreads();

    // online softmax update, one warp per row
    for (int r = warp; r < R; r += kThreads / 32) {
      float mx = kNegInf;
      for (int j = lane; j < ps; j += 32) mx = fmaxf(mx, p_s[r * ps + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < ps; j += 32) {
        const float sv = p_s[r * ps + j];
        const float pv = sv > kNegInf * 0.5f ? expf(sv - m_new) : 0.f;
        // value-row dequant scales the weights, not the denominator
        p_s[r * ps + j] = kQuant ? pv * vs_s[j] : pv;
        sum += pv;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
      }
    }
    __syncthreads();

    for (int e = tid; e < R * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      const float* pr = p_s + r * ps;
      float a = acc_s[e] * a_s[r];
      for (int j = 0; j < ps; ++j) a += pr[j] * v_s[j * D + d];
      acc_s[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < R * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const size_t t = row0 + r / G;
    const int h = hk * G + r % G;
    const float val = m_s[r] > kNegInf * 0.5f
                          ? acc_s[e] / fmaxf(l_s[r], 1e-30f)
                          : 0.f;
    o[(t * H + h) * D + d] = from_f<T>(val);
  }
}

template <typename T, typename KV, bool kVec>
cudaError_t launch_one(dim3 grid, size_t smem, cudaStream_t stream,
                       const void* q, const void* kp, const void* vp,
                       const float* ks, const float* vs, const int* qs,
                       const int* ql, const int* cl, const int* bt, void* o,
                       int H, int HK, int D, int P, int ps, int N, int pps,
                       int block_q, float scale, int window) {
  auto kern = ragged_paged_attention_kernel<T, KV, kVec>;
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), ks, vs, qs, ql, cl, bt, static_cast<T*>(o),
      H, HK, D, P, ps, N, pps, block_q, scale, window);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* qs,
                   const int* ql, const int* cl, const int* bt, void* o,
                   int T_, int H, int HK, int D, int P, int ps, int N,
                   int pps, int block_q, float scale, int window,
                   cudaStream_t stream) {
  const int R = block_q * (H / HK);
  const size_t smem = smem_floats(R, D, ps) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid(T_ / block_q, HK);
  constexpr int V = Vec<KV>::n;
  const bool vec = D % V == 0 &&
                   reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  if (vec)
    return launch_one<T, KV, true>(grid, smem, stream, q, kp, vp, ks, vs, qs,
                                   ql, cl, bt, o, H, HK, D, P, ps, N, pps,
                                   block_q, scale, window);
  return launch_one<T, KV, false>(grid, smem, stream, q, kp, vp, ks, vs, qs,
                                  ql, cl, bt, o, H, HK, D, P, ps, N, pps,
                                  block_q, scale, window);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q and o share it).
// k_scale / v_scale: null for full-width pages, which then share q's dtype;
// both non-null for int8 pages, each a (P, page_size) f32 pool. window <= 0:
// no sliding window.
extern "C" int pdt_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale,
    const void* query_start, const void* query_len, const void* context_len,
    const void* block_tables, void* o, int T, int H, int HK, int D, int P,
    int page_size, int N, int pps, int block_q, float scale, int window,
    int dtype, void* stream) {
  if (T <= 0 || HK <= 0) return 0;
  if (block_q <= 0 || T % block_q != 0 || H % HK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qs = static_cast<const int*>(query_start);
  const int* ql = static_cast<const int*>(query_len);
  const int* cl = static_cast<const int*>(context_len);
  const int* bt = static_cast<const int*>(block_tables);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if ((ks == nullptr) != (vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool quant = ks != nullptr;
  switch (dtype * 2 + quant) {
    case 0:
      return launch<float, float>(q, k_pages, v_pages, ks, vs, qs, ql, cl,
                                  bt, o, T, H, HK, D, P, page_size, N, pps,
                                  block_q, scale, window, s);
    case 1:
      return launch<float, int8_t>(q, k_pages, v_pages, ks, vs, qs, ql, cl,
                                   bt, o, T, H, HK, D, P, page_size, N, pps,
                                   block_q, scale, window, s);
    case 2:
      return launch<__nv_bfloat16, __nv_bfloat16>(
          q, k_pages, v_pages, ks, vs, qs, ql, cl, bt, o, T, H, HK, D, P,
          page_size, N, pps, block_q, scale, window, s);
    case 3:
      return launch<__nv_bfloat16, int8_t>(
          q, k_pages, v_pages, ks, vs, qs, ql, cl, bt, o, T, H, HK, D, P,
          page_size, N, pps, block_q, scale, window, s);
    case 4:
      return launch<__half, __half>(
          q, k_pages, v_pages, ks, vs, qs, ql, cl, bt, o, T, H, HK, D, P,
          page_size, N, pps, block_q, scale, window, s);
    case 5:
      return launch<__half, int8_t>(
          q, k_pages, v_pages, ks, vs, qs, ql, cl, bt, o, T, H, HK, D, P,
          page_size, N, pps, block_q, scale, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
