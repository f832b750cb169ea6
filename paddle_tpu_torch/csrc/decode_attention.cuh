// Decode attention over a block-table paged KV cache, split across blocks
// (flash-decoding), for Hopper (sm_90a). Shared by ragged_paged_attention.cu
// (the "split" design of ragged attention, full-width and int8 pages) and
// paged_attention.cu (the q = 1 case): one design, one copy of the device
// code.
//
// Replaces, in both sources' "split" entries:
// paddle_tpu/ops/ragged_paged_attention.py:_ragged_kernel (:293-363, both
// branches; pallas_call at :460) and paddle_tpu/ops/paged_attention.py:
// _paged_kernel (:53; pallas_call at :146). Semantics, as there: causal GQA
// (query head h reads KV head h / G), row j of sequence s at global position
// context_len[s] - query_len[s] + j sees keys [pos - window + 1, pos] (no
// lower end without a window); int8 pages carry one f32 dequant scale a page
// row, shared by the KV heads: the key-row scale multiplies logit j after
// the softmax scale, the value-row scale multiplies weight j, and the
// denominator sums the unscaled weights; out = acc / max(l, 1e-30), zero for
// padding rows and rows with no key. The paged case is the ragged decode
// case with one row a sequence (query_start null: q block b is sequence b).
//
// What bounds it on this card: bytes at decode, the knee at admission.
// A decode row reads each live K/V byte once for G query rows: ~G / 2
// operations a byte in bf16 (~1 at G 4), against the ~295 where the tensor
// cores become the limit, so the design's job is to keep enough bytes in
// flight on every SM. An admission q block (block_q 8, G 4: 32 rows) does 32
// rows of work a key byte, ~16-32 operations a byte: still below the knee,
// but past what CUDA cores sustain, so its products run on tensor cores.
//
// Design.
// - The grid is (q block, KV head x row group, split). A split is a run of
//   `split_pages` whole pages; the host sizes it from the block table's
//   width (the split plan, ops/ragged_paged_attention.py:split_plan) so that
//   the grid holds a few blocks an SM at full contexts. A block finds its
//   q block's owner and live keys from the descriptors (every warp alone,
//   with a ballot: no barrier) and exits at once when its split lies past
//   the causal frontier or wholly below the window.
// - A q block whose live keys fall in one split (or none) is written by that
//   split's block directly. Otherwise each live split writes its rows'
//   partial (m, l, acc) in f32 to a scratch the wrapper allocates and takes
//   a ticket (an atomic counter a (q block, KV head) in a buffer the
//   wrapper keeps zeroed); the last block to draw resets the counter and
//   combines the partials in split order (merge_if_last), so the result is
//   bitwise equal from run to run whichever block is last. No second
//   launch, and no float atomics.
// - Keys are staged in rings of shared memory, in the page's own type
//   (bf16, f16, int8 or f32). The CUDA-core kernel's rows go by the copy
//   engine (cp.async.bulk, credited to an mbarrier a stage): each run of
//   keys that lies in one page is one copy a pool, issued by one thread (a
//   first build gathered the rows 16 bytes a thread by cp.async, and the
//   address work of every thread then cost about as much as the compute).
//   The tensor-core kernel's rows, padded against bank conflicts, go by
//   cp.async, 16 bytes a thread. The split's block-table slice is read into
//   shared memory once. The next stages are in flight while the current one
//   is computed; one block barrier a stage.
// - Decode rows (block_q 1, all of paged attention, and f32 q at any
//   block_q): split_cc_kernel, on CUDA cores. A warp takes keys: a key row
//   is spread over LPR lanes, each holding a slice of 8 elements (4 in f32),
//   so a warp holds 32 / LPR keys at once; the block's query rows (up to RG
//   = 4 or 8, a row group; more rows take more row groups) are held in
//   registers, pre-scaled by scale * log2(e). Each logit is a shuffle sum
//   over the lanes of one key; each group of lanes keeps its own online
//   softmax state (m, l, acc), and the states are merged across the warp by
//   shuffles and across the warps in shared memory at the end. int8 pages
//   are widened in registers as they are used.
// - Admission rows (block_q > 1 in bf16 / f16, head dims 64, 128, 256):
//   split_tc_kernel, on tensor cores. Up to 64 rows (four m16 tiles) a
//   block; Q·Kᵀ and P·V with mma.sync m16n8k16 (the helpers of
//   flash_kernels.cuh) over stages of 32 keys in a ring of three, f32
//   accumulate; warps split the rows' m16 tiles and, where there are fewer
//   than four, take the 16-key chunks in turn. int8 pages are widened to the
//   q type as the fragments are loaded (exact for -127..127); the row
//   scales go by cp.async. P is rounded to the q type before P·V: the
//   JAX kernel keeps P in f32 (:335-359) and the plain version rounds it to
//   the cache's type (ops/ragged_paged_attention.py:masked_page_attention),
//   so the bf16 outputs differ from both by a few bf16 ulps (held to 2e-2
//   absolute at unit-variance inputs, as the other bf16 attention kernels).
//
// Exponentials are ex2.approx of log2-domain logits (q pre-scaled by
// scale * log2(e)); masked entries give p = 0 exactly.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "flash_kernels.cuh"
#include "sm90.cuh"

// Everything here has internal linkage: each source that includes this
// header builds its own shared library, and the launchers' static state
// (whether a kernel has opted in to its shared memory) must not be shared
// between the libraries through vague linkage.
namespace pdt_decode {
namespace {

using pdt_flash::Tc;
using pdt_sm90::mbar_expect_tx;
using pdt_sm90::mbar_init;
using pdt_sm90::mbar_wait;
using pdt_sm90::smem_addr;
using bf16 = __nv_bfloat16;
using f16 = __half;
using u16 = uint16_t;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;        // a block's, both kernels
constexpr int kThreads = 32 * kWarps;
constexpr int kStageKeys = 32;  // keys a stage, CUDA-core kernel
constexpr int kWarpKeys = kStageKeys / kWarps;  // a warp's keys a stage
// the CUDA-core ring: kMaxStages stages (cp_wait_n waits for up to 4)
// where they fit in kRingBytes, else as many as fit, at least 2
constexpr int kMaxStages = 4;
constexpr size_t kRingBytes = 52 * 1024;
constexpr int kTcKeys = 32;     // keys a stage, tensor-core kernel
constexpr int kTcStages = 3;
constexpr int kTcRows = 64;     // rows a block, tensor-core kernel
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's dynamic limit
constexpr size_t kBarBytes = 64;     // the CUDA-core ring's mbarriers

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(f16 v) { return __half2float(v); }
__device__ __forceinline__ float to_f(int8_t v) {
  return static_cast<float>(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ f16 from_f<f16>(float v) {
  return __float2half(v);
}

// 2^x by the special function unit (ex2.approx: ~2 ulp; -1e30 gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes (or 4: the scales) global -> shared, asynchronously; `pred`
// false writes zeros and reads nothing (`src` is then any valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait until at most n (0..kMaxStages - 2) of this thread's groups are
// pending
__device__ __forceinline__ void cp_wait_n(int n) {
  if (n <= 0)
    cp_wait<0>();
  else if (n == 1)
    cp_wait<1>();
  else
    cp_wait<2>();
}

// `bytes` (a multiple of 16) global -> shared by the copy engine, credited
// to the mbarrier `bar` (one thread issues it)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One launch's arguments. qstart null: the paged layout (q block b is
// sequence b, one row, at position context_len[b] - 1).
struct Desc {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ks;  // int8 pages: (P, ps) key / value dequant scales
  const float* vs;
  const int* qstart;
  const int* qlen;
  const int* ctxlen;
  const int* bt;
  void* o;
  float* part;  // (T / block_q, HK, n_splits, block_q * G, D + 2) f32
  int* tickets;  // (T / block_q, HK) counters, zero before and after
  int T, H, HK, D, P, ps, N, pps, block_q;
  int split_pages, n_splits;
  float scale;
  int window;  // <= 0: none
};

// A q block's owner and live keys, and the splits those keys fall in.
struct Span {
  int seq;      // owning sequence, -1 for a padding block
  int nrows;    // token rows it owns
  int first_q;  // global position of its token row 0
  int key_lo, key_hi;  // live keys [key_lo, key_hi]; empty: key_hi < key_lo
  int s_lo, s_hi;      // live splits; empty: s_hi < s_lo (then s_lo = 0)
};

// Every lane of the calling warp gets the same Span (the warp searches the
// descriptors with a ballot; a q block starts at most one sequence's rows,
// the first in order, as the serial kernel reads them).
__device__ __forceinline__ Span span_of(const Desc& d, int qb) {
  const int lane = threadIdx.x & 31;
  Span sp{-1, 0, 0, 0, -1, 0, -1};
  int qlen = 1, off = 0, ctx = 0;
  if (d.qstart == nullptr) {
    sp.seq = qb;
    ctx = __ldg(d.ctxlen + qb);
  } else {
    // each lane reads one sequence's three descriptors at once (one trip
    // to memory), and the owner's are passed round by shuffles
    const int row0 = qb * d.block_q;
    for (int base = 0; base < d.N; base += 32) {
      const int n = base + lane;
      int st = 0, ln = 0, cx = 0;
      if (n < d.N) {
        st = __ldg(d.qstart + n);
        ln = __ldg(d.qlen + n);
        cx = __ldg(d.ctxlen + n);
      }
      const unsigned m =
          __ballot_sync(0xffffffffu, n < d.N && row0 >= st && row0 < st + ln);
      if (m) {
        const int src = __ffs(m) - 1;
        sp.seq = base + src;
        qlen = __shfl_sync(0xffffffffu, ln, src);
        off = row0 - __shfl_sync(0xffffffffu, st, src);
        ctx = __shfl_sync(0xffffffffu, cx, src);
        break;
      }
    }
  }
  if (sp.seq >= 0) {
    sp.first_q = ctx - qlen + off;
    sp.nrows = min(d.block_q, qlen - off);
    sp.key_hi = min(sp.first_q + sp.nrows - 1, d.pps * d.ps - 1);
    if (d.window > 0) sp.key_lo = max(0, sp.first_q - d.window + 1);
  }
  if (sp.key_hi >= sp.key_lo) {
    const int spk = d.split_pages * d.ps;
    sp.s_lo = sp.key_lo / spk;
    sp.s_hi = sp.key_hi / spk;
  }
  return sp;
}

// Whether split `split` of this q block runs: the live splits, and split 0
// of a q block with none (it writes the zeros).
__device__ __forceinline__ bool split_runs(const Span& sp, int split) {
  return split >= sp.s_lo && split <= max(sp.s_hi, sp.s_lo);
}

// The pages of a block's keys: the block-table slice of its split, staged
// in shared memory once by `stage_pages` (a load of the table before each
// row's copy would put a trip to memory in front of every stage), and the
// page size as a shift where it is a power of two.
struct Pages {
  const int* bt;  // shared: entries pg0.. of the sequence's table row
  int pg0, ps, shift;
  __device__ __forceinline__ void locate(int kpos, int& page,
                                         int& slot) const {
    if (shift >= 0) {
      page = bt[(kpos >> shift) - pg0];
      slot = kpos & (ps - 1);
    } else {
      const int p = kpos / ps;
      page = bt[p - pg0];
      slot = kpos - p * ps;
    }
  }
};

// bytes of shared memory the slice takes: a split's pages
__host__ __device__ inline size_t pages_bytes(int split_pages) {
  return (size_t(split_pages) * sizeof(int) + 15) / 16 * 16;
}

// Stage the table entries of keys [kb, ke) (within one split) into bt_s;
// every thread of the block calls it (it ends in a barrier).
__device__ __forceinline__ Pages stage_pages(const Desc& d, const Span& sp,
                                             int kb, int ke, int* bt_s) {
  const int* bt_row = d.bt + size_t(sp.seq < 0 ? 0 : sp.seq) * d.pps;
  const int pg0 = kb / d.ps;
  const int n = ke > kb ? (ke - 1) / d.ps - pg0 + 1 : 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    bt_s[i] = __ldg(bt_row + pg0 + i);
  __syncthreads();
  const bool pow2 = (d.ps & (d.ps - 1)) == 0;
  return {bt_s, pg0, d.ps, pow2 ? __ffs(d.ps) - 1 : -1};
}

// The end of a split block: `st` holds n_parts partial states (acc[D], m,
// l; a row every D + 2 floats, part p's row r at (p * row_stride + r)) of
// the block's `rows` rows, which are rows r0.. of the q block. Combine the
// parts in order; then write the output in q's type (`direct`: this block
// owns the q block's only live split) or the partial state of this split.
template <typename T>
__device__ __forceinline__ void finish(const Desc& d, const float* st,
                                       int n_parts, int row_stride, int rows,
                                       int r0, int qb, int hk, int split,
                                       bool direct) {
  const int D = d.D, W = D + 2, G = d.H / d.HK, R = d.block_q * G;
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D, dd = e - r * D;
    if (r0 + r >= R) break;  // rows are in order: the rest are past R too
    float M = kNegInf;
    for (int p = 0; p < n_parts; ++p)
      M = fmaxf(M, st[(p * row_stride + r) * W + D]);
    float L = 0.f, A = 0.f;
    for (int p = 0; p < n_parts; ++p) {
      const float* s = st + (p * row_stride + r) * W;
      const float f = ex2(s[D] - M);
      L += s[D + 1] * f;
      A += s[dd] * f;
    }
    const int rr = r0 + r;
    if (direct) {
      const size_t t = size_t(qb) * d.block_q + rr / G;
      const int h = hk * G + rr % G;
      static_cast<T*>(d.o)[(t * d.H + h) * D + dd] =
          from_f<T>(M > 0.5f * kNegInf ? A / fmaxf(L, 1e-30f) : 0.f);
    } else {
      float* dst = d.part +
                   ((size_t(qb) * d.HK + hk) * d.n_splits + split) * R * W +
                   size_t(rr) * W;
      dst[dd] = A;
      if (dd == 0) {
        dst[D] = M;
        dst[D + 1] = L;
      }
    }
  }
}

// After a split block of a q block with several live splits has written its
// partial rows: it takes a ticket; the last of the q block's writers (its
// live splits x row groups) resets the counter and merges every row of the
// (q block, KV head) in split order, so the result is the same whichever
// block is last. A warp a row: the lanes read the splits' m and l side by
// side (through the L2: other SMs wrote them), the weights exp2(m_s - M) go
// to shared memory `ws` (2 x n_splits floats a warp), and each lane sums
// its columns over the splits, their loads issued together. Every thread
// of the block calls it.
template <typename T>
__device__ __forceinline__ void merge_if_last(const Desc& d, const Span& sp,
                                              int qb, int hk, int rgs,
                                              float* ws) {
  __shared__ int last;
  __threadfence();  // this block's partial rows, before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ticket = d.tickets + size_t(qb) * d.HK + hk;
    last = atomicAdd(ticket, 1) == (sp.s_hi - sp.s_lo + 1) * rgs - 1;
    if (last) *ticket = 0;  // every writer has drawn: ready for next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int G = d.H / d.HK, R = d.block_q * G, D = d.D, W = D + 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = sp.s_hi - sp.s_lo + 1;
  const size_t step = size_t(R) * W;  // one split to the next
  float* wt = ws + 2 * warp * d.n_splits;
  float* lt = wt + d.n_splits;
  for (int r = warp; r < R; r += blockDim.x >> 5) {
    const float* base =
        d.part + ((size_t(qb) * d.HK + hk) * d.n_splits + sp.s_lo) * step +
        size_t(r) * W;
    float M = kNegInf;
    for (int s = lane; s < n; s += 32) {
      wt[s] = __ldcg(base + s * step + D);
      lt[s] = __ldcg(base + s * step + D + 1);
      M = fmaxf(M, wt[s]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float L = 0.f;
    for (int s = lane; s < n; s += 32) {
      wt[s] = ex2(wt[s] - M);
      L += lt[s] * wt[s];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      L += __shfl_xor_sync(0xffffffffu, L, off);
    __syncwarp();
    const size_t tk = size_t(qb) * d.block_q + r / G;
    T* o = static_cast<T*>(d.o) + (tk * d.H + hk * G + r % G) * D;
    const float inv = M > 0.5f * kNegInf ? 1.f / fmaxf(L, 1e-30f) : 0.f;
    for (int dd = lane; dd < D; dd += 32) {
      float A = 0.f;
#pragma unroll 8
      for (int s = 0; s < n; ++s)
        A = fmaf(__ldcg(base + s * step + dd), wt[s], A);
      o[dd] = from_f<T>(A * inv);
    }
    __syncwarp();
  }
}

// bytes of the merge's weights (a warp's 2 x n_splits floats)
__host__ __device__ inline size_t merge_bytes(int warps, int n_splits) {
  return 2 * size_t(warps) * n_splits * sizeof(float);
}

// ---------------------------------------------------------------------------
// CUDA-core kernel: decode rows
// ---------------------------------------------------------------------------
// Lanes of a key row: the slice count ceil(D / E) rounded up to a power of
// two (E = elements a lane's slice), at least 4 and at most 32; past 32
// slices a lane holds NVL of them.
__host__ __device__ inline int cc_slices(int D, int E) { return (D + E - 1) / E; }
__host__ __device__ inline int cc_lanes(int D, int E) {
  const int n = cc_slices(D, E);
  int l = 4;  // at least 4: a warp takes at most kWarpKeys keys at once
  while (l < n && l < 32) l <<= 1;
  return l;
}
// bytes of a staged key row: the slices, rounded up to 16
__host__ __device__ inline int cc_row_bytes(int D, int E, int sz) {
  return (cc_slices(D, E) * E * sz + 15) / 16 * 16;
}
__host__ __device__ inline size_t cc_stage_bytes(int row_bytes) {
  // K rows, V rows, key and value row scales
  return 2 * size_t(kStageKeys) * row_bytes + 2 * kStageKeys * sizeof(float);
}

// Gather the live keys [k0, k0 + kStageKeys) ∩ [.., kend) of this block's
// sequence and KV head into a stage. `vec` (rows of whole 16-byte chunks at
// 16-byte-aligned pools): thread 0 copies each run of keys that lies in one
// page with one bulk copy per pool, credited to the stage's mbarrier `bar`
// (the other rows keep what they held: zeros or an earlier stage's keys,
// finite either way, and are masked); otherwise every thread copies element
// by element, synchronously (odd head dims), and thread 0 arrives on `bar`.
// The int8 pages' row scales go by cp.async, 4 bytes a thread, in the
// thread's cp.async group of this stage.
template <typename KV>
__device__ __forceinline__ void cc_stage(const Desc& d, const Pages& pg,
                                         int hk, int k0, int kend,
                                         unsigned char* stage, int rb,
                                         bool vec, uint32_t bar) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  const KV* kp = static_cast<const KV*>(d.kp);
  const KV* vp = static_cast<const KV*>(d.vp);
  unsigned char* ks_ = stage;
  unsigned char* vs_ = stage + kStageKeys * rb;
  const size_t head = size_t(hk) * d.P;
  const int hi = min(k0 + kStageKeys, kend);
  if (vec) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, hi > k0 ? uint32_t(2 * (hi - k0) * rb) : 0u);
      for (int kpos = k0; kpos < hi;) {
        int page, slot;
        pg.locate(kpos, page, slot);
        const int run = min(hi - kpos, d.ps - slot);
        const size_t row = ((head + page) * d.ps + slot) * d.D;
        const int at = (kpos - k0) * rb;
        bulk_copy(ks_ + at, kp + row, uint32_t(run * rb), bar);
        bulk_copy(vs_ + at, vp + row, uint32_t(run * rb), bar);
        kpos += run;
      }
    }
  } else {
    const int per_row = rb / int(sizeof(KV));
    for (int c = threadIdx.x; c < kStageKeys * per_row; c += blockDim.x) {
      const int j = c / per_row, x = c - j * per_row;
      const int kpos = k0 + j;
      KV kv = KV(0), vv = KV(0);
      if (kpos < kend && x < d.D) {
        int page, slot;
        pg.locate(kpos, page, slot);
        const size_t row = ((head + page) * d.ps + slot) * d.D;
        kv = kp[row + x];
        vv = vp[row + x];
      }
      reinterpret_cast<KV*>(ks_ + j * rb)[x] = kv;
      reinterpret_cast<KV*>(vs_ + j * rb)[x] = vv;
    }
    if (threadIdx.x == 0) pdt_sm90::mbar_arrive(bar);
  }
  if constexpr (kQuant) {
    float* kss = reinterpret_cast<float*>(stage + 2 * kStageKeys * rb);
    float* vss = kss + kStageKeys;
    for (int j = threadIdx.x; j < kStageKeys; j += blockDim.x) {
      const int kpos = k0 + j;
      const bool live = kpos < kend;
      size_t cell = 0;
      if (live) {
        int page, slot;
        pg.locate(kpos, page, slot);
        cell = size_t(page) * d.ps + slot;
      }
      cp_async4(kss + j, d.ks + cell, live);
      cp_async4(vss + j, d.vs + cell, live);
    }
  }
}

// E elements of a staged row at byte offset `at`, widened to f32
template <typename KV, int E>
__device__ __forceinline__ void cc_slice(const unsigned char* row, int at,
                                         float* f) {
  if constexpr (sizeof(KV) * E == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + at);
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) f[i] = to_f(e[i]);
  } else {  // int8: 8 bytes
    const uint2 raw = *reinterpret_cast<const uint2*>(row + at);
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) f[i] = to_f(e[i]);
  }
}

// T: q / o type; KV: page type; RG: rows a block (a row group); NVL: slices
// a lane (2 only for f32 rows past 128 elements)
template <typename T, typename KV, int RG, int NVL>
__global__ void __launch_bounds__(kThreads, RG <= 4 ? 3 : 2)
split_cc_kernel(const Desc d, int rgs, int n_stages) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int E = sizeof(KV) == 4 ? 4 : 8;
  extern __shared__ __align__(16) unsigned char da_smem[];
  const int qb = blockIdx.x, hk = blockIdx.y / rgs, rg = blockIdx.y % rgs;
  const int split = blockIdx.z;
  const int G = d.H / d.HK, R = d.block_q * G, D = d.D;
  const Span sp = span_of(d, qb);
  if (!split_runs(sp, split)) return;
  const bool direct = sp.s_hi <= sp.s_lo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // GS: steps whose logits a warp holds at once
  constexpr int GS = RG <= 4 ? 4 : 2;
  const int nvec = cc_slices(D, E), lpr = cc_lanes(D, E), kpw = 32 / lpr;
  const int steps = kWarpKeys / kpw;
  const int li = lane % lpr, slot = lane / lpr;
  const int rb = cc_row_bytes(D, E, sizeof(KV));
  const size_t stage_bytes = cc_stage_bytes(rb);
  const bool vec =
      (D * int(sizeof(KV))) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(d.kp) | reinterpret_cast<uintptr_t>(d.vp)) %
              16 == 0;

  // the block's rows, pre-scaled into the log2 domain
  const float qscale = d.scale * kLog2e;
  float q[RG][NVL][E], acc[RG][NVL][E], m[RG], l[RG];
  int qpos[RG];
  bool row_ok[RG];
#pragma unroll
  for (int g = 0; g < RG; ++g) {
    const int r = rg * RG + g, t = r / G;
    row_ok[g] = r < R && t < sp.nrows;
    qpos[g] = sp.first_q + t;
    const T* qr = static_cast<const T*>(d.q) +
                  ((size_t(qb) * d.block_q + t) * d.H + hk * G + r % G) * D;
#pragma unroll
    for (int c = 0; c < NVL; ++c) {
      const int vi = li + 32 * c;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int dd = vi * E + e;
        q[g][c][e] = row_ok[g] && vi < nvec && dd < D
                         ? to_f(qr[dd]) * qscale
                         : 0.f;
        acc[g][c][e] = 0.f;
      }
    }
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const int spk = d.split_pages * d.ps;
  const int kb = max(split * spk, sp.key_lo);
  const int ke = min((split + 1) * spk, sp.key_hi + 1);
  const int nst = ke > kb ? (ke - kb + kStageKeys - 1) / kStageKeys : 0;
  // shared memory: the stages' mbarriers, the split's table slice, then
  // the ring, zeroed once (the warps' states reuse all but the mbarriers at
  // the end)
  uint64_t* bars = reinterpret_cast<uint64_t*>(da_smem);
  unsigned char* body = da_smem + kBarBytes;
  unsigned char* ring = body + pages_bytes(d.split_pages);
  if (tid == 0) {
    for (int i = 0; i < n_stages; ++i) mbar_init(smem_addr(bars + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (size_t o = size_t(tid) * 16; o < n_stages * stage_bytes;
       o += size_t(blockDim.x) * 16)
    *reinterpret_cast<uint4*>(ring + o) = make_uint4(0, 0, 0, 0);
  // the zeros (generic proxy) before the copy engine's writes (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const Pages pg = stage_pages(d, sp, kb, ke, reinterpret_cast<int*>(body));

  for (int i = 0; i < n_stages - 1; ++i) {
    if (i < nst)
      cc_stage<KV>(d, pg, hk, kb + i * kStageKeys, ke,
                   ring + i * stage_bytes, rb, vec, smem_addr(bars + i));
    cp_commit();
  }
  for (int i = 0; i < nst; ++i) {
    mbar_wait(smem_addr(bars + i % n_stages), (i / n_stages) & 1);
    cp_wait_n(n_stages - 2);  // the stage's row scales (int8 pages)
    __syncthreads();  // stage i is in; every warp is done with stage i - 1
    {
      const int ni = i + n_stages - 1;
      if (ni < nst)
        cc_stage<KV>(d, pg, hk, kb + ni * kStageKeys, ke,
                     ring + (ni % n_stages) * stage_bytes, rb, vec,
                     smem_addr(bars + ni % n_stages));
      cp_commit();
    }
    const unsigned char* stage = ring + (i % n_stages) * stage_bytes;
    const unsigned char* krows = stage;
    const unsigned char* vrows = stage + kStageKeys * rb;
    const float* kss =
        reinterpret_cast<const float*>(stage + 2 * kStageKeys * rb);
    const float* vss = kss + kStageKeys;
    const int k0 = kb + i * kStageKeys;
    // every key of the stage live for every owned row: the rows' positions
    // run from first_q to first_q + nrows - 1
    const int k1 = k0 + kStageKeys - 1;
    const bool whole =
        k1 < ke && k1 <= sp.first_q &&
        (d.window <= 0 || k0 > sp.first_q + sp.nrows - 1 - d.window);
    // The warp's kWarpKeys keys of the stage, kpw at a time (a step), GS
    // steps at once: all their logits, then one softmax update, then the
    // weighted V rows; the GS x RG logits and their shuffle sums are
    // independent, so their latencies overlap.
    for (int s0 = 0; s0 < steps; s0 += GS) {
      float sv[GS][RG];
      int jr[GS];
#pragma unroll
      for (int u = 0; u < GS; ++u) {
        const int j = warp * kWarpKeys + (s0 + u) * kpw + slot;
        jr[u] = s0 + u < steps ? j : 0;
        float kf[NVL][E];
#pragma unroll
        for (int c = 0; c < NVL; ++c) {
          const int vi = li + 32 * c;
          if (vi < nvec) {
            cc_slice<KV, E>(krows + jr[u] * rb, vi * E * int(sizeof(KV)),
                            kf[c]);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) kf[c][e] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < RG; ++g) {
          float x = 0.f;
#pragma unroll
          for (int c = 0; c < NVL; ++c)
#pragma unroll
            for (int e = 0; e < E; ++e) x = fmaf(q[g][c][e], kf[c][e], x);
          sv[u][g] = x;
        }
      }
      for (int off = lpr >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < GS; ++u)
#pragma unroll
          for (int g = 0; g < RG; ++g)
            sv[u][g] += __shfl_xor_sync(0xffffffffu, sv[u][g], off);
      }
      // mask (predicated: a dead key leaves the state as it is; a stage
      // that every live row sees whole needs the row test only), the
      // key-row dequant, the rows' new maxima, then the weights: the
      // denominator sums them unscaled, the value-row dequant scales them
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < GS; ++u) {
          const int kpos = k0 + jr[u];
          const bool live =
              s0 + u < steps && row_ok[g] &&
              (whole || (kpos < ke && kpos <= qpos[g] &&
                         (d.window <= 0 || kpos > qpos[g] - d.window)));
          const float x = kQuant ? sv[u][g] * kss[jr[u]] : sv[u][g];
          sv[u][g] = live ? x : kNegInf;
          mx = fmaxf(mx, sv[u][g]);
        }
        const float alpha = ex2(m[g] - mx);
        m[g] = mx;
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < GS; ++u) {
          const float p =
              sv[u][g] > 0.5f * kNegInf ? ex2(sv[u][g] - mx) : 0.f;
          psum += p;
          sv[u][g] = kQuant ? p * vss[jr[u]] : p;
        }
        l[g] = l[g] * alpha + psum;
        // late in a walk the maxima rarely move: rescale only when one did
        if (__any_sync(0xffffffffu, alpha != 1.f)) {
#pragma unroll
          for (int c = 0; c < NVL; ++c)
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][c][e] *= alpha;
        }
      }
#pragma unroll
      for (int u = 0; u < GS; ++u) {
        float vf[NVL][E];
#pragma unroll
        for (int c = 0; c < NVL; ++c) {
          const int vi = li + 32 * c;
          if (vi < nvec) {
            cc_slice<KV, E>(vrows + jr[u] * rb, vi * E * int(sizeof(KV)),
                            vf[c]);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) vf[c][e] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < RG; ++g)
#pragma unroll
          for (int c = 0; c < NVL; ++c)
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[g][c][e] = fmaf(sv[u][g], vf[c][e], acc[g][c][e]);
      }
    }
  }

  // the warp's key slots into one state (butterfly: slot 0 ends with it)
  for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < RG; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = ex2(m[g] - mn), b = ex2(mo - mn);
      l[g] = l[g] * a + lo * b;
#pragma unroll
      for (int c = 0; c < NVL; ++c)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xo = __shfl_xor_sync(0xffffffffu, acc[g][c][e], off);
          acc[g][c][e] = acc[g][c][e] * a + xo * b;
        }
      m[g] = mn;
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: the warps' states go there
  float* st = reinterpret_cast<float*>(body);
  const int W = D + 2;
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < RG; ++g) {
      float* row = st + (warp * RG + g) * W;
#pragma unroll
      for (int c = 0; c < NVL; ++c) {
        const int vi = li + 32 * c;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int dd = vi * E + e;
          if (vi < nvec && dd < D) row[dd] = acc[g][c][e];
        }
      }
      if (li == 0) {
        row[D] = m[g];
        row[D + 1] = l[g];
      }
    }
  }
  __syncthreads();
  finish<T>(d, st, kWarps, RG, RG, rg * RG, qb, hk, split, direct);
  if (!direct) merge_if_last<T>(d, sp, qb, hk, rgs, st);
}

// ---------------------------------------------------------------------------
// tensor-core kernel: admission rows (bf16 / f16 q, block_q > 1)
// ---------------------------------------------------------------------------
template <typename KV, int DP>
struct TcGeom {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kLdQ = DP + 8;  // 16-bit elements
  // elements of a staged K / V row: 16 bytes of padding against bank
  // conflicts of the fragment loads
  static constexpr int kLdKV = DP + 16 / int(sizeof(KV));
  static constexpr int kRowBytes = kLdKV * int(sizeof(KV));
  static constexpr size_t kQBytes = size_t(kTcRows) * kLdQ * 2;
  static constexpr size_t kStageBytes =
      2 * size_t(kTcKeys) * kRowBytes + 2 * kTcKeys * sizeof(float);
  static constexpr size_t kStateBytes = size_t(kTcRows) * (DP + 2) * 4;
  static size_t smem(int split_pages) {
    const size_t ring =
        pages_bytes(split_pages) + kQBytes + kTcStages * kStageBytes;
    return ring > kStateBytes ? ring : kStateBytes;
  }
};

// two int8 at p (consecutive) as a pair of T
template <typename T>
__device__ __forceinline__ uint32_t i8_pair(const int8_t* p) {
  return Tc<T>::pack(float(p[0]), float(p[1]));
}

// Gather the keys [k0, k0 + kTcKeys) into a stage's padded rows by
// cp.async, 16 bytes a thread (rows at or past kend zero), and the int8
// pages' row scales, 4 bytes a thread: one cp.async group a stage. (Bulk
// copies a row, issued by one warp, were slower here: 64 small copies a
// stage.)
template <typename KV, int DP>
__device__ __forceinline__ void tc_stage(const Desc& d, const Pages& pg,
                                         int hk, int k0, int kend,
                                         unsigned char* stage) {
  using Geo = TcGeom<KV, DP>;
  const KV* kp = static_cast<const KV*>(d.kp);
  const KV* vp = static_cast<const KV*>(d.vp);
  unsigned char* ks_ = stage;
  unsigned char* vs_ = stage + kTcKeys * Geo::kRowBytes;
  constexpr int kChunks = DP * int(sizeof(KV)) / 16;
  const size_t head = size_t(hk) * d.P;
  for (int c = threadIdx.x; c < kTcKeys * kChunks; c += kThreads) {
    const int j = c / kChunks, col = c - j * kChunks;
    const int kpos = k0 + j;
    const bool live = kpos < kend;
    size_t row = 0;
    if (live) {
      int page, slot;
      pg.locate(kpos, page, slot);
      row = ((head + page) * d.ps + slot) * DP;
    }
    cp_async16(ks_ + j * Geo::kRowBytes + col * 16,
               reinterpret_cast<const unsigned char*>(kp + row) + col * 16,
               live);
    cp_async16(vs_ + j * Geo::kRowBytes + col * 16,
               reinterpret_cast<const unsigned char*>(vp + row) + col * 16,
               live);
  }
  if constexpr (Geo::kQuant) {
    float* kss = reinterpret_cast<float*>(stage + 2 * kTcKeys * Geo::kRowBytes);
    float* vss = kss + kTcKeys;
    for (int j = threadIdx.x; j < kTcKeys; j += kThreads) {
      const int kpos = k0 + j;
      const bool live = kpos < kend;
      size_t cell = 0;
      if (live) {
        int page, slot;
        pg.locate(kpos, page, slot);
        cell = size_t(page) * d.ps + slot;
      }
      cp_async4(kss + j, d.ks + cell, live);
      cp_async4(vss + j, d.vs + cell, live);
    }
  }
}

template <typename T, typename KV, int DP>
__global__ void __launch_bounds__(kThreads, DP <= 128 ? 3 : 1)
split_tc_kernel(const Desc d, int rgs) {
  using Geo = TcGeom<KV, DP>;
  constexpr bool kQuant = Geo::kQuant;
  constexpr int LQ = Geo::kLdQ, LKV = Geo::kLdKV, ND = DP / 8;
  // shared memory: the split's table slice, Q, then the ring (the warps'
  // states reuse it all at the end)
  extern __shared__ __align__(16) unsigned char da_smem[];
  unsigned char* body = da_smem;
  u16* q_s = reinterpret_cast<u16*>(body + pages_bytes(d.split_pages));
  unsigned char* ring = body + pages_bytes(d.split_pages) + Geo::kQBytes;
  const int qb = blockIdx.x, hk = blockIdx.y / rgs, rg = blockIdx.y % rgs;
  const int split = blockIdx.z;
  const int G = d.H / d.HK, R = d.block_q * G;
  const Span sp = span_of(d, qb);
  if (!split_runs(sp, split)) return;
  const bool direct = sp.s_hi <= sp.s_lo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = rg * kTcRows, rows = min(R - r0, kTcRows);
  const int MT = (rows + 15) / 16;               // m16 tiles: 1..4
  const int KP = MT == 1 ? 4 : MT == 2 ? 2 : 1;  // warps sharing a tile
  const int mt = warp % MT, kp = warp / MT;
  const bool active = warp < MT * KP;

  // Q rows r0.. of the q block (zero past R and on unowned tokens)
  {
    constexpr int kChunks = DP / 8;
    const T* q = static_cast<const T*>(d.q);
    for (int c = tid; c < kTcRows * kChunks; c += kThreads) {
      const int r = c / kChunks, col = c - r * kChunks;
      const int rr = r0 + r, tk = rr / G;
      const bool ok = rr < R && tk < sp.nrows;
      const T* src =
          ok ? q + ((size_t(qb) * d.block_q + tk) * d.H + hk * G + rr % G) *
                       DP + col * 8
             : q;
      cp_async16(q_s + r * LQ + col * 8, src, ok);
    }
  }
  const int spk = d.split_pages * d.ps;
  const int kb = max(split * spk, sp.key_lo);
  const int ke = min((split + 1) * spk, sp.key_hi + 1);
  const int nst = ke > kb ? (ke - kb + kTcKeys - 1) / kTcKeys : 0;
  const Pages pg = stage_pages(d, sp, kb, ke, reinterpret_cast<int*>(body));

  // this thread's two rows (g and g + 8 of its m16 tile)
  int qpos[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + mt * 16 + g + 8 * h;
    row_ok[h] = active && rr < R && rr / G < sp.nrows;
    qpos[h] = sp.first_q + rr / G;
  }
  const float qscale = d.scale * kLog2e;
  float o[ND][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  // the Q rows ride in the first group, with stage 0
  for (int i = 0; i < kTcStages - 1; ++i) {
    if (i < nst)
      tc_stage<KV, DP>(d, pg, hk, kb + i * kTcKeys, ke,
                       ring + i * Geo::kStageBytes);
    cp_commit();
  }
  constexpr int kChunks = kTcKeys / 16;
  for (int i = 0; i < nst; ++i) {
    cp_wait<kTcStages - 2>();
    __syncthreads();  // stage i (and Q) in; every warp done with stage i - 1
    {
      const int ni = i + kTcStages - 1;
      if (ni < nst)
        tc_stage<KV, DP>(d, pg, hk, kb + ni * kTcKeys, ke,
                         ring + (ni % kTcStages) * Geo::kStageBytes);
      cp_commit();
    }
    if (!active) continue;
    const unsigned char* stage = ring + (i % kTcStages) * Geo::kStageBytes;
    const KV* K_s = reinterpret_cast<const KV*>(stage);
    const KV* V_s =
        reinterpret_cast<const KV*>(stage + kTcKeys * Geo::kRowBytes);
    const float* kss =
        reinterpret_cast<const float*>(stage + 2 * kTcKeys * Geo::kRowBytes);
    const float* vss = kss + kTcKeys;
    const int k0 = kb + i * kTcKeys;
    const int k1 = k0 + kTcKeys - 1;
    const bool whole =
        k1 < ke && k1 <= sp.first_q &&
        (d.window <= 0 || k0 > sp.first_q + sp.nrows - 1 - d.window);
    // the 16-key chunks of this stage that this warp owns: chunk c of
    // stage i when (i * kChunks + c) % KP == kp, so the KP warps of a row
    // tile take the chunks in turn across stages
    bool own[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) own[c] = (i * kChunks + c) % KP == kp;

    // S = Q Kᵀ over the owned chunks, the even and odd k steps summed
    // apart (two chains of products in flight, not one)
    float s[kChunks][2][4], s2[kChunks][2][4];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][n][e] = s2[c][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      pdt_flash::load_a(a, q_s, LQ, mt * 16, kk * 16, g, t);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (!own[c]) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t b[2];
          const int key = c * 16 + n * 8 + g;
          if constexpr (kQuant) {
            const int8_t* p = K_s + key * LKV + kk * 16 + 2 * t;
            b[0] = i8_pair<T>(p);
            b[1] = i8_pair<T>(p + 8);
          } else {
            pdt_flash::load_b(b, reinterpret_cast<const u16*>(K_s), LKV,
                              c * 16 + n * 8, kk * 16, g, t);
          }
          Tc<T>::mma(kk & 1 ? s2[c][n] : s[c][n], a, b);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][n][e] += s2[c][n][e];
    // mask and scale into the log2 domain; the rows' maxima
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (!own[c]) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, j = c * 16 + n * 8 + 2 * t + (e & 1);
          const int key = k0 + j;
          const bool live =
              row_ok[h] &&
              (whole || (key < ke && key <= qpos[h] &&
                         (d.window <= 0 || key > qpos[h] - d.window)));
          float x = s[c][n][e] * qscale;
          if (kQuant) x *= kss[j];  // key-row dequant, after the scale
          s[c][n][e] = live ? x : kNegInf;
          mx[h] = fmaxf(mx[h], s[c][n][e]);
        }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      alpha[h] = ex2(m[h] - mn);
      m[h] = mn;
      l[h] *= alpha[h];
    }
    // the accumulator rescaled only when a row's maximum moved (warp-
    // uniform test; late in a long walk the maxima rarely move)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (!own[c]) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float x = s[c][n][e];
          const float p = x > 0.5f * kNegInf ? ex2(x - m[h]) : 0.f;
          l[h] += p;  // the denominator sums the unscaled weights
          s[c][n][e] =
              kQuant ? p * vss[c * 16 + n * 8 + 2 * t + (e & 1)] : p;
        }
      // O += P V over this chunk's 16 keys (P rounded to T)
      uint32_t a[4];
      pdt_flash::acc_to_a<T>(a, s[c], 0);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b[2];
        if constexpr (kQuant) {
          const int8_t* p = V_s + (c * 16 + 2 * t) * LKV + n * 8 + g;
          const int8_t lo0[2] = {p[0], p[LKV]};
          const int8_t lo1[2] = {p[8 * LKV], p[9 * LKV]};
          b[0] = i8_pair<T>(lo0);
          b[1] = i8_pair<T>(lo1);
        } else {
          pdt_flash::load_b_trans(b, reinterpret_cast<const u16*>(V_s), LKV,
                                  n * 8, c * 16, lane);
        }
        Tc<T>::mma(o[n], a, b);
      }
    }
  }

  cp_wait<0>();
  __syncthreads();  // Q and the ring are free: the warps' states go there
  float* st = reinterpret_cast<float*>(body);
  const int W = DP + 2, stride = MT * 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = st + (kp * stride + mt * 16 + g + 8 * h) * W;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        row[n * 8 + 2 * t] = o[n][2 * h];
        row[n * 8 + 2 * t + 1] = o[n][2 * h + 1];
      }
      if (t == 0) {
        row[DP] = m[h];
        row[DP + 1] = l[h];
      }
    }
  }
  __syncthreads();
  finish<T>(d, st, KP, stride, rows, r0, qb, hk, split, direct);
  if (!direct) merge_if_last<T>(d, sp, qb, hk, rgs, st);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t opt_in(Kernel kern, size_t smem, size_t& opted) {
  if (smem <= opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess) opted = smem;
  return err;
}

template <typename T, typename KV, int RG, int NVL>
cudaError_t launch_cc(const Desc& d, int rgs, dim3 grid, cudaStream_t s) {
  constexpr int E = sizeof(KV) == 4 ? 4 : 8;
  const size_t stage = cc_stage_bytes(cc_row_bytes(d.D, E, sizeof(KV)));
  const int fit = int(kRingBytes / stage);
  const int n_stages =
      fit >= kMaxStages ? kMaxStages : fit >= 2 ? fit : 2;
  size_t state = size_t(kWarps) * RG * (d.D + 2) * sizeof(float);
  if (merge_bytes(kWarps, d.n_splits) > state)
    state = merge_bytes(kWarps, d.n_splits);
  const size_t ring = pages_bytes(d.split_pages) + n_stages * stage;
  const size_t smem = kBarBytes + (ring > state ? ring : state);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = split_cc_kernel<T, KV, RG, NVL>;
  static size_t opted = 48 * 1024;
  cudaError_t err = opt_in(kern, smem, opted);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, s>>>(d, rgs, n_stages);
  return cudaGetLastError();
}

template <typename T, typename KV, int DP>
cudaError_t launch_tc_dp(const Desc& d, int rgs, dim3 grid, cudaStream_t s) {
  size_t smem = TcGeom<KV, DP>::smem(d.split_pages);
  if (merge_bytes(kWarps, d.n_splits) > smem)
    smem = merge_bytes(kWarps, d.n_splits);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = split_tc_kernel<T, KV, DP>;
  static size_t opted = 48 * 1024;
  cudaError_t err = opt_in(kern, smem, opted);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, s>>>(d, rgs);
  return cudaGetLastError();
}

// rows_per_block: 4 or 8 (CUDA-core kernel), kTcRows (tensor cores);
// kTc: whether this source builds the tensor-core kernel
template <typename T, typename KV, bool kTc>
cudaError_t launch_split(const Desc& d, int rows_per_block, bool tc,
                         cudaStream_t s) {
  if (d.T <= 0 || d.HK <= 0) return cudaSuccess;
  if (d.block_q <= 0 || d.T % d.block_q != 0 || d.H % d.HK != 0 ||
      d.D <= 0 || d.D > 256 || d.ps <= 0 || d.pps <= 0 ||
      d.split_pages <= 0 || d.n_splits <= 0 ||
      size_t(d.split_pages) * d.n_splits < size_t(d.pps) ||
      (d.n_splits > 1 && (d.part == nullptr || d.tickets == nullptr)))
    return cudaErrorInvalidValue;
  const int R = d.block_q * (d.H / d.HK);
  const int rgs = (R + rows_per_block - 1) / rows_per_block;
  const dim3 grid(d.T / d.block_q, d.HK * rgs, d.n_splits);
  cudaError_t err = cudaErrorInvalidValue;
  if (tc) {
    if constexpr (kTc && !std::is_same<T, float>::value) {
      if (rows_per_block != kTcRows ||
          reinterpret_cast<uintptr_t>(d.q) % 16 != 0 ||
          (reinterpret_cast<uintptr_t>(d.kp) |
           reinterpret_cast<uintptr_t>(d.vp)) % 16 != 0)
        return cudaErrorInvalidValue;
      if (d.D == 64)
        err = launch_tc_dp<T, KV, 64>(d, rgs, grid, s);
      else if (d.D == 128)
        err = launch_tc_dp<T, KV, 128>(d, rgs, grid, s);
      else if (d.D == 256)
        err = launch_tc_dp<T, KV, 256>(d, rgs, grid, s);
    }
  } else {
    // two slices a lane only for f32 rows past 128 elements (8-element
    // slices cover 256 in 32 lanes)
    bool two = false;
    if constexpr (sizeof(KV) == 4) {
      two = cc_slices(d.D, 4) > 32;
      if (two && rows_per_block == 4)
        err = launch_cc<T, KV, 4, 2>(d, rgs, grid, s);
      else if (two && rows_per_block == 8)
        err = launch_cc<T, KV, 8, 2>(d, rgs, grid, s);
    }
    if (!two && rows_per_block == 4)
      err = launch_cc<T, KV, 4, 1>(d, rgs, grid, s);
    else if (!two && rows_per_block == 8)
      err = launch_cc<T, KV, 8, 1>(d, rgs, grid, s);
  }
  return err;
}

}  // namespace
}  // namespace pdt_decode
