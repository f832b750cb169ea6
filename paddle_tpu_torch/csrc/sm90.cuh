// Hopper (sm_90a) building blocks of the wgmma / TMA kernels
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu, grouped_matmul.cu,
// dequant_matmul.cu): mbarriers,
// TMA tile loads, warpgroup matrix multiplies (wgmma) on shared-memory
// descriptors of 128-byte-swizzled tiles, the register layout of a wgmma
// accumulator, and the driver's tensor-map encoder reached through the
// runtime (no -lcuda).
//
// Tiles, as TMA lays them with the 128-byte swizzle: boxes of 64 rows x 64
// 16-bit columns (128 bytes a row, 8-row atoms of 1024 bytes, kBox bytes a
// box). A tile of R rows (R a multiple of 64) and C columns is C / 64
// chunks of R x 64, `chunk` = R x 128 bytes apart; within a chunk the
// boxes of 64 rows follow each other, so the 8-row atoms of all R rows are
// 1024 bytes apart. Such a tile is read by wgmma
// - K-major (the product reduces along the columns): k step kk (16
//   columns) starts 32 bytes into its chunk's 128-byte rows;
// - MN-major (the product reduces along the rows, N runs along the
//   columns, the descriptor's transpose bit): k step kk (16 rows) starts
//   2048 bytes down, and the next 64 columns are one chunk on.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pdt_sm90 {

using bf16 = __nv_bfloat16;
using f16 = __half;
using u16 = uint16_t;  // a bf16 or f16 element in memory

constexpr int kBox = 8192;  // bytes of a 64 x 64 box of 16-bit elements

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a tensor map at the given coordinates (innermost first) into
// shared memory at `dst`, its bytes credited to `bar`; the box's elements
// past the tensor's edge are zero
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N of this warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wg_wait_all() { wg_wait<0>(); }

// Pins registers at this point of the program: after wg_wait, the
// compiler reads no accumulator before it; before wg_fence, every write of
// an accumulator or an A fragment by other instructions (a rescale, a
// zeroing, a conversion) is done before the fence, which orders them
// before the next wgmma (the compiler would be free to sink them past it).
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}

// The descriptor of k step kk of a tile is the tile's plus a constant (the
// start address field holds all of shared memory, so the sum never carries
// out of it). K-major read: chunk kk / 4, 32 bytes a k step within it.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk,
                                                int chunk = kBox) {
  return make_desc(tile, 16, 1024) +
         uint64_t(((kk >> 2) * chunk + (kk & 3) * 32) >> 4);
}

// MN-major read: k step kk is 16 rows, 2048 bytes down; N's next 64
// columns are one chunk on.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk,
                                                 int chunk = kBox) {
  return make_desc(tile, chunk, 1024) + uint64_t(kk * 2048 >> 4);
}

// the accumulator registers of m64nN, N / 2 of them
#define PDT_D64  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define PDT_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63}"
#define PDT_D256 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define PDT_R8(C, i)                                                      \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), \
      C(d[i + 6]), C(d[i + 7])
#define PDT_R32(C) PDT_R8(C, 0), PDT_R8(C, 8), PDT_R8(C, 16), PDT_R8(C, 24)
#define PDT_R64(C) PDT_R32(C), PDT_R8(C, 32), PDT_R8(C, 40), PDT_R8(C, 48), \
                   PDT_R8(C, 56)
#define PDT_R128(C) PDT_R64(C), PDT_R8(C, 64), PDT_R8(C, 72), \
                    PDT_R8(C, 80), PDT_R8(C, 88), PDT_R8(C, 96),  \
                    PDT_R8(C, 104), PDT_R8(C, 112), PDT_R8(C, 120)

// A and B from shared memory: operands after the accumulators are A's and
// B's descriptors, scale-d (0 writes d, 1 adds to it), B's transpose bit
#define PDT_SS(TY, N, IA, IB, IS, IT, OUTS)                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"          \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
               " " PDT_D##N ", %" IA ", %" IB ", p, 1, 1, 0, %" IT ";\n}\n" \
               : OUTS                                                     \
               : "l"(a), "l"(b), "r"(ACC), "n"(TB))
// A in four registers (the fragment of mma.m16n8k16's A), B from shared
// memory
#define PDT_RS(TY, N, A0, A1, A2, A3, IB, IS, IT, OUTS)                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"          \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
               " " PDT_D##N ", {%" A0 ", %" A1 ", %" A2 ", %" A3 "}, %" IB  \
               ", p, 1, 1, %" IT ";\n}\n"                                  \
               : OUTS                                                     \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),     \
                 "r"(ACC), "n"(TB))

template <typename T>
struct Wg;

// d (N / 2 f32 a thread) = or += A . B over one k step of 16: A 64 x 16, B
// 16 x N; TB = 1 reads B MN-major, 0 K-major; ACC = 0 writes d without
// reading it
#define PDT_WG(CT, TY)                                                      \
  template <>                                                               \
  struct Wg<CT> {                                                           \
    template <int N, int TB, int ACC>                                       \
    static __device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t a, \
                                              uint64_t b) {                 \
      if constexpr (N == 64) {                                              \
        if constexpr (ACC)                                                  \
          PDT_SS(TY, 64, "32", "33", "34", "35", PDT_R32("+f"));           \
        else                                                                \
          PDT_SS(TY, 64, "32", "33", "34", "35", PDT_R32("=f"));           \
      } else if constexpr (N == 128) {                                      \
        if constexpr (ACC)                                                  \
          PDT_SS(TY, 128, "64", "65", "66", "67", PDT_R64("+f"));          \
        else                                                                \
          PDT_SS(TY, 128, "64", "65", "66", "67", PDT_R64("=f"));          \
      } else {                                                              \
        static_assert(N == 256, "m64n64, m64n128 or m64n256");             \
        if constexpr (ACC)                                                  \
          PDT_SS(TY, 256, "128", "129", "130", "131", PDT_R128("+f"));     \
        else                                                                \
          PDT_SS(TY, 256, "128", "129", "130", "131", PDT_R128("=f"));     \
      }                                                                     \
    }                                                                       \
    template <int N, int TB, int ACC>                                       \
    static __device__ __forceinline__ void rs(float (&d)[N / 2],            \
                                              const uint32_t (&a)[4],       \
                                              uint64_t b) {                 \
      if constexpr (N == 64) {                                              \
        if constexpr (ACC)                                                  \
          PDT_RS(TY, 64, "32", "33", "34", "35", "36", "37", "38",         \
                 PDT_R32("+f"));                                            \
        else                                                                \
          PDT_RS(TY, 64, "32", "33", "34", "35", "36", "37", "38",         \
                 PDT_R32("=f"));                                            \
      } else if constexpr (N == 128) {                                      \
        if constexpr (ACC)                                                  \
          PDT_RS(TY, 128, "64", "65", "66", "67", "68", "69", "70",        \
                 PDT_R64("+f"));                                            \
        else                                                                \
          PDT_RS(TY, 128, "64", "65", "66", "67", "68", "69", "70",        \
                 PDT_R64("=f"));                                            \
      } else {                                                              \
        static_assert(N == 256, "m64n64, m64n128 or m64n256");             \
        if constexpr (ACC)                                                  \
          PDT_RS(TY, 256, "128", "129", "130", "131", "132", "133", "134", \
                 PDT_R128("+f"));                                           \
        else                                                                \
          PDT_RS(TY, 256, "128", "129", "130", "131", "132", "133", "134", \
                 PDT_R128("=f"));                                           \
      }                                                                     \
    }                                                                       \
  };

PDT_WG(bf16, "bf16")
PDT_WG(f16, "f16")
#undef PDT_WG
#undef PDT_SS
#undef PDT_RS

// the wgmma products, T = bf16 or f16 (ACC = 1 adds to d)
template <typename T, int N, int TB, int ACC = 1>
__device__ __forceinline__ void wg_ss(float (&d)[N / 2], uint64_t a,
                                      uint64_t b) {
  Wg<T>::template ss<N, TB, ACC>(d, a, b);
}

template <typename T, int N, int TB, int ACC = 1>
__device__ __forceinline__ void wg_rs(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t b) {
  Wg<T>::template rs<N, TB, ACC>(d, a, b);
}

// ---------------------------------------------------------------------------
// accumulator registers
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<f16>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u);

template <>
__device__ __forceinline__ float2 unpack2<bf16>(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

template <>
__device__ __forceinline__ float2 unpack2<f16>(uint32_t u) {
  return __half22float2(*reinterpret_cast<__half2*>(&u));
}

// The register A fragments of the KS 16-wide k steps of a 64 x 16KS f32
// accumulator, rounded to T. Accumulator element i of a thread (lane: g =
// lane / 4, t = lane % 4) is row g + 8 ((i >> 1) & 1) of its warp's 16,
// column 8 (i >> 2) + 2t + (i & 1); the A fragment of k step kk takes
// columns 16kk.. in the order of mma.m16n8k16's.
template <typename T, int KS>
__device__ __forceinline__ void to_a(uint32_t (&a)[KS][4],
                                     const float (&c)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack2<T>(c[8 * kk + 2 * j], c[8 * kk + 2 * j + 1]);
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, reached through the runtime (no
// -lcuda); null when the driver has none
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of a tensor of element type `type` and `rank` dims, innermost
// first, `strides` the byte strides of dims 1.., boxes of `box` elements,
// the given swizzle, zero fill past the edges. False when the driver
// refuses it.
inline bool make_map(CUtensorMap* map, const void* ptr, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box, CUtensorMapDataType type,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map of a 16-bit tensor (dtype 1 = bf16, 2 = f16), 128-byte swizzle
// (the box's inner dim is 64 elements).
inline bool make_tiled_map(CUtensorMap* map, const void* ptr, int rank,
                           const cuuint64_t* dims, const cuuint64_t* strides,
                           const cuuint32_t* box, int dtype) {
  return make_map(map, ptr, rank, dims, strides, box,
                  dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                             : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

// Binds the current thread to the primary context of the device that holds
// `ptr`, as the driver's tensor-map encoder needs: a thread whose first CUDA
// call this entry makes (autograd's device thread, when the backward is the
// first work it launches) has no current context, and the encoder then
// refused valid maps. False when `ptr` is not a device pointer.
inline bool bind_device(const void* ptr) {
  cudaPointerAttributes a;
  if (cudaPointerGetAttributes(&a, ptr) != cudaSuccess ||
      a.type != cudaMemoryTypeDevice) {
    cudaGetLastError();
    return false;
  }
  return cudaSetDevice(a.device) == cudaSuccess;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace pdt_sm90
