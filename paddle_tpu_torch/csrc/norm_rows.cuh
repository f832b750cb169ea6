// Parts shared by the RMSNorm and LayerNorm forwards (rms_norm.cu,
// layer_norm.cu): element conversions, 16-byte vectors, and the
// register-row design.
//
// The register-row design. A row of h elements is nvec = h / V vectors of
// 16 bytes (V = 4 for f32, 8 for bf16 and f16). It is spread over the TPR =
// 32 * WPR lanes of WPR warps: lane t holds vectors t, t + TPR, t + 2 TPR,
// ... (NV slots, the ones past nvec masked), so neighbouring lanes read
// neighbouring addresses and no lane holds more than one vector more than
// another. Each lane loads its vectors once into registers, raw; every
// statistic and the output come from those registers, so device memory is
// read once and written once. w (and b) are loaded the same way by each
// row's lanes (from L2, or L1 for the block's other rows). A row's sums go
// through warp shuffles; with WPR > 1 each warp then leaves its sum in
// shared memory and the row's warps alone meet at a named barrier (no
// __syncthreads): the sum over the warps is taken in warp order, so it is
// the same on every run. (WPR, NV) come from the caller
// (`ops.norm_kernels.row_class`); the entries refuse a pair that does not
// cover the row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// VEC elements of T make one 16-byte access
template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

// the f32 values of a raw 16-byte vector of T
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* f) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) f[i] = to_f(e[i]);
}

// f32 values rounded to T, as one raw 16-byte vector
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) e[i] = from_f<T>(f[i]);
  return raw;
}

// one 16-byte load into a register copy (unpacking through a reference
// to memory would load the elements one by one)
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  unpack<T>(raw, f);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = pack<T>(f);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// -- the register-row design --------------------------------------------------

// threads a block launches at most: four warps' worth of rows (a row a warp
// at WPR 1, two rows at WPR 2, one at WPR 4, the widest class); the shared
// scratch of the row sums holds one float a warp
constexpr int kRowBlock = 128;

// lane t's NV vectors of a row that starts at p; a masked slot holds zeros
template <int NV, int TPR>
__device__ __forceinline__ void load_row(uint4 (&v)[NV],
                                         const uint4* __restrict__ p, int t,
                                         int nvec) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = j * TPR + t;
    v[j] = i < nvec ? __ldg(p + i) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// An empty asm that claims to change v: the compiler keeps the raw vectors
// in registers and unpacks them where they are used, rather than holding
// their f32 values (twice the registers for bf16 / f16) across a
// reduction (close to half the registers for bf16 rows); the registers
// saved are blocks on the SM, and bytes in flight.
template <int NV>
__device__ __forceinline__ void keep_raw(uint4 (&v)[NV]) {
#pragma unroll
  for (int j = 0; j < NV; ++j)
    asm volatile("" : "+r"(v[j].x), "+r"(v[j].y), "+r"(v[j].z), "+r"(v[j].w));
}

// the row's sum of v, in every lane of the row's WPR warps; `red` holds
// kRowBlock / 32 floats of shared scratch, one use per row.
template <int WPR>
__device__ __forceinline__ float row_sum(float v, float* red, int group) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if constexpr (WPR == 1) {
    return v;
  } else {
    const int warp = (threadIdx.x >> 5) % WPR;
    if ((threadIdx.x & 31) == 0) red[group * WPR + warp] = v;
    // barrier 1 + group: only this row's 32 * WPR threads meet there
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(32 * WPR)
                 : "memory");
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < WPR; ++i) s += red[group * WPR + i];
    return s;
  }
}

struct RowGrid {
  int blocks, threads;
};

// The launch shape of a register-row kernel over n rows: every row group
// a block of its own, the hardware handing the next block to whichever SM
// frees a slot. Rows share a block of kRowBlock threads, unless the rows
// would then not fill the SMs (the decode step's 8 rows): then each row
// gets a block of its own, 8 blocks on 8 SMs rather than 4 blocks of two
// rows. (Fewer blocks walking the rows in a grid-stride loop, w and b held
// across their rows, measured slower on the H100 at every main-path
// shape: the SMs' slots empty out before the loop ends.)
template <int WPR>
RowGrid row_grid(int n, int sms) {
  int groups = kRowBlock / (32 * WPR);
  if ((n + groups - 1) / groups < sms) groups = 1;
  return {(n + groups - 1) / groups, 32 * WPR * groups};
}

inline int sm_count(int device) {
  static int cache[64];  // 0: not read yet
  int v = 0;
  if (device >= 0 && device < 64 && cache[device]) return cache[device];
  cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device);
  if (device >= 0 && device < 64) cache[device] = v;
  return v > 0 ? v : 1;
}

// Makes `device` current for the launch and puts the caller's device back
// after it, calling cudaSetDevice only when they differ (autograd's device
// thread may start with no current device of its own).
struct DeviceScope {
  int prev = -1, want = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) : want(device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != want) err = cudaSetDevice(want);
  }
  ~DeviceScope() {
    if (prev >= 0 && prev != want) cudaSetDevice(prev);
  }
};

}  // namespace
