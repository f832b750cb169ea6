// Flash attention for Hopper (sm_90a): the forward (o and the row
// log-sum-exp), the dQ backward and the dK/dV backward of GQA attention with
// an end-aligned causal mask and an optional sliding window.
//
// Replaces: paddle_tpu/ops/flash_attention.py:_fwd_kernel (:127, launched by
// _flash_fwd, pallas_call at :190), _bwd_dq_kernel (:223, pallas_call at
// :333) and _bwd_dkv_kernel (:270, pallas_call at :361). The backward of
// bf16 and f16 at head dims 64 and 128 runs the wgmma kernels of
// flash_bwd_sm90.cu instead; the entries here take every input all the
// same.
//
// The kernels live in flash_kernels.cuh (shared with flash_varlen.cu, which
// adds a segment mask); this file instantiates them without segments. What
// bounds them, their tiles, precisions and head dims are described there.
//
// C interface: device pointers on the caller's current stream; each entry
// returns cudaGetLastError() after its launch.

#include "flash_kernels.cuh"

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, dO and the
// outputs share it); window <= 0: no window (a window needs causal). Any
// head dim up to 256.
extern "C" int pdt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int Sq, int Sk, int H,
                             int HK, int D, float scale, int causal,
                             int window, int dtype, void* stream) {
  return pdt_flash::run_fwd<false>(q, k, v, nullptr, nullptr, o, lse, B, Sq,
                                   Sk, H, HK, D, scale, causal, window,
                                   dtype, stream);
}

extern "C" int pdt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int Sq,
                                int Sk, int H, int HK, int D, float scale,
                                int causal, int window, int dtype,
                                void* stream) {
  return pdt_flash::run_dq<false>(q, k, v, dout, lse, delta, nullptr,
                                  nullptr, dq, B, Sq, Sk, H, HK, D, scale,
                                  causal, window, dtype, stream);
}

extern "C" int pdt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int B, int Sq, int Sk, int H, int HK, int D,
                                 float scale, int causal, int window,
                                 int dtype, void* stream) {
  return pdt_flash::run_dkv<false>(q, k, v, dout, lse, delta, nullptr,
                                   nullptr, dk, dv, B, Sq, Sk, H, HK, D,
                                   scale, causal, window, dtype, stream);
}
