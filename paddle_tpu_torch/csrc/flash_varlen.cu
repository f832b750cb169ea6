// Packed (varlen) flash attention for Hopper (sm_90a): the forward (o and
// the row log-sum-exp), the dQ backward and the dK/dV backward of GQA
// attention confined to pairs of one segment, with an optional global
// end-aligned causal mask.
//
// Replaces: paddle_tpu/ops/flash_varlen.py:_fwd_kernel (:60, pallas_call
// at :212), _bwd_dq_kernel (:106, pallas_call at :254) and _bwd_dkv_kernel
// (:149, pallas_call at :285), for every input the wgmma / TMA kernels of
// flash_varlen_sm90.cu do not take (bf16 and f16 at head dims 64 and 128
// go there: ops/flash_varlen.py `varlen_design`).
//
// The kernels are those of flash_kernels.cuh with the segment mask on:
// q row i and key j pair only if seg_q[i] == seg_k[j] >= 0 (and, causal,
// i + Sk - Sq >= j). Padding rows (id -1) write o = 0, lse -1e30 and zero
// dQ; a key of id -1 gets zero dK and dV. Tiles whose segment ranges do not
// meet are skipped (flash_kernels.cuh, "Segments"), so a packed batch costs
// about the sum of its documents' attention, not the whole S x S band.
//
// C interface: device pointers on the caller's current stream; segment ids
// are (B, Sq) and (B, Sk) int32; each entry returns cudaGetLastError()
// after its launch.

#include "flash_kernels.cuh"

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Any head dim up to 256.
extern "C" int pdt_varlen_fwd(const void* q, const void* k, const void* v,
                              const void* seg_q, const void* seg_k, void* o,
                              void* lse, int B, int Sq, int Sk, int H,
                              int HK, int D, float scale, int causal,
                              int dtype, void* stream) {
  return pdt_flash::run_fwd<true>(q, k, v, seg_q, seg_k, o, lse, B, Sq, Sk,
                                  H, HK, D, scale, causal, 0, dtype, stream);
}

extern "C" int pdt_varlen_bwd_dq(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 const void* seg_q, const void* seg_k,
                                 void* dq, int B, int Sq, int Sk, int H,
                                 int HK, int D, float scale, int causal,
                                 int dtype, void* stream) {
  return pdt_flash::run_dq<true>(q, k, v, dout, lse, delta, seg_q, seg_k, dq,
                                 B, Sq, Sk, H, HK, D, scale, causal, 0,
                                 dtype, stream);
}

extern "C" int pdt_varlen_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* seg_q, const void* seg_k,
                                  void* dk, void* dv, int B, int Sq, int Sk,
                                  int H, int HK, int D, float scale,
                                  int causal, int dtype, void* stream) {
  return pdt_flash::run_dkv<true>(q, k, v, dout, lse, delta, seg_q, seg_k,
                                  dk, dv, B, Sq, Sk, H, HK, D, scale, causal,
                                  0, dtype, stream);
}
