"""Packed (varlen) flash attention: hand-written CUDA kernels beside their
plain version.

≙ `paddle_tpu/ops/flash_varlen.py` :47-57 (`_mask`), :60-299 (the three
Pallas kernels and their launchers), :305-337 (the `_varlen` custom
VJP), :346-367 (`_varlen_xla`), :370-394 (`flash_attention_varlen_values`)
and :410-416 (`segments_from_cu_seqlens`).

Several sequences packed into one (B, S) buffer: q (B, Sq, H, D), k and v
(B, Sk, HK, D) with H a multiple of HK, and int32 segment ids seg_q
(B, Sq) and seg_k (B, Sk), -1 marking padding. q row i and key j pair
only if seg_q[i] == seg_k[j] and seg_q[i] >= 0; ``causal`` adds GLOBAL
end-aligned order, i + Sk - Sq >= j (per-segment order when q and k share
one packing). A row with no key outputs 0 with lse -1e30 and zero
gradient. The scale defaults to 1/sqrt(D).

The kernels (`csrc/flash_varlen.cu`, built from the flash kernels of
`csrc/flash_kernels.cuh` with the segment mask on) read the (B, S, H, D)
tensors in place and skip every (q tile, key tile) pair whose segment
ranges do not meet. `_FlashVarlenFn` is the custom VJP: its forward saves
(q, k, v, o, lse) beside the segment ids, which get no gradient; its
backward computes delta = rowsum(o * dO) in f32 outside the kernels, as
JAX does, and runs the dQ and dK/dV kernels. On the CPU the same function
runs the plain versions, which keep the Pallas kernels' precisions
(`ops.flash_attention.attend_ref` / `attend_bwd_ref` under the segment
mask). There is no counterpart of the TPU's unaligned fallback
(``sq % block_q``, ``sk % block_k``): the kernels take any length and mask
the tails, and head dims as the dense kernels (`MAX_HEAD_DIM`). A head
dim past it takes `varlen_xla` on either device, as the reference's
``d <= 256`` test sends it to `_varlen_xla`.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import kernel_route, launch_counts
from .flash_attention import (_DTYPES, NEG_INF, _aligned, _check, _delta,
                              _heads_first, attend_bwd_ref, attend_ref,
                              takes_head_dim)

_DIMS = [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 2 \
    + [ctypes.c_void_p]
# pdt_varlen_fwd(q, k, v, seg_q, seg_k, o, lse, B, Sq, Sk, H, HK, D, scale,
#                causal, dtype, stream)
_FWD_ARGTYPES = [ctypes.c_void_p] * 7 + _DIMS
# pdt_varlen_bwd_dq(q, k, v, dO, lse, delta, seg_q, seg_k, dq, ...)
_DQ_ARGTYPES = [ctypes.c_void_p] * 9 + _DIMS
# pdt_varlen_bwd_dkv(q, k, v, dO, lse, delta, seg_q, seg_k, dk, dv, ...)
_DKV_ARGTYPES = [ctypes.c_void_p] * 10 + _DIMS


def segments_from_cu_seqlens(cu_seqlens, total_len, device=None
                             ) -> torch.Tensor:
    """Cumulative offsets (N + 1,) to (total_len,) int32 segment ids:
    position p gets the n with cu[n] <= p < cu[n + 1], and positions at
    or past cu[-1] get -1 (padding)."""
    cu = torch.as_tensor(np.asarray(cu_seqlens) if not isinstance(
        cu_seqlens, torch.Tensor) else cu_seqlens).to(torch.int64)
    if device is not None:
        cu = cu.to(device)
    pos = torch.arange(total_len, device=cu.device)
    seg = (pos[:, None] >= cu[None, 1:-1]).sum(1)
    return torch.where(pos < cu[-1], seg, -1).to(torch.int32)


def _live(seg_q, seg_k, causal):
    """(B, 1, Sq, Sk) bool: may q row i attend key j (≙ `_mask`)."""
    sq, sk = seg_q.shape[1], seg_k.shape[1]
    live = (seg_q[:, :, None] == seg_k[:, None, :]) & \
        (seg_q[:, :, None] >= 0)
    if causal:
        i = torch.arange(sq, device=seg_q.device)[:, None] + (sk - sq)
        live &= i >= torch.arange(sk, device=seg_q.device)[None, :]
    return live[:, None]


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def flash_attention_varlen_ref(q, k, v, seg_q, seg_k, causal=False,
                               scale=None):
    """Plain PyTorch forward: ``(o (B, Sq, H, D) in q's dtype, lse (B, H,
    Sq) f32)``, with the precisions of the JAX `_fwd_kernel`: scores in
    f32, softmax weights cast to v's dtype for the weighted sum, rows
    with no live key 0 and lse -1e30."""
    return attend_ref(q, k, v, _live(seg_q, seg_k, causal), _scale(q, scale))


def flash_attention_varlen_bwd_ref(q, k, v, o, lse, do, seg_q, seg_k,
                                   causal=False, scale=None):
    """Plain PyTorch backward from the saved lse: ``(dq, dk, dv)`` in the
    inputs' dtypes, dk and dv summed over each KV head's query heads, with
    the precisions of `_bwd_dq_kernel` (dP in f32, dS cast to k's dtype
    for dS.K) and `_bwd_dkv_kernel` (P, dO, dS and q in f32)."""
    return attend_bwd_ref(q, k, v, o, lse, do, _live(seg_q, seg_k, causal),
                          _scale(q, scale))


def varlen_xla(q, k, v, seg_q, seg_k, scale, causal=False):
    """≙ `_varlen_xla`, the reference's non-Pallas branch: f32 logits
    (products of the inputs, summed in f32) times ``scale``, the segment
    (and causal) mask at NEG_INF, a softmax in f32, rows with no live key
    0, weights cast to v's dtype for the weighted sum. Plain PyTorch,
    differentiable by autograd, on either device."""
    qh, kh, vh = _heads_first(q, k, v)
    live = _live(seg_q, seg_k, causal)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    p = torch.softmax(s.masked_fill(~live, NEG_INF), dim=-1)
    p = torch.where(live.any(-1, keepdim=True), p, 0.0).to(v.dtype)
    return torch.matmul(p, vh).transpose(1, 2)


def _dims(q, k, scale, causal):
    b, sq, h, d = q.shape
    return (b, sq, k.shape[1], h, k.shape[2], d, float(scale), int(causal),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)


def _launch(symbol, argtypes, ptrs, dims, device, count):
    from ._build import kernel_fn
    fn = kernel_fn("flash_varlen", symbol, argtypes)
    with torch.cuda.device(device):
        err = fn(*ptrs, *dims)
    if err:
        raise RuntimeError(f"varlen flash kernel {symbol} launch failed: "
                           f"CUDA error {err}")
    launch_counts[count] += 1


def _check_seg(q, k, seg_q, seg_k):
    for seg, n in ((seg_q, q.shape[1]), (seg_k, k.shape[1])):
        if seg.dtype != torch.int32 or seg.shape != (q.shape[0], n) or \
                seg.device != q.device or not seg.is_contiguous():
            raise ValueError(f"varlen kernels want contiguous int32 segment "
                             f"ids of shape ({q.shape[0]}, {n}) on q's "
                             f"device; got {seg.dtype} {tuple(seg.shape)}")


def _varlen_fwd(q, k, v, seg_q, seg_k, scale, causal):
    """The forward kernel on contiguous tensors: (o, lse (B, H, Sq))."""
    _check(q, k, v)
    _check_seg(q, k, seg_q, seg_k)
    b, sq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    _launch("pdt_varlen_fwd", _FWD_ARGTYPES,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(),
             seg_k.data_ptr(), o.data_ptr(), lse.data_ptr()),
            _dims(q, k, scale, causal), q.device, "flash_varlen_fwd")
    return o, lse


def _varlen_bwd_dq(q, k, v, do, lse, delta, seg_q, seg_k, scale, causal):
    """The dQ kernel: dq in q's dtype."""
    _check(q, k, v)
    _check_seg(q, k, seg_q, seg_k)
    dq = torch.empty_like(q)
    _launch("pdt_varlen_bwd_dq", _DQ_ARGTYPES,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), seg_q.data_ptr(),
             seg_k.data_ptr(), dq.data_ptr()),
            _dims(q, k, scale, causal), q.device, "flash_varlen_bwd_dq")
    return dq


def _varlen_bwd_dkv(q, k, v, do, lse, delta, seg_q, seg_k, scale, causal):
    """The dK/dV kernel: (dk, dv), each summed over the query heads of its
    KV head, deterministic."""
    _check(q, k, v)
    _check_seg(q, k, seg_q, seg_k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("pdt_varlen_bwd_dkv", _DKV_ARGTYPES,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), seg_q.data_ptr(),
             seg_k.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            _dims(q, k, scale, causal), q.device, "flash_varlen_bwd_dkv")
    return dk, dv


def _varlen_bwd(q, k, v, o, lse, do, seg_q, seg_k, scale, causal):
    """delta = rowsum(o * dO) in f32, then the dQ and dK/dV kernels."""
    delta = _delta(o, do)
    dq = _varlen_bwd_dq(q, k, v, do, lse, delta, seg_q, seg_k, scale,
                        causal)
    return (dq, *_varlen_bwd_dkv(q, k, v, do, lse, delta, seg_q, seg_k,
                                 scale, causal))


class _FlashVarlenFn(torch.autograd.Function):
    """≙ the `_varlen` custom VJP: forward saves (q, k, v, o, lse) and the
    segment ids (non-differentiable); the backward recomputes P from lse.
    ``kernel`` picks the CUDA kernels or the plain versions for both
    directions."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, scale, causal, kernel):
        if kernel:
            o, lse = _varlen_fwd(q, k, v, seg_q, seg_k, scale, causal)
        else:
            o, lse = flash_attention_varlen_ref(q, k, v, seg_q, seg_k,
                                                causal, scale)
        ctx.save_for_backward(q, k, v, o, lse, seg_q, seg_k)
        ctx.args = (scale, causal, kernel)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg_q, seg_k = ctx.saved_tensors
        scale, causal, kernel = ctx.args
        if kernel:
            dq, dk, dv = _varlen_bwd(q, k, v, o, lse, _aligned(do), seg_q,
                                     seg_k, scale, causal)
        else:
            dq, dk, dv = flash_attention_varlen_bwd_ref(
                q, k, v, o, lse, do, seg_q, seg_k, causal, scale)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_varlen_values(q, k, v, seg_q, seg_k, causal=False,
                                  scale=None, use_kernel=None):
    """Packed attention of (B, Sq, H, D) queries over (B, Sk, HK, D) keys
    and values under (B, Sq) / (B, Sk) segment ids (-1: padding),
    differentiable in q, k and v. A CUDA tensor goes through the kernels,
    forward and backward; a CPU tensor, or ``use_kernel=False``, through
    the plain versions. ``use_kernel`` as in `ops.kernel_route`. A head
    dim past `MAX_HEAD_DIM` takes `varlen_xla` on either device."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, Sq, H, D) and k, v (B, Sk, HK, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of HK)")
    seg_q = torch.as_tensor(seg_q, device=q.device).to(torch.int32)
    seg_k = torch.as_tensor(seg_k, device=q.device).to(torch.int32)
    if seg_q.shape != (b, sq) or seg_k.shape != (b, k.shape[1]):
        raise ValueError(f"segment ids {tuple(seg_q.shape)} / "
                         f"{tuple(seg_k.shape)} do not fit q "
                         f"{tuple(q.shape)} and k {tuple(k.shape)}")
    scale = _scale(q, scale)
    kernel = kernel_route(q, use_kernel)
    if not takes_head_dim(d):
        if kernel:
            launch_counts["flash_varlen_xla"] += 1
        return varlen_xla(q, k, v, seg_q, seg_k, scale, bool(causal))
    if kernel:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    return _FlashVarlenFn.apply(q, k, v, seg_q.contiguous(),
                                seg_k.contiguous(), scale, bool(causal),
                                kernel)


# ≙ the JAX tensor-level entry point: the port holds tensors directly
flash_attention_varlen = flash_attention_varlen_values
