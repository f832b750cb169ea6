"""Flash attention: hand-written CUDA kernels beside their plain version.

≙ `paddle_tpu/ops/flash_attention.py` :98-121 (`_causal_mask`,
`_tile_live`), :127-217 (`_fwd_kernel`, `_flash_fwd`), :223-388
(`_bwd_dq_kernel`, `_bwd_dkv_kernel`, `_flash_bwd`), :394-416 (the
`_flash` custom VJP) and :438-471 (`flash_attention_values`).

Layout (B, S, H, D) at the public function, GQA native: K and V keep
their HK heads and query head h reads KV head h // (H / HK). The causal
mask is end-aligned: q row i sees keys j <= i + Sk - Sq; a window w
narrows it to j > i + Sk - Sq - w and needs causal. A q row that sees no
key outputs 0, with lse -1e30 and zero gradient. The scale defaults to
1/sqrt(D).

The kernels (`csrc/flash_attention.cu`) read the (B, S, H, D) tensors in
place and write o, the (B, H, Sq) f32 row log-sum-exp, dQ, dK and dV:
no transposes and no repeated K/V. `_FlashAttentionFn` is the custom
VJP: its forward saves (q, k, v, o, lse), its backward computes
delta = rowsum(o * dO) in f32 (outside the kernels, as JAX does) and
runs the dQ and dK/dV kernels. On the CPU the same function runs the
plain versions (`flash_attention_ref`, `flash_attention_bwd_ref`), which
keep the JAX kernels' precisions so that they match the interpret-mode
kernels: QK^T in f32 and P cast to v's dtype for P.V; dP = dO.V^T in
f32 and dS cast to k's dtype for dS.K; P, dO, dS and q in f32 for dK
and dV. Every sequence length and every head dim up to `MAX_HEAD_DIM`
(the reference's `_aligned` limit; a multiple of 8 in bf16 and f16) goes
through the kernels; the TPU's tiling fallback to `_attention_xla` has no
counterpart. A CUDA input the kernels cannot take raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import kernel_errors, kernel_route, launch_counts  # noqa: F401

NEG_INF = -1e30
# `csrc/flash_kernels.cuh` runs any head dim up to this one at the
# smallest of its tile widths that holds it, the columns past D zero
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DIMS = [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]
# pdt_flash_fwd(q, k, v, o, lse, B, Sq, Sk, H, HK, D, scale, causal,
#               window, dtype, stream)
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + _DIMS
# pdt_flash_bwd_dq(q, k, v, dO, lse, delta, dq, ...)
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + _DIMS
# pdt_flash_bwd_dkv(q, k, v, dO, lse, delta, dk, dv, ...)
_DKV_ARGTYPES = [ctypes.c_void_p] * 8 + _DIMS


def _live(sq, sk, causal, window, device) -> torch.Tensor:
    """(sq, sk) bool: may q row i attend key j (≙ `_causal_mask`)."""
    i = torch.arange(sq, device=device)[:, None] + (sk - sq)
    j = torch.arange(sk, device=device)[None, :]
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool, device=device)
    live = j <= i
    if window is not None:
        live &= j > i - window
    return live


def _heads_first(q, k, v):
    """(B, S, H, D) → (B, H, S, D), with K and V repeated to H heads."""
    g = q.shape[2] // k.shape[2]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if g != 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    return q, k, v


def _scores(qh, kh, scale, live):
    """f32 logits (B, H, Sq, Sk) with masked entries at NEG_INF."""
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    return s.masked_fill(~live, NEG_INF)


def attend_ref(q, k, v, live, scale):
    """The plain forward under a given mask ``live`` (broadcastable to
    (B, H, Sq, Sk)): ``(o, lse)`` as `flash_attention_ref`."""
    qh, kh, vh = _heads_first(q, k, v)
    s = _scores(qh, kh, scale, live)
    m = s.amax(-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), vh.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype).transpose(1, 2), lse


def flash_attention_ref(q, k, v, causal=False, scale=None,
                        window_size=None):
    """Plain PyTorch forward: ``(o (B, Sq, H, D) in q's dtype, lse (B, H,
    Sq) f32)``. Scores in f32, softmax weights cast to v's dtype for the
    weighted sum (f32 accumulation), rows with no live key 0 and lse
    -1e30, as the JAX `_fwd_kernel`."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    live = _live(q.shape[1], k.shape[1], causal, window_size, q.device)
    return attend_ref(q, k, v, live, scale)


def attend_bwd_ref(q, k, v, o, lse, do, live, scale):
    """The plain backward under a given mask ``live``: ``(dq, dk, dv)``
    as `flash_attention_bwd_ref`."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    qh, kh, vh = _heads_first(q, k, v)
    doh = do.transpose(1, 2).float()
    s = _scores(qh, kh, scale, live)
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2)[..., None]
    dp = torch.matmul(doh, vh.float().transpose(-1, -2))
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds.to(k.dtype).float(), kh.float())
    dv = torch.matmul(p.transpose(-1, -2), doh)
    dk = torch.matmul(ds.transpose(-1, -2), qh.float())

    def per_kv_head(t):
        return t.reshape(b, hk, h // hk, *t.shape[2:]).sum(2)
    return (dq.to(q.dtype).transpose(1, 2),
            per_kv_head(dk).to(k.dtype).transpose(1, 2),
            per_kv_head(dv).to(v.dtype).transpose(1, 2))


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal=False, scale=None,
                            window_size=None):
    """Plain PyTorch backward from the saved lse: ``(dq, dk, dv)`` in the
    inputs' dtypes, dk and dv summed over the H / HK query heads of each
    KV head. Precisions of `_bwd_dq_kernel` / `_bwd_dkv_kernel`."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    live = _live(q.shape[1], k.shape[1], causal, window_size, q.device)
    return attend_bwd_ref(q, k, v, o, lse, do, live, scale)


# limits on `kernel_errors` for the kernels against the plain versions.
# bf16: both round P (and dS for dQ) to bf16, the kernel at each tile's
# running max and the plain version at the row max, and the outputs once
# more; f32: the same math summed in another order. On the H100 the
# kernels read at most 2.2e-3 / 5.9e-3 (bf16) and 7.4e-7 / 1.3e-4 (f32,
# a dQ row that cancels), a skipped K tile or a wrong GQA head at least
# 0.196 / 0.76 (chip_smoke.py's flash phase, PERF.md). f16 rounds at the
# same places with 11 significant bits for bf16's 8, so bf16's limits
# hold it with room to spare.
KERNEL_LIMITS = {torch.bfloat16: dict(rel=8e-3, row=3e-2),
                 torch.float16: dict(rel=8e-3, row=3e-2),
                 torch.float32: dict(rel=1e-5, row=1e-3)}


def _check(q, k, v):
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention kernels take float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    if not (k.dtype == v.dtype == q.dtype):
        raise ValueError("flash attention kernels want q, k and v of one "
                         "dtype")
    d = q.shape[-1]
    if d > MAX_HEAD_DIM or (q.dtype != torch.float32 and d % 8):
        raise ValueError(f"flash attention kernels take head dims up to "
                         f"{MAX_HEAD_DIM}, multiples of 8 in bfloat16 and "
                         f"float16; got {d} in {q.dtype}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash attention kernels want q, k and v on one "
                         "CUDA device")


def _aligned(t):
    """``t`` contiguous and 16-byte aligned, as the kernels' vector loads
    want (a copy only when it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _dims(q, k, scale, causal, window):
    b, sq, h, d = q.shape
    return (b, sq, k.shape[1], h, k.shape[2], d, float(scale), int(causal),
            0 if window is None else int(window),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)


def _launch(symbol, argtypes, ptrs, dims, device, count):
    from ._build import kernel_fn
    fn = kernel_fn("flash_attention", symbol, argtypes)
    with torch.cuda.device(device):
        err = fn(*ptrs, *dims)
    if err:
        raise RuntimeError(f"flash attention kernel {symbol} launch failed: "
                           f"CUDA error {err}")
    launch_counts[count] += 1


def _flash_fwd(q, k, v, scale, causal, window):
    """The forward kernel on contiguous (B, S, H, D) tensors: (o, lse)."""
    _check(q, k, v)
    b, sq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    _launch("pdt_flash_fwd", _FWD_ARGTYPES,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr()),
            _dims(q, k, scale, causal, window), q.device,
            "flash_attention_fwd")
    return o, lse


def _delta(o, do):
    """rowsum(o * dO) in f32, (B, H, Sq) (≙ `_flash_bwd`'s delta)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, window):
    """The dQ kernel: dq in q's dtype."""
    _check(q, k, v)
    dq = torch.empty_like(q)
    _launch("pdt_flash_bwd_dq", _DQ_ARGTYPES,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            _dims(q, k, scale, causal, window), q.device,
            "flash_attention_bwd_dq")
    return dq


def _flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, window):
    """The dK/dV kernel: (dk, dv), each summed over the query heads of
    its KV head."""
    _check(q, k, v)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("pdt_flash_bwd_dkv", _DKV_ARGTYPES,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            _dims(q, k, scale, causal, window), q.device,
            "flash_attention_bwd_dkv")
    return dk, dv


def _flash_bwd(q, k, v, o, lse, do, scale, causal, window):
    """delta = rowsum(o * dO) in f32, then the dQ and dK/dV kernels."""
    delta = _delta(o, do)
    dq = _flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, window)
    return (dq, *_flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal,
                                window))


class _FlashAttentionFn(torch.autograd.Function):
    """≙ the `_flash` custom VJP: forward saves (q, k, v, o, lse); the
    backward recomputes P from lse. ``kernel`` picks the CUDA kernels or
    the plain versions for both directions."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, kernel):
        if kernel:
            o, lse = _flash_fwd(q, k, v, scale, causal, window)
        else:
            o, lse = flash_attention_ref(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, causal, window, kernel)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale, causal, window, kernel = ctx.args
        if kernel:
            dq, dk, dv = _flash_bwd(q, k, v, o, lse, _aligned(do), scale,
                                    causal, window)
        else:
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                 causal, scale, window)
        return dq, dk, dv, None, None, None, None


def flash_attention_values(q, k, v, causal=False, scale=None,
                           window_size=None, use_kernel=None):
    """Attention of (B, Sq, H, D) queries over (B, Sk, HK, D) keys and
    values (H a multiple of HK), differentiable in q, k and v. A CUDA
    tensor goes through the kernels, forward and backward (a head dim
    they cannot take raises); a CPU tensor, or ``use_kernel=False``,
    through the plain versions."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, Sq, H, D) and k, v (B, Sk, HK, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of HK)")
    if window_size is not None:
        if not causal:
            raise ValueError("window_size requires causal=True "
                             "(sliding-window attention is causal)")
        window_size = int(window_size)
        if window_size <= 0:
            raise ValueError(f"window_size must be > 0, got {window_size}")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    kernel = kernel_route(q, use_kernel)
    if kernel:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    return _FlashAttentionFn.apply(q, k, v, scale, bool(causal), window_size,
                                   kernel)
