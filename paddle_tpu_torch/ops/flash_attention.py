"""Flash attention: hand-written CUDA kernels beside their plain version.

≙ `paddle_tpu/ops/flash_attention.py` :98-121 (`_causal_mask`,
`_tile_live`), :127-217 (`_fwd_kernel`, `_flash_fwd`), :223-388
(`_bwd_dq_kernel`, `_bwd_dkv_kernel`, `_flash_bwd`), :394-416 (the
`_flash` custom VJP), :419-435 (`_attention_xla`) and :438-471
(`flash_attention_values`).

Layout (B, S, H, D) at the public function, GQA native: K and V keep
their HK heads and query head h reads KV head h // (H / HK). The causal
mask is end-aligned: q row i sees keys j <= i + Sk - Sq; a window w
narrows it to j > i + Sk - Sq - w and needs causal. A q row that sees no
key outputs 0, with lse -1e30 and zero gradient. The scale defaults to
1/sqrt(D).

The kernels read the (B, S, H, D) tensors in place and write o, the
(B, H, Sq) f32 row log-sum-exp, dQ, dK and dV: no transposes and no
repeated K/V. `_FlashAttentionFn` is the custom VJP: its forward saves
(q, k, v, o, lse), its backward runs the dQ and dK/dV kernels on
delta = rowsum(o * dO) in f32. The backward has two designs
(`sm90_design`): bf16 and f16 at head dims 64 and 128 run the wgmma /
TMA kernels of `csrc/flash_bwd_sm90.cu`, whose dQ kernel computes delta
for its rows and hands it to the dK/dV kernel; every other input runs
the mma.sync kernels of `csrc/flash_attention.cu` on delta from PyTorch
(`_delta`, outside the kernels, as JAX does). The forward likewise, by
the same predicate: bf16 and f16 at head dims 64 and 128 run the wgmma /
TMA kernel of `csrc/flash_fwd_sm90.cu`, every other input the mma.sync
one of `csrc/flash_attention.cu`. On the CPU the same function runs the
plain versions (`flash_attention_ref`, `flash_attention_bwd_ref`), which
keep the JAX kernels' precisions so that they match the interpret-mode
kernels: QK^T in f32 and P cast to v's dtype for P.V; dP = dO.V^T in
f32 and dS cast to k's dtype for dS.K; P, dO, dS and q in f32 for dK
and dV. Every sequence length and every head dim up to `MAX_HEAD_DIM`
goes through the kernels. Past it, as the reference's `_aligned` test
on d sends it to `_attention_xla`, attention runs `attention_xla`, plain
PyTorch on either device (`takes_head_dim`); the reference's other
tiling fallbacks (sequence lengths off its blocks) have no counterpart.
A CUDA input the kernels cannot take raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import kernel_errors, kernel_route, launch_counts  # noqa: F401

NEG_INF = -1e30
# `csrc/flash_kernels.cuh` runs any head dim up to this one (the
# reference's `_aligned` limit) at the smallest of its tile widths that
# holds it, the columns past D zero
MAX_HEAD_DIM = 256
# the head dims of the wgmma forward and backward
# (`csrc/flash_fwd_sm90.cu`, `csrc/flash_bwd_sm90.cu`)
SM90_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DIMS = [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]
# pdt_flash_fwd(q, k, v, o, lse, B, Sq, Sk, H, HK, D, scale, causal,
#               window, dtype, stream); pdt_flash_fwd_sm90 alike
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + _DIMS
# pdt_flash_bwd_dq(q, k, v, dO, lse, delta, dq, ...)
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + _DIMS
# pdt_flash_bwd_dq_sm90(q, k, v, dO, lse, delta, o, dq, ...): o null reads
# delta, else computes and writes it
_DQ_SM90_ARGTYPES = [ctypes.c_void_p] * 8 + _DIMS
# pdt_flash_bwd_dkv(q, k, v, dO, lse, delta, dk, dv, ...)
_DKV_ARGTYPES = [ctypes.c_void_p] * 8 + _DIMS
# pdt_flash_bwd_dkv_sm90(q, k, v, dO, lse, delta, dk, dv, ws, splits, ...)
_DKV_SM90_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] + _DIMS
# keys a block of the wgmma dK/dV kernel owns
SM90_DKV_KEYS = 128


def takes_head_dim(d: int) -> bool:
    """Whether head dim ``d`` goes through the flash kernels (the plain
    versions on the CPU): the reference's `_aligned` test on d. Past it,
    `attention_xla`."""
    return d <= MAX_HEAD_DIM


def sm90_design(dtype, d: int) -> str:
    """Which flash kernels take (dtype, head dim) on the card, forward
    and backward alike: ``"wgmma"`` (`csrc/flash_fwd_sm90.cu`,
    `csrc/flash_bwd_sm90.cu`) for bf16 and f16 at the head dims in
    `SM90_DIMS`, else ``"mma.sync"`` (`csrc/flash_attention.cu`, which
    takes every input)."""
    if dtype in (torch.bfloat16, torch.float16) and d in SM90_DIMS:
        return "wgmma"
    return "mma.sync"


def dkv_splits(b: int, sk: int, hk: int, g: int, n_sm: int) -> int:
    """How many blocks of the wgmma dK/dV kernel share one KV head's G
    query heads: 1 (a block walks all G, no workspace) while the blocks
    fill every SM; with fewer blocks than SMs (a causal walk then ends
    on its longest block), enough for two blocks an SM, at most G. The
    split blocks write f32 partial sums that a second kernel adds in
    split order, so the result stays deterministic. On the H100, at
    G 7 and S 4096 (128 blocks) three splits cut dK/dV from 0.83 to 0.51
    ms (`tools/flash_bwd_timeline.py`, `PERF.md` §6); at the 8B slice
    (256 blocks) a split costs time."""
    blocks = -(-sk // SM90_DKV_KEYS) * b * hk
    if g == 1 or blocks >= n_sm:
        return 1
    return min(g, -(-2 * n_sm // blocks))


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


def attention_xla(q, k, v, scale, causal=False, window=None):
    """≙ `_attention_xla`, the reference's non-Pallas attention (its
    `_sdpa_xla`): the logits are q.k^T in the inputs' dtype cast to f32,
    times ``scale``, end-aligned causal or the window's band masked at
    NEG_INF, a softmax in f32 whose weights are cast to q's dtype for the
    weighted sum. Plain PyTorch, differentiable by autograd, on either
    device."""
    qh, kh, vh = _heads_first(q, k, v)
    s = torch.matmul(qh, kh.transpose(-1, -2)).float() * scale
    if causal:
        s = s.masked_fill(~_live(q.shape[1], k.shape[1], True, window,
                                 q.device), NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, vh).transpose(1, 2)


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
    if not takes_head_dim(d):
        raise ValueError(f"flash attention kernels take head dims up to "
                         f"{MAX_HEAD_DIM}; got {d}")
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


def _launch(symbol, argtypes, ptrs, dims, device, count,
            source="flash_attention"):
    from ._build import kernel_fn
    fn = kernel_fn(source, symbol, argtypes)
    with torch.cuda.device(device):
        err = fn(*ptrs, *dims)
    if err:
        raise RuntimeError(f"flash attention kernel {symbol} launch failed: "
                           f"CUDA error {err}")
    launch_counts[count] += 1


def _flash_fwd(q, k, v, scale, causal, window, _design=None):
    """The forward kernel on contiguous (B, S, H, D) tensors: (o, lse).
    The design of `sm90_design`, unless ``_design`` names one (private: it
    lets a caller run the other design at the same shape). An input the
    named design cannot take raises ValueError before any launch."""
    d = q.shape[-1]
    design = _design or sm90_design(q.dtype, d)
    if design not in ("wgmma", "mma.sync"):
        raise ValueError(f"no flash forward design {design!r}")
    if design == "wgmma" and sm90_design(q.dtype, d) != "wgmma":
        raise ValueError(f"the wgmma flash forward takes bfloat16 and "
                         f"float16 at head dims {SM90_DIMS}; got "
                         f"{q.dtype}, head dim {d}")
    _check(q, k, v)
    b, sq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    source, symbol = (("flash_fwd_sm90", "pdt_flash_fwd_sm90")
                      if design == "wgmma"
                      else ("flash_attention", "pdt_flash_fwd"))
    _launch(symbol, _FWD_ARGTYPES,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr()),
            _dims(q, k, scale, causal, window), q.device,
            "flash_attention_fwd", source)
    return o, lse


def _delta(o, do):
    """rowsum(o * dO) in f32, (B, H, Sq) (≙ `_flash_bwd`'s delta)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_entry(name, q, design):
    """(library, C entry) of backward kernel ``name`` ("dq" or "dkv"):
    the design of `sm90_design`, unless ``design`` names one (the private
    argument of the launchers, which lets a caller run the other design
    at the same shape)."""
    design = design or sm90_design(q.dtype, q.shape[-1])
    if design == "wgmma":
        return "flash_bwd_sm90", f"pdt_flash_bwd_{name}_sm90"
    if design == "mma.sync":
        return "flash_attention", f"pdt_flash_bwd_{name}"
    raise ValueError(f"no flash backward design {design!r}")


def _flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, window,
                  _design=None, o=None):
    """The dQ kernel: dq in q's dtype. Given the forward's ``o`` (the
    wgmma design only), the kernel computes delta = rowsum(o * dO) into
    ``delta`` instead of reading it."""
    _check(q, k, v)
    source, symbol = _bwd_entry("dq", q, _design)
    dq = torch.empty_like(q)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr()]
    argtypes = _DQ_ARGTYPES
    if source == "flash_bwd_sm90":
        ptrs.insert(6, None if o is None else o.data_ptr())
        argtypes = _DQ_SM90_ARGTYPES
    elif o is not None:
        raise ValueError("the mma.sync dQ kernel reads delta; it does not "
                         "compute it from o")
    _launch(symbol, argtypes, ptrs, _dims(q, k, scale, causal, window),
            q.device, "flash_attention_bwd_dq", source)
    return dq


def _flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, window,
                   _design=None):
    """The dK/dV kernel: (dk, dv), each summed over the query heads of
    its KV head."""
    _check(q, k, v)
    source, symbol = _bwd_entry("dkv", q, _design)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()]
    argtypes = _DKV_ARGTYPES
    if source == "flash_bwd_sm90":
        b, sk, hk, _ = k.shape
        props = torch.cuda.get_device_properties(q.device)
        splits = dkv_splits(b, sk, hk, q.shape[2] // hk,
                            props.multi_processor_count)
        ws = None if splits == 1 else torch.empty(
            2 * splits * k.numel(), dtype=torch.float32, device=q.device)
        ptrs += [None if ws is None else ws.data_ptr(), splits]
        argtypes = _DKV_SM90_ARGTYPES
    _launch(symbol, argtypes, ptrs, _dims(q, k, scale, causal, window),
            q.device, "flash_attention_bwd_dkv", source)
    return dk, dv


def _flash_bwd(q, k, v, o, lse, do, scale, causal, window, _design=None):
    """The dQ kernel, then the dK/dV kernel, on delta = rowsum(o * dO) in
    f32: computed by the wgmma dQ kernel, or by `_delta` for the mma.sync
    design."""
    design = _design or sm90_design(q.dtype, q.shape[-1])
    if design == "wgmma":
        b, sq, h, _ = q.shape
        delta = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
        dq = _flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, window,
                           design, o=o)
    else:
        delta = _delta(o, do)
        dq = _flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, window,
                           design)
    return (dq, *_flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal,
                                window, design))


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
    tensor goes through the kernels, forward and backward; a CPU tensor,
    or ``use_kernel=False``, through the plain versions. A head dim past
    `MAX_HEAD_DIM` takes `attention_xla` on either device, as the
    reference takes `_attention_xla`."""
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
    if not takes_head_dim(d):
        if kernel:
            launch_counts["flash_attention_xla"] += 1
        return attention_xla(q, k, v, scale, bool(causal), window_size)
    if kernel:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    return _FlashAttentionFn.apply(q, k, v, scale, bool(causal), window_size,
                                   kernel)
