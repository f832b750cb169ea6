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

The kernels read the (B, S, H, D) tensors in place and visit only the
(q tile, key tile) pairs where some pair can be live. They come in two
designs (`varlen_design`): bf16 and f16 at head dims 64 and 128 run the
wgmma / TMA kernels of `csrc/flash_varlen_sm90.cu` ("sm90"), which walk
a segment tile plan computed on the device by a pre-pass kernel
(`_varlen_plan`; its plain version `varlen_tile_plan`); every other
input runs the mma.sync kernels of `csrc/flash_varlen.cu` (the flash
kernels of `csrc/flash_kernels.cuh` with the segment mask on).
`_FlashVarlenFn` is the custom VJP: its forward computes the plan (sm90)
and saves (q, k, v, o, lse) beside the segment ids, which get no
gradient, and the plan; its backward runs the dQ and dK/dV kernels on
the same plan, on delta = rowsum(o * dO) in f32: formed by the sm90 dQ
kernel for its rows (as the dense wgmma dQ kernel), or by `_delta`
outside the kernels for the mma.sync design, as JAX does. On the CPU
the same function runs the plain versions, which keep the Pallas
kernels' precisions (`ops.flash_attention.attend_ref` /
`attend_bwd_ref` under the segment mask). There is no counterpart of
the TPU's unaligned fallback (``sq % block_q``, ``sk % block_k``): the
kernels take any length and mask the tails, and head dims as the dense
kernels (`MAX_HEAD_DIM`). A head dim past it takes `varlen_xla` on
either device, as the reference's ``d <= 256`` test sends it to
`_varlen_xla`.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import kernel_route, launch_counts
from .flash_attention import (_DTYPES, NEG_INF, SM90_DIMS, _aligned, _check,
                              _delta, _heads_first, attend_bwd_ref,
                              attend_ref, dkv_splits, takes_head_dim)

_DIMS = [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 2 \
    + [ctypes.c_void_p]
# pdt_varlen_fwd(q, k, v, seg_q, seg_k, o, lse, B, Sq, Sk, H, HK, D, scale,
#                causal, dtype, stream)
_FWD_ARGTYPES = [ctypes.c_void_p] * 7 + _DIMS
# pdt_varlen_bwd_dq(q, k, v, dO, lse, delta, seg_q, seg_k, dq, ...)
_DQ_ARGTYPES = [ctypes.c_void_p] * 9 + _DIMS
# pdt_varlen_bwd_dkv(q, k, v, dO, lse, delta, seg_q, seg_k, dk, dv, ...)
_DKV_ARGTYPES = [ctypes.c_void_p] * 10 + _DIMS
# pdt_varlen_plan(seg_q, seg_k, plan, B, Sq, Sk, causal, stream)
_PLAN_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
# pdt_varlen_fwd_sm90(q, k, v, seg_q, seg_k, plan, o, lse, order, ...)
_FWD_SM90_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] + _DIMS
# pdt_varlen_bwd_dq_sm90(q, k, v, dO, lse, delta, o, seg_q, seg_k, plan,
#                        dq, order, ...): o null reads delta, else computes
#                        and writes it
_DQ_SM90_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] + _DIMS
# pdt_varlen_bwd_dkv_sm90(q, k, v, dO, lse, delta, seg_q, seg_k, plan, dk,
#                         dv, ws, splits, order, ...)
_DKV_SM90_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2 + _DIMS

# the segment tile plan (`csrc/flash_varlen_sm90.cu`): ranges of ids over
# tiles of PLAN_TILE rows; the sm90 kernels' blocks own PLAN_BLOCK q rows
# (forward, dQ) or keys (dK/dV), two tiles
PLAN_TILE = 64
PLAN_BLOCK = 2 * PLAN_TILE
EMPTY_LO = 2 ** 31 - 1   # lo of a tile that holds no id (its hi is -1)


def varlen_design(dtype, d: int) -> str:
    """Which varlen kernels take (dtype, head dim) on the card, forward
    and backward alike: ``"sm90"`` (`csrc/flash_varlen_sm90.cu`, wgmma +
    TMA over the segment tile plan) for bf16 and f16 at the head dims in
    `ops.flash_attention.SM90_DIMS`, else ``"mma.sync"``
    (`csrc/flash_varlen.cu`, which takes every input up to
    `MAX_HEAD_DIM`)."""
    if dtype in (torch.bfloat16, torch.float16) and d in SM90_DIMS:
        return "sm90"
    return "mma.sync"


def _plan_layout(b: int, sq: int, sk: int) -> dict:
    """Word offsets of the device plan (``PlanLayout`` of
    `csrc/flash_varlen_sm90.cu`): tile [lo, hi] pairs of q (``qt``) and
    keys (``kt``), block [first, last] pairs (``qb``, ``kb``), uniform
    flags (``qu``, ``ku``), block counts (``qn``, ``kn``), launch orders
    (``qo``, ``ko``), sorted flags and non-empty tile counts (q, k per
    row), and the total ``words``."""
    nqt, nkt = -(-sq // PLAN_TILE), -(-sk // PLAN_TILE)
    nqb, nkb = -(-sq // PLAN_BLOCK), -(-sk // PLAN_BLOCK)
    sizes = [("qt", 2 * b * nqt), ("kt", 2 * b * nkt), ("qb", 2 * b * nqb),
             ("kb", 2 * b * nkb), ("qu", b * nqt), ("ku", b * nkt),
             ("qn", b * nqb), ("kn", b * nkb), ("qo", b * nqb),
             ("ko", b * nkb), ("sorted", 2 * b), ("ne", 2 * b)]
    out, at = dict(nqt=nqt, nkt=nkt, nqb=nqb, nkb=nkb), 0
    for name, n in sizes:
        out[name] = at
        at += n
    out["words"] = at
    return out


def _tile_ids(seg, tile):
    """Per tile of ``tile`` positions (past the end: padding): [lo, hi] of
    its non-negative ids (EMPTY_LO, -1 without any) and whether it is
    uniform (one id, no padding, no tail); (B, n) each."""
    b, s = seg.shape
    n = -(-s // tile)
    t = torch.cat([seg, seg.new_full((b, n * tile - s), -1)], 1)
    t = t.reshape(b, n, tile)
    ok = t >= 0
    lo = torch.where(ok, t, EMPTY_LO).amin(-1)
    hi = torch.where(ok, t, -1).amax(-1)
    return lo, hi, ok.all(-1) & (lo == hi)


def _blocks(lo, hi, per):
    """[lo, hi] of blocks of ``per`` tiles: min of lo, max of hi."""
    b, n = lo.shape
    pad = -n % per
    lo = torch.cat([lo, lo.new_full((b, pad), EMPTY_LO)], 1)
    hi = torch.cat([hi, hi.new_full((b, pad), -1)], 1)
    return (lo.reshape(b, -1, per).amin(-1), hi.reshape(b, -1, per).amax(-1))


def _walk(meet):
    """(first, last, count) of each row of a (..., n) bool: the first and
    last True and their count; (0, -1, 0) for a row without one."""
    n = meet.shape[-1]
    idx = torch.arange(n, device=meet.device)
    count = meet.sum(-1)
    first = torch.where(meet, idx, n).amin(-1)
    last = torch.where(meet, idx, -1).amax(-1)
    none = count == 0
    return (torch.where(none, 0, first), torch.where(none, -1, last), count)


def varlen_tile_plan(seg_q, seg_k, causal=False, block_q=PLAN_TILE,
                     block_k=PLAN_TILE) -> dict:
    """The plain version of the segment tile plan that the sm90 kernels
    walk (`_varlen_plan` computes it on the card), over tiles of
    ``block_q`` q rows and ``block_k`` keys (the kernels': 64 each):

    - ``q_lo``, ``q_hi`` (B, nqt) and ``k_lo``, ``k_hi`` (B, nkt): the
      smallest and largest non-negative id of each tile (EMPTY_LO and -1
      for a tile without one); ``q_uniform``, ``k_uniform``: the tile is
      one segment with no padding and no tail (needs no segment mask);
    - ``sorted`` (B, 2): whether seg_q / seg_k of a row are non-decreasing
      over a prefix with negative ids only as its tail; ``nonempty`` (B,
      2): tiles holding an id (under sorted ids, a prefix);
    - ``visit`` (B, nqt, nkt): the key tiles each q tile visits, those
      whose id range meets its own and that lie in the causal band (global
      end-aligned order); no live pair lies outside them;
    - ``q_walk`` (B, nqb, 2), ``q_count`` (B, nqb): the key tiles [first,
      last] a block of two q tiles walks (those meeting the block's id
      range, within its band) and how many meet; ``k_walk``, ``k_count``
      likewise for a block of two key tiles over the q tiles; (0, -1, 0)
      for a block that walks none. Under sorted ids every tile of
      [first, last] meets;
    - ``q_order`` (B * nqb,), ``k_order`` (B * nkb,): the blocks (b * n +
      block) in launch order, the largest count first, ties in index
      order."""
    sq, sk = seg_q.shape[1], seg_k.shape[1]
    off = sk - sq
    q_lo, q_hi, q_uni = _tile_ids(seg_q, block_q)
    k_lo, k_hi, k_uni = _tile_ids(seg_k, block_k)
    nqt, nkt = q_lo.shape[1], k_lo.shape[1]
    dev = seg_q.device

    def is_sorted(seg):
        x, y = seg[:, :-1], seg[:, 1:]
        return torch.where(x < 0, y < 0, (y < 0) | (x <= y)).all(1)

    def nonempty(hi):
        n = hi.shape[1]
        return torch.where(hi >= 0, torch.arange(1, n + 1, device=dev),
                           0).amax(1)

    def meets(alo, ahi, blo, bhi):
        return (alo[..., :, None] <= bhi[..., None, :]) & \
            (blo[..., None, :] <= ahi[..., :, None])

    kt0 = torch.arange(nkt, device=dev) * block_k
    qt0 = torch.arange(nqt, device=dev) * block_q
    # q tiles: the keys of the band end at its last row + Sk - Sq
    q_last = torch.clamp(qt0 + block_q, max=sq) - 1
    band = (kt0[None, :] <= q_last[:, None] + off) if causal else \
        torch.ones(nqt, nkt, dtype=torch.bool, device=dev)
    visit = meets(q_lo, q_hi, k_lo, k_hi) & band
    # blocks of two tiles
    qb_lo, qb_hi = _blocks(q_lo, q_hi, 2)
    kb_lo, kb_hi = _blocks(k_lo, k_hi, 2)
    nqb, nkb = qb_lo.shape[1], kb_lo.shape[1]
    if causal:
        rows_last = torch.clamp(
            torch.arange(1, nqb + 1, device=dev) * 2 * block_q, max=sq) - 1
        qband = kt0[None, :] <= rows_last[:, None] + off
        # key blocks: the q rows of the band start at its first key -
        # (Sk - Sq)
        qmin = torch.clamp(torch.arange(nkb, device=dev) * 2 * block_k
                           - off, min=0)
        kband = torch.arange(nqt, device=dev)[None, :] >= \
            (qmin // block_q)[:, None]
    else:
        qband = torch.ones(nqb, nkt, dtype=torch.bool, device=dev)
        kband = torch.ones(nkb, nqt, dtype=torch.bool, device=dev)
    qf, ql, qn = _walk(meets(qb_lo, qb_hi, k_lo, k_hi) & qband)
    kf, kl, kn = _walk(meets(kb_lo, kb_hi, q_lo, q_hi) & kband)
    i32 = torch.int32
    return dict(
        q_lo=q_lo.to(i32), q_hi=q_hi.to(i32), q_uniform=q_uni,
        k_lo=k_lo.to(i32), k_hi=k_hi.to(i32), k_uniform=k_uni,
        sorted=torch.stack([is_sorted(seg_q), is_sorted(seg_k)], 1),
        nonempty=torch.stack([nonempty(q_hi), nonempty(k_hi)], 1).to(i32),
        visit=visit,
        q_walk=torch.stack([qf, ql], -1).to(i32), q_count=qn.to(i32),
        k_walk=torch.stack([kf, kl], -1).to(i32), k_count=kn.to(i32),
        q_order=torch.sort(-qn.flatten(), stable=True).indices.to(i32),
        k_order=torch.sort(-kn.flatten(), stable=True).indices.to(i32))


def unpack_plan(words, b: int, sq: int, sk: int) -> dict:
    """The device plan (``words``, int32) as the dict of
    `varlen_tile_plan`, without ``visit``."""
    lay = _plan_layout(b, sq, sk)
    nqt, nkt, nqb, nkb = (lay[k] for k in ("nqt", "nkt", "nqb", "nkb"))

    def part(name, n, *shape):
        return words[lay[name]:lay[name] + n].reshape(*shape)
    qt, kt = part("qt", 2 * b * nqt, b, nqt, 2), part("kt", 2 * b * nkt, b,
                                                       nkt, 2)
    return dict(
        q_lo=qt[..., 0], q_hi=qt[..., 1],
        q_uniform=part("qu", b * nqt, b, nqt) != 0,
        k_lo=kt[..., 0], k_hi=kt[..., 1],
        k_uniform=part("ku", b * nkt, b, nkt) != 0,
        sorted=part("sorted", 2 * b, b, 2) != 0,
        nonempty=part("ne", 2 * b, b, 2),
        q_walk=part("qb", 2 * b * nqb, b, nqb, 2),
        q_count=part("qn", b * nqb, b, nqb),
        k_walk=part("kb", 2 * b * nkb, b, nkb, 2),
        k_count=part("kn", b * nkb, b, nkb),
        q_order=part("qo", b * nqb, b * nqb),
        k_order=part("ko", b * nkb, b * nkb))


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


def _launch(symbol, argtypes, ptrs, dims, device, count,
            source="flash_varlen"):
    from ._build import kernel_fn
    fn = kernel_fn(source, symbol, argtypes)
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


def _pick_design(q, design):
    """The design of `varlen_design`, unless ``design`` names one
    (private: it lets a caller run the other design at the same shape).
    An input the named design cannot take raises ValueError before any
    launch."""
    d = q.shape[-1]
    want = varlen_design(q.dtype, d)
    design = design or want
    if design not in ("sm90", "mma.sync"):
        raise ValueError(f"no varlen flash design {design!r}")
    if design == "sm90" and want != "sm90":
        raise ValueError(f"the sm90 varlen kernels take bfloat16 and "
                         f"float16 at head dims {SM90_DIMS}; got "
                         f"{q.dtype}, head dim {d}")
    return design


# The sm90 kernels' block launch order: "dense", the dense kernels' (q
# blocks from the last, every batch row of a block together), for the
# forward and dQ; "plan", the plan's (the most walked tiles first), for
# dK/dV: each the faster of the two on the H100 at `packed_pretrain_8b`
# (`chip_smoke.py` times both; PERF.md §6). The launchers' private ``_order``
# names the other for timing.
SM90_ORDER = {"fwd": "dense", "dq": "dense", "dkv": "plan"}


def _order_flag(order):
    if order not in ("plan", "dense"):
        raise ValueError(f"no block order {order!r}")
    return int(order == "plan")


def _varlen_plan(seg_q, seg_k, causal):
    """The plan kernel: the segment tile plan of (B, Sq) / (B, Sk) int32
    ids as ``_plan_layout(...)["words"]`` int32 words on their device
    (`unpack_plan` reads it)."""
    b, sq = seg_q.shape
    sk = seg_k.shape[1]
    plan = torch.empty(_plan_layout(b, sq, sk)["words"], dtype=torch.int32,
                       device=seg_q.device)
    _launch("pdt_varlen_plan", _PLAN_ARGTYPES,
            (seg_q.data_ptr(), seg_k.data_ptr(), plan.data_ptr()),
            (b, sq, sk, int(causal),
             torch.cuda.current_stream(seg_q.device).cuda_stream),
            seg_q.device, "flash_varlen_plan", "flash_varlen_sm90")
    return plan


def _sm90_plan(design, plan, seg_q, seg_k, causal):
    """The plan an sm90 launch reads: ``plan``, else a new one."""
    if design != "sm90":
        if plan is not None:
            raise ValueError("the mma.sync varlen kernels take no plan")
        return None
    return _varlen_plan(seg_q, seg_k, causal) if plan is None else plan


def _varlen_fwd(q, k, v, seg_q, seg_k, scale, causal, _design=None,
                plan=None, _order=SM90_ORDER["fwd"]):
    """The forward kernel on contiguous tensors: (o, lse (B, H, Sq)).
    The sm90 design reads ``plan`` (`_varlen_plan` of the same ids and
    causal flag), computed here when none is given, and launches its
    blocks in ``_order`` (`SM90_ORDER`; private, for timing)."""
    _check(q, k, v)
    _check_seg(q, k, seg_q, seg_k)
    design = _pick_design(q, _design)
    plan = _sm90_plan(design, plan, seg_q, seg_k, causal)
    b, sq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(),
            seg_k.data_ptr(), o.data_ptr(), lse.data_ptr()]
    if design == "sm90":
        ptrs[5:5] = [plan.data_ptr()]
        _launch("pdt_varlen_fwd_sm90", _FWD_SM90_ARGTYPES,
                (*ptrs, _order_flag(_order)), _dims(q, k, scale, causal),
                q.device, "flash_varlen_fwd", "flash_varlen_sm90")
    else:
        _launch("pdt_varlen_fwd", _FWD_ARGTYPES, ptrs,
                _dims(q, k, scale, causal), q.device, "flash_varlen_fwd")
    return o, lse


def _varlen_bwd_dq(q, k, v, do, lse, delta, seg_q, seg_k, scale, causal,
                   _design=None, plan=None, _order=SM90_ORDER["dq"], o=None):
    """The dQ kernel: dq in q's dtype (plan and order as `_varlen_fwd`).
    Given the forward's ``o`` (the sm90 design only), the kernel computes
    delta = rowsum(o * dO) into ``delta`` instead of reading it, as the
    dense wgmma dQ kernel does."""
    _check(q, k, v)
    _check_seg(q, k, seg_q, seg_k)
    design = _pick_design(q, _design)
    plan = _sm90_plan(design, plan, seg_q, seg_k, causal)
    dq = torch.empty_like(q)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), seg_q.data_ptr(),
            seg_k.data_ptr(), dq.data_ptr()]
    if design == "sm90":
        ptrs[8:8] = [plan.data_ptr()]
        ptrs[6:6] = [None if o is None else o.data_ptr()]
        _launch("pdt_varlen_bwd_dq_sm90", _DQ_SM90_ARGTYPES,
                (*ptrs, _order_flag(_order)), _dims(q, k, scale, causal),
                q.device, "flash_varlen_bwd_dq", "flash_varlen_sm90")
    elif o is not None:
        raise ValueError("the mma.sync varlen dQ kernel reads delta; it "
                         "does not compute it from o")
    else:
        _launch("pdt_varlen_bwd_dq", _DQ_ARGTYPES, ptrs,
                _dims(q, k, scale, causal), q.device, "flash_varlen_bwd_dq")
    return dq


def _varlen_bwd_dkv(q, k, v, do, lse, delta, seg_q, seg_k, scale, causal,
                    _design=None, plan=None, _order=SM90_ORDER["dkv"]):
    """The dK/dV kernel: (dk, dv), each summed over the query heads of its
    KV head, deterministic (plan and order as `_varlen_fwd`; the sm90
    design splits a KV head's query heads over blocks as the dense wgmma
    kernel does, `ops.flash_attention.dkv_splits`)."""
    _check(q, k, v)
    _check_seg(q, k, seg_q, seg_k)
    design = _pick_design(q, _design)
    plan = _sm90_plan(design, plan, seg_q, seg_k, causal)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), seg_q.data_ptr(),
            seg_k.data_ptr(), dk.data_ptr(), dv.data_ptr()]
    if design == "sm90":
        b, sk, hk, _ = k.shape
        props = torch.cuda.get_device_properties(q.device)
        splits = dkv_splits(b, sk, hk, q.shape[2] // hk,
                            props.multi_processor_count)
        ws = None if splits == 1 else torch.empty(
            2 * splits * k.numel(), dtype=torch.float32, device=q.device)
        ptrs[8:8] = [plan.data_ptr()]
        ptrs += [None if ws is None else ws.data_ptr()]
        _launch("pdt_varlen_bwd_dkv_sm90", _DKV_SM90_ARGTYPES,
                (*ptrs, splits, _order_flag(_order)),
                _dims(q, k, scale, causal), q.device,
                "flash_varlen_bwd_dkv", "flash_varlen_sm90")
    else:
        _launch("pdt_varlen_bwd_dkv", _DKV_ARGTYPES, ptrs,
                _dims(q, k, scale, causal), q.device, "flash_varlen_bwd_dkv")
    return dk, dv


def _varlen_bwd(q, k, v, o, lse, do, seg_q, seg_k, scale, causal,
                _design=None, plan=None):
    """The dQ kernel, then the dK/dV kernel, on delta = rowsum(o * dO) in
    f32: formed by the sm90 dQ kernel, or by `_delta` for the mma.sync
    design (the sm90 kernels walk ``plan``, computed here once for both
    when none is given)."""
    design = _pick_design(q, _design)
    plan = _sm90_plan(design, plan, seg_q, seg_k, causal)
    if design == "sm90":
        b, sq, h, _ = q.shape
        delta = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
        dq = _varlen_bwd_dq(q, k, v, do, lse, delta, seg_q, seg_k, scale,
                            causal, design, plan, o=o)
    else:
        delta = _delta(o, do)
        dq = _varlen_bwd_dq(q, k, v, do, lse, delta, seg_q, seg_k, scale,
                            causal, design)
    return (dq, *_varlen_bwd_dkv(q, k, v, do, lse, delta, seg_q, seg_k,
                                 scale, causal, design, plan))


class _FlashVarlenFn(torch.autograd.Function):
    """≙ the `_varlen` custom VJP: forward saves (q, k, v, o, lse) and the
    segment ids (non-differentiable), and the sm90 design's plan, which
    the backward reuses; the backward recomputes P from lse. ``kernel``
    picks the CUDA kernels or the plain versions for both directions."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, scale, causal, kernel):
        plan = None
        if kernel:
            design = varlen_design(q.dtype, q.shape[-1])
            plan = _sm90_plan(design, None, seg_q, seg_k, causal)
            o, lse = _varlen_fwd(q, k, v, seg_q, seg_k, scale, causal,
                                 plan=plan)
        else:
            o, lse = flash_attention_varlen_ref(q, k, v, seg_q, seg_k,
                                                causal, scale)
        ctx.save_for_backward(q, k, v, o, lse, seg_q, seg_k)
        ctx.args = (scale, causal, kernel, plan)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg_q, seg_k = ctx.saved_tensors
        scale, causal, kernel, plan = ctx.args
        if kernel:
            dq, dk, dv = _varlen_bwd(q, k, v, o, lse, _aligned(do), seg_q,
                                     seg_k, scale, causal, plan=plan)
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
